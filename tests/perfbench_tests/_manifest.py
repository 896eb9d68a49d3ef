"""The checks that hold a checkout's BENCHMARK.json to the contract and to
its files, as functions of the checkout's root, so that the tests hold the
repository's manifest and a tree that adds a cell or a metric as new files
to the same rules.

Reader cases: each per-layer metric `m` has, beside its reader
perfbench/readers/<m>.py, a case tests/perfbench_tests/reader_cases/<m>.py
that holds `EXPECTED`, the reader's value on the shared synthetic context
below (None where it finds nothing there to read), and may define
`ctx(shared)`, its own context, for a reader that needs what the shared one
lacks (NCCL kernels, `mesh.*` spans, other counters).
"""

import importlib.util
import json
import math
import re
from pathlib import Path
from types import SimpleNamespace

import torch

from perfbench import harness, reference, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CASES = Path("tests") / "perfbench_tests" / "reader_cases"
CHIPS = (1, 4)


def bench(root) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


# ---- the shared synthetic context -------------------------------------------


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def events():
    """A groundstate slice of 100 us with two K1 launches, a dot2 and an
    add, and a row slice of 50 us with one add; an event outside both."""
    return [_x("user_annotation", "groundstate", 0, 100),
            _x("user_annotation", "row", 200, 50),
            _x("cpu_op", "aten::item", 60, 30),
            _x("kernel", "void kron_group_kernel<float, 64>(KgDesc)", 10, 20),
            _x("kernel", "void kron_group_kernel<float, 64>(KgDesc)", 30, 10),
            _x("kernel", "dot2_kernel(Dot2Desc)", 40, 5),
            _x("kernel", "void at::native::add_kernel", 50, 10),
            _x("kernel", "void at::native::add_kernel", 210, 20),
            _x("kernel", "late", 300, 5)]


def shared_ctx(applies=(20, 10)):
    """The harness's context after a traced window, made by hand: the
    slices of `events()` (20 and 10 applies), counters and probes."""
    an = trace.analyze(events(), ("groundstate", "row"))
    sl = {k: SimpleNamespace(applies=n)
          for k, n in zip(("groundstate", "row"), applies)}
    return SimpleNamespace(trace=an, slices=sl, counts={
        "applies.groundstate": 160.0, "applies.row": 101.0},
        probes={"apply_ms": 40.0, "apply_bound_ms": 1.435, "dot_ms": 2.0,
                "dot_bound_ms": 1.8})


def empty_ctx():
    """No trace, no slices, no counters, no probes."""
    return SimpleNamespace(trace=None, slices={}, counts={}, probes={})


# ---- reader cases -----------------------------------------------------------


def case_names(root) -> list:
    return sorted(p.name[:-3] for p in (Path(root) / CASES).glob("*.py"))


def load_case(root, name: str):
    path = Path(root) / CASES / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "reader_case_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def case_ctx(case):
    """The case's own context, or the shared one."""
    make = getattr(case, "ctx", None)
    return shared_ctx() if make is None else make(shared_ctx)


def check_case(root, name: str) -> None:
    """The reader of metric `name` on its case's context reads EXPECTED,
    and None on an empty one (never 0: a share not measured is left
    out)."""
    case = load_case(root, name)
    reader = harness.load(root, "readers", name)
    got = reader.read(case_ctx(case))
    if case.EXPECTED is None:
        assert got is None, (name, got)
    else:
        assert got is not None and math.isclose(
            got, case.EXPECTED, rel_tol=1e-6, abs_tol=1e-12), (
            name, got, case.EXPECTED)
    assert reader.read(empty_ctx()) is None, name


def check_readers(root) -> None:
    """Each per-layer metric of the manifest has its reader and its case;
    each case is a metric's with a reader."""
    root = Path(root)
    names = {m["name"] for m in bench(root)["per_layer"]}
    cases = set(case_names(root))
    assert names <= cases, sorted(names - cases)
    for n in names | cases:
        assert (root / "perfbench" / "readers" / f"{n}.py").is_file(), n


# ---- the manifest -----------------------------------------------------------


def check_shape(root) -> None:
    b = bench(root)
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for k, want in keys.items():
        for x in b[k]:
            assert set(x) == want, x
            assert 0 < len(x["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:  # each cell reports what the metric moves
            assert w in e2e[m["moves"]].get("workloads", [w])


def check_cell(root, w: str) -> None:
    """The cell's files are there, its chips are 1 or 4 (the four-chip
    cells at most a quarter of the cells, rounded down, and one always),
    and its configuration's reference energy is sound by its own chain
    (whose file `ground_energy` loads)."""
    b, wl, cfg, traffic = harness.cell(root, w)
    c = next(c for c in b["configs"] if c["name"] == wl["config"])
    assert c["file"].startswith("perfbench/configs/")
    assert cfg["name"] == c["name"] and len(cfg["source"]) <= 200
    assert set(c["reduced"]) <= set(cfg)  # top-level keys of the file
    assert wl["chips"] in CHIPS
    n4 = sum(x["chips"] == 4 for x in b["workloads"])
    assert n4 <= max(1, len(b["workloads"]) // 4), n4
    for sub, name in (("mixes", traffic["mix"]),
                      ("layouts", cfg["model"]["layout"])):
        assert (Path(root) / "perfbench" / sub / f"{name}.py").is_file()
    g, mo = cfg["guarantees"], cfg["model"]
    assert g["residual_target"] == cfg["groundstate"]["target_residual"]
    if mo["L"] <= 16:  # a cut tree: its chain's own ground state
        assert abs(g["E0_ref"] - ground_energy(root, mo)) < 1e-6
    elif mo["chain"] == "xxz" and mo["Jxy"] == mo["Jz"] == 1:
        assert abs(g["E0_ref"] / mo["L"] + 0.74) < 0.01
    else:  # any other chain or coupling: near its own E0 / L at L=16
        e16 = ground_energy(root, dict(mo, L=16, nup=8)) / 16
        assert abs(g["E0_ref"] / mo["L"] - e16) <= 0.02, (g["E0_ref"], e16)


def ground_energy(root, model: dict) -> float:
    """The reference ground-state energy of the configuration's chain
    (harness.chain) on the CPU: float64, residual 1e-10, seed 0."""
    H = harness.chain(root, model)("cpu")
    E0, _, _ = reference.ground_state(H, torch.Generator().manual_seed(0),
                                      tol=1e-10)
    return E0


def check_all(root) -> None:
    """Every manifest check and every reader case against `root`."""
    check_shape(root)
    check_readers(root)
    for w in bench(root)["workloads"]:
        check_cell(root, w["name"])
    for n in case_names(root):
        check_case(root, n)
