"""The per-layer readers against a trace made by hand, and BENCHMARK.json
against the contract's shape: every name it gives has its file."""

import json
import re
from types import SimpleNamespace

import pytest

from _perfbench_tree import REPO
from perfbench import harness, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _events():
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


def _ctx(applies=(20, 10)):
    an = trace.analyze(_events(), ("groundstate", "row"))
    sl = {k: SimpleNamespace(applies=n)
          for k, n in zip(("groundstate", "row"), applies)}
    return SimpleNamespace(trace=an, slices=sl, counts={
        "applies.groundstate": 160.0, "applies.row": 101.0},
        probes={"apply_ms": 40.0, "apply_bound_ms": 1.435, "dot_ms": 2.0,
                "dot_bound_ms": 1.8})


def test_analyze_reads_the_slices():
    an = trace.analyze(_events(), ("groundstate", "row"))
    g = an["spans"]["groundstate"]
    assert (g["wall_ms"], g["busy_ms"]) == (0.1, 0.045)
    assert g["busy_share"] == pytest.approx(0.45)
    assert (g["device_ms"], g["k1_ms"], g["dot2_ms"]) == pytest.approx(
        (0.045, 0.03, 0.005))
    assert (g["launches"], g["k1_launches"], g["dot2_launches"]) == (4, 2, 1)
    assert an["spans"]["row"]["launches"] == 1
    assert an["top_names"][0]["name"].startswith("void kron_group")
    # the longest gap: groundstate 60-100 us, the host in aten::item
    assert an["idle_gaps"][0] == {"span": "groundstate", "ms": 0.04,
                                  "host_op": "aten::item"}


EXPECTED = {
    "applies_per_groundstate": 160.0,
    "applies_per_row": 101.0,
    "vecop_ms_per_apply.gs": (0.045 - 0.03) / 20,
    "vecop_ms_per_apply.sqw": None,  # no K1 in the row slice
    "k1_ms_per_apply": 0.03 / 20,
    "launches_per_apply.gs": 4 / 20,
    "busy_share.gs": 45.0,
    "busy_share.sqw": 40.0,
    "kron_apply_roofline": 100 * 1.435 / 40.0,
    "ell_apply_roofline": 100 * 1.435 / 40.0,
    "dot2_roofline": 90.0,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_synthetic_trace(name):
    got = harness.load(REPO, "readers", name).read(_ctx())
    if EXPECTED[name] is None:
        assert got is None
    else:
        assert got == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_without_a_trace(name):
    """No trace, no probes, no counts: every reader returns None, never 0
    (a share of a roofline that was not measured is left out)."""
    ctx = SimpleNamespace(trace=None, slices={}, counts={}, probes={})
    assert harness.load(REPO, "readers", name).read(ctx) is None


def test_every_per_layer_metric_has_its_reader():
    names = {m["name"] for m in _bench()["per_layer"]}
    assert names == set(EXPECTED)


def test_manifest_has_the_contract_shape():
    b = _bench()
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


@pytest.mark.parametrize("w", [w["name"] for w in _bench()["workloads"]])
def test_each_cell_finds_its_files(w):
    b, wl, cfg, traffic = harness.cell(REPO, w)
    c = next(c for c in b["configs"] if c["name"] == wl["config"])
    assert c["file"].startswith("perfbench/configs/")
    assert cfg["name"] == c["name"] and len(cfg["source"]) <= 200
    assert set(c["reduced"]) <= set(cfg)  # top-level keys of the file
    assert wl["chips"] == 1
    for sub, name in (("mixes", traffic["mix"]),
                      ("layouts", cfg["model"]["layout"])):
        assert (REPO / "perfbench" / sub / f"{name}.py").is_file()
    g = cfg["guarantees"]
    assert g["residual_target"] == cfg["groundstate"]["target_residual"]
    assert abs(g["E0_ref"] / cfg["model"]["L"] + 0.74) < 0.01
