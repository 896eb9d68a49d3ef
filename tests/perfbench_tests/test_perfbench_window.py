"""A whole perfbench run on the CPU at L=12 (the port's plain versions):
the window's unit accounting, the result line, the comparison passing the
program and failing planted faults, a cell, reader and layout added as new
files only, and the refusals (no card, a bare checkout, JAX loaded)."""

import ast
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

from _perfbench_tree import REPO, small_tree
from perfbench import harness, run as run_mod

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _bench(root):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


# the manifest's one-chip cells (a cell on several chips runs on ranks:
# test_perfbench_ranks.py)
CELLS = [w["name"] for w in _bench(REPO)["workloads"] if w["chips"] == 1]


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(name, small_root):
    out = harness.run(name, 2 ** 31 + 12345, 0.3, False, "cpu", small_root,
                      log=lambda m: None)
    assert list(out) == KEYS  # "checks" last
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    want = [m["name"] for m in _bench(small_root)["end_to_end"]
            if name in m.get("workloads", [name])]
    assert list(out["metrics"]) == want
    assert all(m["value"] > 0 or k == "peak_gib"
               for k, m in out["metrics"].items())
    assert {"residual", "E0_gap", "pad", "mu_max"} <= set(out["checks"])
    assert {"row", "row_pi"} & set(out["checks"])
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    assert out["device"]["count"] == 1


def test_traced_run_reports_per_layer_metrics(small_root):
    """On the CPU the counters read (compact: the apply module's forward
    calls); a reader of device time finds no device work and is left out.
    The window outlasts its seconds until each kind has run once."""
    out = harness.run("compact_gs_kpm_L28", 7, 0.001, True, "cpu",
                      small_root, log=lambda m: None)
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert out["correct"]
    assert set(out["metrics"]) == {"applies_per_groundstate",
                                   "applies_per_row"}
    assert out["metrics"]["applies_per_row"]["value"] == 51  # 1 + 50 a plane
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


FAKE_LAYOUT = '''
"""A layout whose units sleep: the window's accounting alone."""
import time


class System:
    apply_type = None

    def __init__(self, cfg, device):
        self.cfg = cfg

    def setup(self):
        return {}

    def groundstate(self, generator):
        time.sleep(self.cfg["sleep"]["groundstate"])
        return {"E0": 0.0, "psi": None, "info": {"residual": 0.0}}

    def row(self, gs, q):
        time.sleep(self.cfg["sleep"]["row"])
        return [1.0], 1.0, 0.0

    def applies(self):
        return None

    def to_host(self, psi):
        return psi

    def probes(self):
        return {}

    def close(self):
        pass


def reference_state(H, host):
    return None, 0.0
'''

FAKE_MIX_CHECK = '''
from perfbench.mixes.gs_sqw import run, metrics, counts  # noqa: F401


def check(ctx, res, H):
    return [("units", len(res["units"]), 1e9)], 0
'''


def _add_fake_cell(root, sleep, reader=None):
    """A cell on the sleeping layout, added as new files and entries."""
    pb = Path(root) / "perfbench"
    (pb / "layouts" / "fake.py").write_text(FAKE_LAYOUT)
    (pb / "mixes" / "fake_mix.py").write_text(FAKE_MIX_CHECK)
    cfg = {"model": {"layout": "fake", "chain": "xxz", "L": 4, "nup": 2,
                     "Jxy": 1.0, "Jz": 1.0},
           "sqw": {"q_k": [1]}, "sleep": sleep}
    (pb / "configs" / "fake.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "fake.json").write_text(json.dumps(
        {"mix": "fake_mix", "rows_per_groundstate": 2, "trace": {}}))
    b = _bench(root)
    b["configs"].append({"name": "fake", "source": "none", "file":
                         "perfbench/configs/fake.json", "reduced": [],
                         "why": "a test"})
    b["workloads"].append({"name": "fake_cell", "config": "fake",
                           "traffic": "fake", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        m.get("workloads", []).append("fake_cell")
    if reader:
        (pb / "readers" / f"{reader}.py").write_text(textwrap.dedent('''
            def read(ctx):
                return 42.0
            '''))
        b["per_layer"].append({"name": reader, "unit": "x",
                               "better": "lower", "source": "host_clock",
                               "layer": "test", "moves": "setup_s",
                               "workloads": ["fake_cell"]})
    (Path(root) / "BENCHMARK.json").write_text(json.dumps(b))


def test_unit_accounting(tmp_path):
    """No unit starts once the seconds have passed; the unit in flight
    then runs to its end and counts; a time metric is its units' summed
    walls over their count."""
    root = small_tree(tmp_path)
    _add_fake_cell(root, {"groundstate": 0.2, "row": 0.05})
    t0 = time.perf_counter()
    out = harness.run("fake_cell", 1, 0.22, False, "cpu", root,
                      log=lambda m: None)
    wall = time.perf_counter() - t0
    # gs (0-0.2), row (0.2-0.25): the row started before 0.22 and counts,
    # the next row would start after it and does not
    assert out["attempted"] == 2 and out["correct"]
    assert 0.25 <= wall < 1.0
    gs = out["metrics"]["groundstate_s"]["value"]
    row = out["metrics"]["sqw_row_s"]["value"]
    assert 0.2 <= gs < 0.3 and 0.05 <= row < 0.15


def test_dummy_cell_and_reader_added_as_files(tmp_path):
    root = small_tree(tmp_path)
    _add_fake_cell(root, {"groundstate": 0.01, "row": 0.01},
                   reader="dummy_metric")
    out = harness.run("fake_cell", 3, 0.05, True, "cpu", root,
                      log=lambda m: None)
    assert out["metrics"] == {"dummy_metric": {"value": 42.0, "unit": "x"}}


# ---- the comparison fails a broken timed path ------------------------------


FAULTS = {
    "E0 altered": ("groundstate", lambda out: dict(out, E0=out["E0"]
                                                   + 2e-3)),
    "a row altered": ("row", lambda out: (out[0] * 1.01,) + out[1:]),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_wrong_answer_fails(name, fault, small_root, monkeypatch):
    _, _, cfg, _ = harness.cell(small_root, name)
    layout = harness.load(small_root, "layouts", cfg["model"]["layout"])
    meth, spoil = FAULTS[fault]
    orig = getattr(layout.System, meth)
    monkeypatch.setattr(layout.System, meth,
                        lambda self, *a, **k: spoil(orig(self, *a, **k)))
    real_load = harness.load
    monkeypatch.setattr(harness, "load", lambda root, sub, n: layout
                        if sub == "layouts" else real_load(root, sub, n))
    out = harness.run(name, 11, 0.3, False, "cpu", small_root,
                      log=lambda m: None)
    assert not out["correct"] and out["failed"] >= 1


def test_a_step_that_returns_its_state_fails(small_root, monkeypatch):
    """The compact apply replaced, after set-up, by one that returns its
    state unchanged: the solver "converges" on its random start, the
    reference's residual does not."""
    layout = harness.load(small_root, "layouts", "compact")
    orig = layout.System.setup

    def setup(self):
        info = orig(self)
        self.mv.forward = lambda psi: psi.clone()
        return info

    monkeypatch.setattr(layout.System, "setup", setup)
    real_load = harness.load
    monkeypatch.setattr(harness, "load", lambda root, sub, n: layout
                        if sub == "layouts" else real_load(root, sub, n))
    out = harness.run("compact_gs_kpm_L28", 5, 0.2, False, "cpu",
                      small_root, log=lambda m: None)
    assert not out["correct"]
    assert out["checks"]["residual"]["value"] > 0.1


# ---- what the benchmark may not do ------------------------------------------


BANNED = ("jax", "jaxlib", "flax", "spindynamics_tpu")


def test_no_file_imports_jax_or_the_jax_package():
    """Whole top-level names: spindynamics_tpu_torch is not
    spindynamics_tpu. The reference imports nothing of the port."""
    for p in sorted((REPO / "perfbench").rglob("*.py")):
        tops = set()
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                tops.add(node.module.split(".")[0])
        assert not tops & set(BANNED), (p, tops)
        if p.name == "reference.py":
            assert tops <= {"__future__", "math", "warnings", "numpy",
                            "torch"}, tops


def test_loaded_modules_are_compared_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "spindynamics_tpu_torch_x", sys)
    assert run_mod.loaded_banned() == [
        m for m in sorted(sys.modules) if m.split(".")[0] in BANNED]
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert "flax.core" in run_mod.loaded_banned()


def test_importing_the_harness_loads_no_jax():
    code = ("import sys, json; sys.path.insert(0, '.'); "
            "from perfbench import harness, calibrate, run; "
            "import spindynamics_tpu_torch; "
            "print(json.dumps(run.loaded_banned()))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout) == []


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "kron_gs_kpm_L32",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300, env=env)


def test_no_card_exits_nonzero_and_prints_no_result(monkeypatch):
    import os

    res = _cli(REPO, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA device" in res.stderr


def test_a_bare_checkout_exits_nonzero(tmp_path):
    """BENCHMARK.json and the files under `paths` alone: no result."""
    import shutil

    b = _bench(REPO)
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    for p in b["paths"]:
        shutil.copytree(REPO / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    res = _cli(tmp_path)
    assert res.returncode != 0 and res.stdout == ""
