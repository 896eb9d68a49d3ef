"""A configuration that brings its own float64 reference chain: the
power-law XY chain of powerlaw/ (_powerlaw.py). Its reference against an
independent sparse matrix and against the port's kron apply; its cell
added to a tree cut to L=12 as new files and entries only, correct there
and failing against the nearest-neighbour chain; the template at its own
size under the manifest's checks; and a chain with no file ending a run
before its set-up."""

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import _manifest
import _powerlaw
from _perfbench_tree import REPO, small_tree
from perfbench import harness

F64 = torch.float64
ENTRY = ("import sys; sys.path.insert(0, '.'); from perfbench import run; "
         "run.TORCH_THREADS = 1; "
         "sys.exit(run.main(sys.argv[1:], device='cpu'))")


def _model(L, alpha=1.5, Jxy=1.0, Jz=0.0):
    return {"chain": "powerlaw_xy", "L": L, "nup": L // 2, "alpha": alpha,
            "Jxy": Jxy, "Jz": Jz}


def _chain(model):
    return harness.chain(_powerlaw.TEMPLATE, model)("cpu")


def _sparse(L, nup, alpha, Jxy, Jz):
    """H on the sector in ascending order, from bit operations on every
    pair of sites: a flip of an antiparallel pair with amplitude
    Jxy |i - j|^-alpha, Jz |i - j|^-alpha Sz_i Sz_j on the diagonal."""
    states = np.array([s for s in range(1 << L) if bin(s).count("1") == nup])
    idx = np.full(1 << L, -1)
    idx[states] = np.arange(states.size)
    rows, cols, vals = [np.arange(states.size)], [np.arange(states.size)], []
    diag = np.zeros(states.size)
    for i in range(L):
        for j in range(i + 1, L):
            w = float(j - i) ** -alpha
            bi, bj = (states >> i) & 1, (states >> j) & 1
            diag += Jz * w * (bi - 0.5) * (bj - 0.5)
            flip = np.nonzero(bi != bj)[0]
            rows.append(idx[states[flip] ^ ((1 << i) | (1 << j))])
            cols.append(flip)
            vals.append(np.full(flip.size, Jxy * w))
    return sp.csr_matrix((np.concatenate([diag] + vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(states.size, states.size))


@pytest.mark.parametrize("Jz", [0.0, 0.7])
@pytest.mark.parametrize("alpha", [1.0, 1.5, 3.0])
@pytest.mark.parametrize("L", [8, 10])
def test_chain_is_the_sparse_H(L, alpha, Jz):
    H = _chain(_model(L, alpha, 0.8, Jz))
    x = torch.randn(H.n, dtype=F64, generator=torch.Generator()
                    .manual_seed(L))
    want = H.from_flat(torch.from_numpy(
        _sparse(L, L // 2, alpha, 0.8, Jz) @ x.numpy()))
    got = H(H.from_flat(x))
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())


@pytest.mark.parametrize("Jz", [0.0, 0.7])
@pytest.mark.parametrize("L", [12, 16])
def test_chain_is_the_port_kron_apply(L, Jz):
    """The template layout's model (the port's long_range_xy_chain) through
    the port's kron apply in float64, read back through the layout's rule,
    equals the reference's apply on a seeded random state."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops.sector_kron import (
        make_sector_kron_layout)
    from spindynamics_tpu_torch.solvers.blockvec import bv_random

    model = _model(L, Jz=Jz)
    layout = harness.load(_powerlaw.TEMPLATE, "layouts",
                          "sector_kron_powerlaw")
    m = layout.System.chain(model, F64)
    lay = make_sector_kron_layout(m, m.kron_splits, m.kron_pads)
    v = bv_random(lay, torch.Generator().manual_seed(L), F64, "cpu")
    hv = pt.KronHamiltonian(lay, dtype=F64, device="cpu")(v)
    H = _chain(model)
    x, pad = H.from_kron(v.leaves)
    got, pad_out = H.from_kron(hv.leaves)
    want = H(x)
    assert pad == 0.0 and pad_out == 0.0
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())


def test_the_reference_chain_imports_nothing_of_the_port():
    """Whole top-level names: torch and the harness's reference alone (the
    relative import), neither the port nor JAX."""
    p = _powerlaw.TEMPLATE / "perfbench" / "chains" / "powerlaw_xy.py"
    tops = set()
    for node in ast.walk(ast.parse(p.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "math", "warnings", "torch"}, tops


def _tree(tmp_path):
    root = small_tree(tmp_path / "tree")
    shutil.copytree(REPO / _manifest.CASES, root / _manifest.CASES)
    return root


def _files(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_cell_added_as_files_is_correct(tmp_path):
    """At L=12: no file of the tree changes but BENCHMARK.json, whose
    entries are kept and extended; every manifest check holds; a run on
    the CPU is correct and reports the cell's end-to-end metrics."""
    root = _tree(tmp_path)
    before, bench0 = _files(root), _manifest.bench(root)
    name = _powerlaw.add_cell(root, L=12)
    after, bench1 = _files(root), _manifest.bench(root)
    changed = {p for p in before if after[p] != before[p]}
    assert changed == {Path("BENCHMARK.json")}
    for k in ("configs", "workloads"):
        assert bench1[k][:len(bench0[k])] == bench0[k]
    for k in ("end_to_end", "per_layer"):
        for m0, m1 in zip(bench0[k], bench1[k], strict=True):
            assert {**m1, "workloads": None} == {**m0, "workloads": None}
            assert m1.get("workloads", [])[:len(m0.get("workloads", []))] \
                == m0.get("workloads", [])
    _manifest.check_all(root)
    out = harness.run(name, 2 ** 31 + 4321, 0.3, False, "cpu", root,
                      log=lambda m: None)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2
    assert list(out["metrics"]) == ["groundstate_s", "sqw_row_s",
                                    "peak_gib", "setup_s"]
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def test_nearest_neighbour_reference_fails_the_power_law_program(tmp_path):
    """The control: the same tree with the configuration's chain "xxz",
    the nearest-neighbour reference against the power-law program."""
    root = _tree(tmp_path)
    name = _powerlaw.add_cell(root, L=12)
    p = root / _powerlaw.CONFIG_FILE
    cfg = json.loads(p.read_text())
    cfg["model"]["chain"] = "xxz"
    p.write_text(json.dumps(cfg))
    out = harness.run(name, 9, 0.3, False, "cpu", root, log=lambda m: None)
    assert not out["correct"] and out["failed"] >= 1
    assert out["checks"]["residual"]["value"] > 0.1


def test_template_at_its_own_size_passes_the_manifest(tmp_path):
    """The uncut repository with the cell added: its L=30 E0_ref within
    0.02 of the same chain's E0 / L at L=16, and every other check."""
    root = tmp_path / "tree"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root)
    for sub in ("perfbench", str(_manifest.CASES)):
        shutil.copytree(REPO / sub, root / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    name = _powerlaw.add_cell(root)
    _manifest.check_all(root)
    assert harness.cell(root, name)[2]["model"]["L"] == 30


def test_adding_the_cell_twice_overwrites_nothing(tmp_path):
    root = _tree(tmp_path)
    _powerlaw.add_cell(root, L=12)
    with pytest.raises(FileExistsError, match="adds new files only"):
        _powerlaw.add_cell(root, L=12)


def test_a_missing_chain_ends_the_run_before_set_up(tmp_path):
    """A configuration whose chain has no file: run.py exits non-zero
    before the System's set-up, prints no result and names the file."""
    root = _tree(tmp_path)
    b = _manifest.bench(root)
    c = next(c for c in b["configs"] if c["name"] == next(
        w["config"] for w in b["workloads"] if w["name"] == "kron_gs_kpm_L32"))
    p = root / c["file"]
    cfg = json.loads(p.read_text())
    cfg["model"]["chain"] = "nosuch"
    p.write_text(json.dumps(cfg))
    res = subprocess.run(
        [sys.executable, "-c", ENTRY, "--workload", "kron_gs_kpm_L32",
         "--seed", "1", "--seconds", "0.1"], cwd=root, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"))
    assert res.returncode != 0 and res.stdout == ""
    assert "perfbench/chains/nosuch.py is missing" in res.stderr
    assert "set-up:" not in res.stderr  # the harness's log after set-up
