"""The port's command line (spindynamics_tpu_torch/cli.py) against the
JAX package's (spindynamics_tpu/cli.py), both run in process on the CPU
with the same arguments (the port's with --device cpu): the JSON line's
keys and values, the .npz keys and shapes, and the results.

The mode names differ by design (the port names each layout's mode) and
go through the one table cli.JAX_MODE. Tolerances: E0 to 1e-8 (float64
solves), S(q, omega) to 1e-6 of its max (L=8: both ground states are
exact), a flat float64 trajectory's <Sz_i> to 1e-8 and its norm to 1e-10;
the kron Chebyshev trajectory and the kron KPM run float32 in both
packages (neither follows a float64 model), so 1e-5 there. Typicality
draws different random vectors in the two packages: each is held to the exact thermal
trace Tr[e^{-beta H} Sz_a(t) Sz_b] / Z at L=8 (dimension 70). One sample
of either package spreads by up to ~0.09 there (measured over the seeds
0-7); the mean of n samples is held to 2 x 0.09 / sqrt(n).
"""

import json

import numpy as np
import pytest
import scipy.linalg
import torch

import spindynamics_tpu_torch as pt
from spindynamics_tpu import cli as jcli
from spindynamics_tpu_torch import cli as tcli


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(mod, capsys, args):
    rc = mod.main(args)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert rc == 0
    return json.loads(out)


def _both(capsys, args, tmp_path=None):
    """(JAX info, port info[, JAX npz, port npz]) of one command."""
    outs = []
    for mod, extra, tag in ((jcli, [], "jax"), (tcli, ["--device", "cpu"],
                                                "port")):
        a = list(args) + extra
        if tmp_path is not None:
            a += ["--out", str(tmp_path / f"{tag}.npz")]
        outs.append(_run(mod, capsys, a))
    j, t = outs
    assert set(t) == set(j) | {"counters"}  # the port's counters besides
    assert tcli.JAX_MODE[t["mode"]] == j["mode"]
    for k in ("L", "nup", "dim", "n_states"):
        assert t[k] == j[k], k
    if tmp_path is None:
        return j, t
    nj, nt = (np.load(tmp_path / f"{tag}.npz") for tag in ("jax", "port"))
    assert set(nj.files) == set(nt.files)
    for k in nj.files:
        assert nj[k].shape == nt[k].shape, k
    return j, t, nj, nt


@pytest.mark.parametrize("layout", ["compact", "sector_kron",
                                    "sector_blocked"])
def test_groundstate_matches_jax(capsys, tmp_path, layout):
    args = ["groundstate", "--L", "10", "--sz0", "--f64", "--lanc-m", "50",
            "--layout", layout]
    j, t, nj, nt = _both(capsys, args, tmp_path)
    assert abs(t["E0"] - j["E0"]) < 1e-8
    assert t["E0"] == pytest.approx(-7.1805, abs=1e-3)
    assert t["residual"] < 1e-8 and t["m_eff"] == j["m_eff"]
    assert abs(float(nt["E0"]) - t["E0"]) == 0


@pytest.mark.parametrize("method,layout", [
    ("lanczos", "compact"), ("kpm", "compact"), ("lanczos", "sector_kron"),
    ("kpm", "sector_kron")])
def test_sqw_matches_jax(capsys, tmp_path, method, layout):
    args = ["sqw", "--method", method, "--L", "8", "--sz0", "--f64",
            "--n-omega", "30", "--lanc-m", "30", "--kpm-m", "20",
            "--layout", layout]
    j, t, nj, nt = _both(capsys, args, tmp_path)
    assert abs(t["E0"] - j["E0"]) < 1e-8
    S_j, S_t = nj["S"], nt["S"]
    assert S_t.shape == (8, 30) and np.isfinite(S_t).all()
    # the kron KPM runs float32 in both packages
    tol = 1e-5 if (method, layout) == ("kpm", "sector_kron") else 1e-6
    assert np.abs(S_t - S_j).max() <= tol * np.abs(S_j).max()
    np.testing.assert_array_equal(nt["q"], nj["q"])
    np.testing.assert_array_equal(nt["omega"], nj["omega"])


@pytest.mark.parametrize("layout,method", [
    ("compact", "chebyshev"), ("compact", "krylov"),
    ("sector_kron", "chebyshev"), ("sector_kron", "krylov")])
def test_evolve_matches_jax(capsys, tmp_path, layout, method):
    args = ["evolve", "--L", "8", "--nup", "4", "--f64", "--steps", "4",
            "--t-max", "0.4", "--cheb-n", "30", "--layout", layout,
            "--method", method]
    j, t, nj, nt = _both(capsys, args, tmp_path)
    # a kron Chebyshev trajectory runs float32 in both packages
    f32 = layout == "sector_kron" and method == "chebyshev"
    tol = 1e-5 if f32 else 1e-8
    assert t["steps"] == j["steps"] and t["dt"] == j["dt"]
    assert abs(t["final_norm"] - j["final_norm"]) < (1e-5 if f32 else 1e-10)
    assert np.abs(nt["magnetization"] - nj["magnetization"]).max() < tol
    assert nt["psi"].shape == nj["psi"].shape


def _exact_thermal(L, beta, a, b, ts):
    """Tr[e^{-beta H} Sz_a(t) Sz_b] / Z of the L-site Heisenberg chain in
    the Sz=0 sector, by dense diagonalization."""
    m = pt.xxz_chain(L, Jxy=1.0, Jz=1.0, nup=L // 2, dtype=torch.float64,
                     layout="compact")
    E, V = scipy.linalg.eigh(pt.build_dense_H(m))
    s = m.basis_states().numpy()
    A = V.T @ ((((s >> a) & 1) - 0.5)[:, None] * V)
    B = V.T @ ((((s >> b) & 1) - 0.5)[:, None] * V)
    w = np.exp(-beta * (E - E.min()))
    return np.array([(w[:, None] * np.exp(1j * (E[:, None] - E[None, :]) * t)
                      * A * B.T).sum() / w.sum() for t in ts])


@pytest.mark.parametrize("layout,samples", [("compact", 4),
                                            ("sector_kron", 2)])
def test_typicality_against_exact_trace(capsys, tmp_path, layout, samples):
    args = ["typicality", "--L", "8", "--sz0", "--f64", "--beta", "0.5",
            "--n-t", "3", "--samples", str(samples), "--site-a", "0",
            "--site-b", "1", "--layout", layout]
    j, t, nj, nt = _both(capsys, args, tmp_path)
    ex = _exact_thermal(8, 0.5, 0, 1, nj["t"])
    tol = 2 * 0.09 / np.sqrt(samples)
    np.testing.assert_array_equal(nt["t"], nj["t"])
    assert np.abs(nj["C"] - ex).max() < tol
    assert np.abs(nt["C"] - ex).max() < tol
    assert t["C0"] == pytest.approx(float(ex[0].real), abs=tol)


@pytest.mark.parametrize("layout,route", [("compact", "ell"),
                                          ("sector_kron", "plain")])
def test_json_line_counts_applies_and_syncs(capsys, layout, route):
    """The line's "counters": one stored-basis Lanczos of lanc_m steps is
    lanc_m applies and one for the residual, two host reads (the
    tridiagonal's coefficients and the residual); a second command in the
    same process reports its own counts, not the sum."""
    args = ["groundstate", "--L", "10", "--sz0", "--f64", "--lanc-m", "30",
            "--layout", layout, "--device", "cpu"]
    first = _run(tcli, capsys, args)["counters"]
    assert first[f"applies.{route}"] == 31 and first["syncs"] == 2
    assert not [k for k in first if k.startswith("applies.")
                and k != f"applies.{route}"]
    assert _run(tcli, capsys, args)["counters"] == first


def test_mesh_matches_unsharded_and_jax(capsys, tmp_path):
    """--mesh 2 on the port (a LocalMesh of two shards on the CPU) against
    the port and the JAX CLI without a mesh: E0 and the --out state."""
    args = ["groundstate", "--L", "10", "--sz0", "--f64", "--lanc-m", "30",
            "--cycles", "4", "--layout", "sector_kron", "--twopass"]
    j, t, nj, nt = _both(capsys, args, tmp_path)
    out = tmp_path / "mesh.npz"
    m = _run(tcli, capsys, args + ["--device", "cpu", "--mesh", "2",
                                   "--out", str(out)])
    assert m["mesh"] == 2 and set(m) == set(t) | {"mesh"}
    assert abs(m["E0"] - t["E0"]) < 1e-8 and abs(m["E0"] - j["E0"]) < 1e-8
    psi_m = np.load(out)["psi"]
    assert psi_m.shape == nt["psi"].shape
    # the same state up to its sign
    assert abs(abs(psi_m @ nt["psi"]) - 1) < 1e-8


def test_auto_layout_rule(monkeypatch):
    """auto: compact on the CPU or below L = 16, embedded for 16 <= L < 24
    and sector_kron above on the card; the full space without a sector.
    Driven through main with the card's presence monkeypatched and the
    model build stopped."""
    captured = {}

    def fake_xxz_chain(L, **kw):
        captured.update(kw)
        raise RuntimeError("stop")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pt, "xxz_chain", fake_xxz_chain)
    for L, extra, want in ((24, ["--device", "cuda"], "sector_kron"),
                           (20, ["--device", "cuda"], "embedded"),
                           (14, ["--device", "cuda"], "compact"),
                           (24, ["--device", "cpu"], "compact")):
        with pytest.raises(RuntimeError, match="stop"):
            tcli.main(["groundstate", "--L", str(L), "--sz0"] + extra)
        assert captured["layout"] == want, (L, extra)
        assert captured["dtype"] == (torch.float32 if "cuda" in extra
                                     else torch.float64)
    with pytest.raises(RuntimeError, match="stop"):
        tcli.main(["groundstate", "--L", "20", "--device", "cuda"])
    assert captured["nup"] is None and captured["layout"] == "compact"


@pytest.mark.parametrize("layout,refused", [
    ("sector_kron", True), ("embedded", True), ("compact", False),
    ("sector_blocked", False)])
def test_f64_on_the_card(monkeypatch, capsys, layout, refused):
    """--f64 on the card is refused, before anything is built, for the
    layouts whose kernel takes float32 states (K1, K3); compact and
    sector_blocked run float64 on the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def fake_xxz_chain(L, **kw):
        raise RuntimeError("built")

    monkeypatch.setattr(pt, "xxz_chain", fake_xxz_chain)
    args = ["groundstate", "--L", "24", "--sz0", "--f64", "--layout", layout]
    if refused:
        with pytest.raises(SystemExit) as e:
            tcli.main(args)
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert "--f32" in err and "--device cpu" in err
    else:
        with pytest.raises(RuntimeError, match="built"):
            tcli.main(args)


def test_refusals(capsys):
    """--mesh on a layout other than sector_kron, and --device cuda
    without a card, are usage errors."""
    with pytest.raises(SystemExit):
        tcli.main(["groundstate", "--L", "10", "--sz0", "--layout",
                   "compact", "--mesh", "2", "--device", "cpu"])
    assert "--mesh needs the sector_kron layout" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            tcli.main(["groundstate", "--L", "10", "--sz0"])
        assert "--device cpu" in capsys.readouterr().err
