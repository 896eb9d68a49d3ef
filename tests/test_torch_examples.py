"""The port's examples (spindynamics_tpu_torch/examples/) against the JAX
package's same calls, in the same order as its example and script files
make them, on the CPU at a small size. The JAX files themselves are not
run: they write into examples/ and .jax_cache/.

Every module's run(device="cpu", dtype=torch.float64) is held to the JAX
package. Tolerances are those of the tests of the same entry points:
- kron ground states (groundstate_kron, float64, both converged far below
  their 1e-3 targets at L <= 12): E0 to 1e-8 (test_torch_cli.py);
- kpm_sqw_kron runs float32 in both packages: S to 1e-5 of its peak, on
  the JAX ground state and bounds (test_torch_cli.py);
- lanczos_sqw_kron and the flat lanczos_sqw at 12-16 steps, float64: 1e-8
  of the peak (test_torch_kron_sqw.py, test_torch_flat_solvers.py);
- kpm_correlation_matrix_kron, float64: 1e-9 of the peak
  (test_torch_kron_observables.py);
- the kron trajectory and typicality run float32 in both packages: 2e-6
  (test_torch_evolve.py);
- the flat float64 paths (Chebyshev, Krylov, KPM, Lanczos spectra):
  1e-8 (test_torch_flat_solvers.py).
The spectral rows give the port the JAX ground state (through
utils/convert), so S is compared on one state; the typicality row gives
both packages the same random pair and bounds.

Then each main(): its stage lines, files only under --out-dir, --help (one
`python -m` subprocess), the card as the default device.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu.models.initial_states import domain_wall_bitstring
from spindynamics_tpu.ops.apply import apply_rescaled_H
from spindynamics_tpu.solvers.blockvec import BlockVec as JBV
from spindynamics_tpu_torch.cli import JAX_MODE
from spindynamics_tpu_torch.examples import (
    example, example_kpm, example_kpm_dos, example_kpm_sqw,
    example_kron_corr, example_kron_evolve, example_kron_lanczos_sqw,
    example_kron_sqw, example_kron_typicality, example_lanczos_sqw,
    example_large_L, gs_ladder, l32_groundstate)
from spindynamics_tpu_torch.ops.sector_kron import make_sector_kron_layout
from spindynamics_tpu_torch.utils.convert import (
    blockvec_from_numpy, state_from_numpy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_kron(L, dtype=jnp.float64):
    return sd.xxz_chain(L, Jxy=1.0, Jz=1.0, nup=L // 2, dtype=dtype,
                        layout="sector_kron")


def _jax_ground_state(L, lanc_m=40, cycles=8, target=1e-3):
    """The JAX kron scripts' ground state, float64."""
    m = _jax_kron(L)
    E0, psi, info, _ = sd.groundstate_kron(m, lanc_m=lanc_m, cycles=cycles,
                                           target_residual=target)
    return m, float(E0), psi, info


def _port_state(psi):
    return blockvec_from_numpy([np.asarray(x) for x in psi.leaves], "cpu",
                               torch.float64)


# ---- the kron modules ------------------------------------------------------


@pytest.mark.parametrize("module,L,kw,jax_kw", [
    (example_large_L, 12, {}, dict(lanc_m=30, cycles=4)),
    (l32_groundstate, 10, {}, dict(lanc_m=30, cycles=4)),
    (gs_ladder, (8, 12), {}, dict(lanc_m=40, cycles=8)),
    (gs_ladder, (10,), dict(lanc_m=24, cycles=3, target_residual=1e-6),
     dict(lanc_m=24, cycles=3, target=1e-6)),
], ids=["large_L", "l32", "ladder", "ladder-flags"])
def test_ground_state_modules_match_jax(module, L, kw, jax_kw):
    if module is gs_ladder:
        out = module.run(L, **kw, **F64)
        assert sorted(out) == sorted(L)
        rows = [(Lk, out[Lk]) for Lk in L]
    else:
        rows = [(L, module.run(L=L, **kw, **F64))]
    for Lk, r in rows:
        _, E0, _, info = _jax_ground_state(Lk, **jax_kw)
        assert abs(r["E0"] - E0) < 1e-8, Lk
        assert r["E0_per_site"] == pytest.approx(r["E0"] / Lk)
        assert r["residual"] <= jax_kw.get("target", 1e-3)


def test_kron_sqw_matches_jax():
    L, kpm_m, nq = 12, 20, 2
    m, E0, psi, info = _jax_ground_state(L)
    qs = [2 * np.pi * k / L for k in range(1, nq + 1)]
    Sj, sj = sd.kpm_sqw_kron(m, qs, np.linspace(0.0, 4.0, 100), kpm_m=kpm_m,
                             psi0=psi, E0=E0, info=info)
    out = example_kron_sqw.run(L, kpm_m, nq, psi0=_port_state(psi), E0=E0,
                               bounds=sj["bounds"], **F64)
    assert out["qs"] == qs and out["S"].shape == (nq, 100)
    peak = float(np.abs(Sj).max())
    assert peak > 0.1
    assert np.abs(out["S"] - np.asarray(Sj)).max() <= 1e-5 * peak
    own = example_kron_sqw.run(L, kpm_m, nq, **F64)  # its own ground state
    assert abs(own["E0"] - E0) < 1e-8 and own["residual"] <= 1e-3
    assert np.isfinite(own["S"]).all() and own["S"].max() > 0.1


def test_kron_lanczos_sqw_matches_jax():
    L, lanc_m, nq = 12, 12, 2
    m, E0, psi, info = _jax_ground_state(L)
    qs = [2 * np.pi * k / L for k in range(1, nq + 1)]
    Sj, ij = sd.lanczos_sqw_kron(m, qs, np.linspace(0.0, 4.0, 100),
                                 lanc_m=lanc_m, eta=0.05, psi0=psi, E0=E0,
                                 info=info)
    assert ij["plane_mode"] == "pair"  # the port's default, JAX's on the CPU
    out = example_kron_lanczos_sqw.run(L, lanc_m, nq, psi0=_port_state(psi),
                                       E0=E0, **F64)
    peak = float(np.abs(Sj).max())
    assert peak > 0.01
    assert np.abs(out["S"] - np.asarray(Sj)).max() <= 1e-8 * peak


def test_kron_evolve_matches_jax():
    L, n_steps = 10, 3
    m = _jax_kron(L)
    _, obs_j, info_j = sd.evolve_trajectory_kron(
        m, domain_wall_bitstring(m), 0.1, n_steps, cheb_n=30)
    out = example_kron_evolve.run(L, n_steps, **F64)
    assert out["magnetization"].shape == (n_steps, L)
    np.testing.assert_allclose(out["magnetization"], obs_j, rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(out["norms"], info_j["norms"], rtol=0,
                               atol=2e-6)
    assert np.abs(out["magnetization"].sum(axis=1)).max() < 1e-5
    assert out["N"] == int(sd.sector_dimension(L, L // 2))


def test_kron_typicality_matches_jax():
    L, beta, n_t, t_max = 10, 1.0, 3, 1.0
    m = _jax_kron(L)
    mt = pt.xxz_chain(L, nup=L // 2, dtype=torch.float64)
    lay = make_sector_kron_layout(mt, mt.kron_splits, mt.kron_pads)
    g = torch.Generator().manual_seed(11)
    r = [[x.numpy() for x in pt.bv_random(lay, g, torch.float32, "cpu").leaves]
         for _ in range(2)]
    r_j = tuple(JBV([jnp.asarray(x) for x in p]) for p in r)
    r_t = tuple(blockvec_from_numpy(p, "cpu") for p in r)
    Eb = (-6.0, 4.5)
    ts = np.linspace(0.0, t_max, n_t)
    Cj = sd.typicality_correlation_kron(m, beta, L // 2, L // 2, ts,
                                        kry_m=14, cheb_n=30, Ebounds=Eb,
                                        r0=r_j)
    out = example_kron_typicality.run(L, beta, n_t, t_max, r0=r_t,
                                      Ebounds=Eb, **F64)
    np.testing.assert_array_equal(out["t"], ts)
    np.testing.assert_allclose(out["C"], np.asarray(Cj), rtol=0, atol=2e-6)
    assert out["C"][0].real == pytest.approx(0.25, abs=1e-6)


def test_kron_typicality_keeps_the_scripts_checks(monkeypatch):
    """The JAX script's asserts stay: a C(t) that breaks them raises."""
    monkeypatch.setattr(pt, "typicality_correlation_kron",
                        lambda *a, **k: np.array([0.25, 0.3 + 0j]))
    with pytest.raises(AssertionError):
        example_kron_typicality.run(8, n_t=2, **F64)
    monkeypatch.setattr(pt, "typicality_correlation_kron",
                        lambda *a, **k: np.array([-0.01, 0.0 + 0j]))
    with pytest.raises(AssertionError):
        example_kron_typicality.run(8, n_t=2, **F64)


def test_kron_corr_matches_jax():
    L, n, n_sites = 12, 20, 3
    m, E0, psi, info = _jax_ground_state(L)
    sites = list(range(L // 2 - n_sites // 2, L // 2 + (n_sites + 1) // 2))
    omega = np.linspace(E0 - 1.0, E0 + 5.0, 120)
    Cj, cj = sd.kpm_correlation_matrix_kron(m, omega, n=n, psi0=psi, E0=E0,
                                            info=info, sites=sites)
    out = example_kron_corr.run(L, n, n_sites, psi0=_port_state(psi), E0=E0,
                                a=cj["a"], b=cj["b"], **F64)
    assert out["sites"] == sites and out["C"].shape == (L, n_sites, 120)
    peak = float(np.abs(Cj).max())
    assert np.abs(out["C"] - np.asarray(Cj)).max() <= 1e-9 * peak
    own = example_kron_corr.run(L, n, n_sites, **F64)
    assert abs(own["E0"] - E0) < 1e-8
    assert np.isfinite(own["C"]).all()


# ---- the flat modules (the JAX package's default layout, compact) ----------


def _jax_flat(L, nup, **kw):
    """The JAX examples' model: no layout given, so JAX's default."""
    return sd.xxz_chain(L, nup=nup, dtype=jnp.float64, **kw)


def test_example_matches_jax():
    L, nup, n_steps, t_max = 14, 12, 20, 0.5
    dt = t_max / n_steps
    m = _jax_flat(L, nup, Jxy=1.0, Jz=0.5)
    mv = sd.matvec_fn(m)
    psi0 = sd.domain_wall_state(m, dtype=jnp.complex128)
    Emin, Emax = sd.estimate_energy_bounds(mv, m.n_states, lanc_m=60)
    coeffs = sd.chebyshev_coefficients(dt, Emin, Emax, 10)
    U = scipy.linalg.expm(-1j * dt * sd.build_dense_H(m))
    psi_c = psi_k = psi0
    psi_x = np.asarray(psi0)
    mc, mk, mx = [], [], []
    for _ in range(n_steps):
        psi_c = sd.chebyshev_time_evolve(psi_c, mv, dt, (Emin, Emax),
                                         cheb_n=10, coeffs=coeffs)
        psi_k = sd.krylov_time_evolve(psi_k, mv, dt, kry_m=50)
        psi_x = U @ psi_x
        mc.append(np.asarray(sd.magnetization_per_site(psi_c, m)))
        mk.append(np.asarray(sd.magnetization_per_site(psi_k, m)))
        mx.append(np.asarray(sd.magnetization_per_site(jnp.asarray(psi_x),
                                                       m)))
    out = example.run(L, nup, t_max=t_max, n_steps=n_steps, **F64)
    assert JAX_MODE[out["mode"]] == m.mode and out["N"] == m.n_states
    for key, ref in (("mags_cheb", mc), ("mags_kry", mk), ("mags_exact", mx)):
        np.testing.assert_allclose(out[key], np.asarray(ref), rtol=0,
                                   atol=1e-8, err_msg=key)
    assert out["fid_cheb"][-1] >= 1 - 1e-8 and out["fid_kry"][-1] >= 1 - 1e-8


def test_example_kpm_matches_jax():
    L, n_moments = 8, 200
    m = _jax_flat(L, L // 2, Jxy=1.0, Jz=0.5)
    mv = sd.matvec_fn(m)
    E0, psi0, _ = sd.lanczos_groundstate(mv, m.n_states, lanc_m=80,
                                         dtype=jnp.float64)
    Emin, Emax = sd.estimate_energy_bounds(mv, m.n_states, lanc_m=60)
    a, b = sd.rescaling_params(Emin, Emax)
    omega = np.linspace(Emin, Emax, 300)
    psi0c = jnp.asarray(np.asarray(psi0) + 0j)
    Cj = np.asarray([np.asarray(sd.kpm_dynamical_correlation(
        psi0c, sd.make_spin_operator(i, "z"), sd.make_spin_operator(i, "z"),
        omega, m, n=n_moments, a=a, b=b)) for i in range(L)])
    out = example_kpm.run(L, n_moments, bounds=(Emin, Emax), **F64)
    assert JAX_MODE[out["mode"]] == m.mode
    assert abs(out["E0"] - float(E0)) < 1e-10
    # the cross-check held inside run
    assert abs(out["eigsh"][0] - float(E0)) < 1e-10
    assert np.abs(out["C_auto"] - Cj).max() <= 1e-8 * Cj.max()
    assert out["weight"] == pytest.approx(
        float(np.trapezoid(Cj.mean(axis=0), omega)), abs=1e-8)
    # its own bounds: a 60-step Lanczos run (N = 70) from another random
    # start, whose extreme Ritz values agree with JAX's to 1e-6 (1.4e-7
    # measured)
    own = example_kpm.run(L, n_moments, **F64)
    assert np.abs(np.asarray(own["Ebounds"]) - (Emin, Emax)).max() < 1e-6


def test_example_kpm_dos_matches_jax():
    # 40 Lanczos steps: at 100 the two recurrences' ghost poles differ in
    # the last bits and the broadened spectra by 3.5e-4 of the peak
    L, kpm_m, lanc_m = 12, 256, 40
    m = _jax_flat(L, L // 2, Jxy=1.0, Jz=1.0)
    mv = sd.matvec_fn(m)
    bounds = sd.estimate_energy_bounds(mv, m.n_states, lanc_m=100)
    a, b = sd.rescaling_params(*bounds)
    psi = jnp.asarray(np.asarray(sd.neel_state(m, dtype=jnp.float64)) + 0j)
    mu = sd.chebyshev_moments(
        lambda v: apply_rescaled_H(v, model=m, a=a, b=b), psi, kpm_m,
        doubling_trick=True)
    omega = np.linspace(bounds[0], bounds[1], 3000)
    rho_k = np.asarray(sd.kpm_reconstruct(
        mu, omega, a, b, kernel="jackson", doubling=True, clamp=None,
        density_2_over_a=False)) / a
    al, be, nrm = sd.lanczos_tridiag(mv, psi, lanc_m=lanc_m)
    rho_l = sd.spectral_from_tridiagonal(al, be, float(nrm), 0.0, omega,
                                         eta=np.pi * a / kpm_m,
                                         broaden="gauss")
    out = example_kpm_dos.run(L, kpm_m, lanc_m, bounds=bounds, **F64)
    assert JAX_MODE[out["mode"]] == m.mode
    np.testing.assert_allclose(out["rho_kpm"], rho_k, rtol=0,
                               atol=1e-8 * rho_k.max())
    np.testing.assert_allclose(out["rho_lanc"], rho_l, rtol=0,
                               atol=1e-8 * rho_l.max())
    i_k = np.trapezoid(rho_k, omega)
    assert out["integral_kpm"] == pytest.approx(i_k, abs=1e-8)
    assert abs(out["integral_kpm"] - 1) < 2e-2
    assert abs(out["integral_lanc"] - 1) < 2e-2
    own = example_kpm_dos.run(L, kpm_m, lanc_m, **F64)  # its own bounds
    assert abs(own["ks"] - out["ks"]) < 1e-3


def test_example_kpm_sqw_matches_jax():
    L, kpm_m = 12, 40
    m = sd.heisenberg_chain(L, J=1.0, nup=L // 2, dtype=jnp.float64)
    mv = sd.matvec_fn(m)
    E0, psi0, _ = sd.lanczos_groundstate(mv, m.n_states, lanc_m=100,
                                         dtype=jnp.float64)
    bounds = sd.estimate_energy_bounds(mv, m.n_states, lanc_m=80)
    a, b = sd.rescaling_params(*bounds)
    qs = [2 * np.pi * k / L for k in range(L)]
    omega = np.linspace(0.0, 5.0, 50)
    Sj = np.asarray(sd.kpm_sqw(psi0, m, qs, omega, a=a, b=b, kpm_m=kpm_m,
                               E0=float(E0)))
    out = example_kpm_sqw.run(
        L, kpm_m, psi0=state_from_numpy(np.asarray(psi0), "cpu"),
        E0=float(E0), bounds=bounds, **F64)
    assert JAX_MODE[out["mode"]] == m.mode and out["S"].shape == (L, 50)
    assert np.abs(out["S"] - Sj).max() <= 1e-8 * Sj.max()
    own = example_kpm_sqw.run(L, kpm_m, nq=3, **F64)
    assert abs(own["E0"] - float(E0)) < 1e-10 and own["S"].shape == (3, 50)


def test_example_lanczos_sqw_matches_jax():
    L, lanc_m = 12, 100
    m = sd.heisenberg_chain(L, J=1.0, nup=L // 2, dtype=jnp.float64)
    mv = sd.matvec_fn(m)
    E0, psi0, _ = sd.lanczos_groundstate(mv, m.n_states, lanc_m=lanc_m,
                                         dtype=jnp.float64)
    qs = [2 * np.pi * k / L for k in range(L)]
    omega = np.linspace(0.0, 4.0, 200)
    # 16 steps for the spectra: before the recurrence loses orthogonality
    Sj = np.asarray(sd.lanczos_sqw(psi0, m, qs, omega, lanc_m=16, eta=0.05))
    out = example_lanczos_sqw.run(
        L, 16, psi0=state_from_numpy(np.asarray(psi0), "cpu"), **F64)
    assert JAX_MODE[out["mode"]] == m.mode and out["S"].shape == (L, 200)
    assert np.abs(out["S"] - Sj).max() <= 1e-8 * Sj.max()
    own = example_lanczos_sqw.run(L, lanc_m, **F64)
    assert abs(own["E0"] - float(E0)) < 1e-10
    assert np.isfinite(own["S"]).all()


# ---- main(): stage lines, files, --help, the device rule -------------------

MAINS = [
    (example_large_L, ["10"], ["groundstate"]),
    (gs_ladder, ["8", "10", "--lanc-m", "20", "--cycles", "2"],
     ["groundstate", "groundstate"]),
    (l32_groundstate, ["20", "2", "1e-3", "--L", "8"], ["groundstate"]),
    (example_kron_sqw, ["10", "10", "2"], ["groundstate", "sqw", "plot"]),
    (example_kron_lanczos_sqw, ["10", "10", "2"],
     ["groundstate", "lanczos_sqw", "plot"]),
    (example_kron_evolve, ["10", "2"], ["model", "trajectory", "data",
                                       "plot"]),
    (example_kron_typicality, ["10", "1.0", "2", "0.5"],
     ["model", "typicality", "checks"]),
    (example_kron_corr, ["10", "10", "2"],
     ["groundstate", "corr_matrix", "plot"]),
    (example, ["--L", "8", "--nup", "6", "--n-steps", "3"],
     ["model", "bounds", "evolution", "plot"]),
    (example_kpm, ["--L", "6", "--n-moments", "20"],
     ["groundstate", "eigsh", "kpm", "plot"]),
    (example_kpm_dos, ["--L", "8", "--kpm-m", "64"],
     ["model", "kpm", "lanczos", "compare", "plot"]),
    (example_kpm_sqw, ["--L", "8", "--kpm-m", "20", "--nq", "2"],
     ["model", "groundstate", "kpm_sqw", "plot"]),
    (example_lanczos_sqw, ["--L", "8", "--lanc-m", "20"],
     ["model", "groundstate", "lanczos_sqw", "plot"]),
]


def _tree(path):
    """{relative path: (size, mtime_ns)} of every file under path."""
    out = {}
    for root, _, files in os.walk(path):
        for f in files:
            p = os.path.join(root, f)
            st = os.stat(p)
            out[os.path.relpath(p, path)] = (st.st_size, st.st_mtime_ns)
    return out


@pytest.mark.parametrize("module,argv,stages", MAINS,
                         ids=[m.__name__.rsplit(".", 1)[1] for m, *_ in MAINS])
def test_main_prints_stages_and_writes_only_under_out_dir(
        module, argv, stages, tmp_path, monkeypatch, capsys):
    """Run from an empty working directory: the stage lines are JSON with
    the JAX scripts' stage names, and every file lands under --out-dir
    (a plot where matplotlib is installed, else a "skipped" plot line);
    examples/ and scripts/ are untouched."""
    before = {d: _tree(os.path.join(REPO, d)) for d in ("examples",
                                                         "scripts")}
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    out_dir = tmp_path / "out"
    res = module.main(argv + ["--device", "cpu", "--dtype", "float64",
                              "--out-dir", str(out_dir)])
    assert isinstance(res, dict)
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["stage"] for ln in lines] == stages
    written = sorted(os.listdir(out_dir)) if out_dir.exists() else []
    named = sorted(os.path.basename(ln["file"]) for ln in lines
                   if "file" in ln)
    assert written == named
    for ln in lines:
        if ln["stage"] == "plot" and "file" in ln:
            assert ln["file"].startswith(str(out_dir))
    assert not os.listdir(cwd)
    for d in ("examples", "scripts"):
        assert _tree(os.path.join(REPO, d)) == before[d]


def test_evolve_npz_has_the_jax_keys(tmp_path, capsys):
    example_kron_evolve.main(["8", "2", "--device", "cpu", "--out-dir",
                              str(tmp_path)])
    z = np.load(tmp_path / "example_kron_evolve_L8.npz")
    ref = np.load(os.path.join(REPO, "examples",
                               "example_kron_evolve_L28.npz"))
    assert sorted(z.files) == sorted(ref.files)
    assert z["magnetization"].shape == (2, 8) and z["norms"].shape == (2,)


@pytest.mark.parametrize("module", [m for m, *_ in MAINS],
                         ids=[m.__name__.rsplit(".", 1)[1] for m, *_ in MAINS])
def test_help(module, capsys):
    with pytest.raises(SystemExit) as e:
        module.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--device", "--dtype", "--seed", "--out-dir"):
        assert flag in out
    assert module.__name__ in out


def test_help_through_python_m():
    res = subprocess.run(
        [sys.executable, "-m",
         "spindynamics_tpu_torch.examples.example_kron_sqw", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "[L] [kpm_m] [nq]" in res.stdout and "--device" in res.stdout


def test_the_card_is_the_default(monkeypatch, capsys):
    """No --device means the card: without CUDA a usage error that names
    --device cpu; float64 with a K1 module on the card is refused, as the
    CLI refuses it, before anything is built."""
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            example_kpm.main([])
        assert e.value.code == 2
        assert "--device cpu" in capsys.readouterr().err
        with pytest.raises(RuntimeError, match='device="cpu"'):
            example_kron_evolve.run(8, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def built(*a, **k):
        raise RuntimeError("built")

    monkeypatch.setattr(pt, "xxz_chain", built)
    with pytest.raises(SystemExit) as e:
        example_kron_sqw.main(["10", "--dtype", "float64"])
    assert e.value.code == 2 and "--device cpu" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="built"):
        example.main(["--dtype", "float64"])  # compact: float64 on the card
