"""Every flat-state solver of the port against its JAX counterpart on the
CPU, from one shared start vector made with numpy. float64 unless a test
says otherwise: both packages then run the same recurrence in the same
order, and differ by the summation order inside dots and by the last bits
of the applies, amplified along a Krylov recurrence: energies to 1e-9,
states and spectra to 1e-8. float32 cases: 1e-5 (float32 rounding through
tens of steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu.solvers import chebyshev as jch
from spindynamics_tpu.solvers import kpm as jkpm
from spindynamics_tpu.solvers import krylov as jkr
from spindynamics_tpu.solvers import lanczos as jla
from spindynamics_tpu.solvers import lanczos_sqw as jls
from spindynamics_tpu.solvers import runners as jru
from spindynamics_tpu_torch.solvers import chebyshev as tch
from spindynamics_tpu_torch.solvers import kpm as tkpm
from spindynamics_tpu_torch.solvers import krylov as tkr
from spindynamics_tpu_torch.solvers import lanczos as tla
from spindynamics_tpu_torch.solvers import lanczos_sqw as tls
from spindynamics_tpu_torch.utils.convert import (
    model_from_numpy, state_from_numpy, state_to_numpy)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


L, NUP = 10, 5
BOUNDS = (-9.0, 9.0)  # outside the spectrum of the L=10 chain below


def _models(f64=True, L=L, nup=NUP):
    jd = jnp.float64 if f64 else jnp.float32
    fld = np.linspace(-0.2, 0.2, L)
    kw = (dict(build_neighbor_table=False) if nup is None
          else dict(nup=nup, layout="embedded"))
    mj = sd.build_model(L, hopping=sd.nn_hopping(L, 1.0), onsite_field=fld,
                        zz=[(i, i + 1, 0.5) for i in range(L - 1)],
                        dtype=jd, **kw)
    mt = model_from_numpy(mj.L, mj.nup, mj.hop_sites, np.asarray(mj.hop_J),
                          np.asarray(mj.field), mj.zz_sites,
                          np.asarray(mj.zz_J),
                          layout="full" if nup is None else "embedded")
    return mj, mt


@pytest.fixture(scope="module")
def setup():
    mj, mt = _models()
    mask = np.asarray(mj.valid_mask())
    rng = np.random.default_rng(11)
    v = np.where(mask, rng.standard_normal(mj.n_states), 0.0)
    vc = np.where(mask, rng.standard_normal(mj.n_states)
                  + 1j * rng.standard_normal(mj.n_states), 0.0)
    H = pt.build_dense_H(mt)
    evals, evecs = np.linalg.eigh(H[np.ix_(mask, mask)])
    gs = np.zeros(mj.n_states)
    gs[mask] = evecs[:, 0]
    return dict(mj=mj, mt=mt, mask=mask, v=v, vc=vc, E0=float(evals[0]),
                gs=gs, mvj=sd.matvec_fn(mj), mvt=pt.matvec_fn(mt, device="cpu"),
                spec=(float(evals[0]), float(evals[-1])))


def _j(x, dtype=None):
    return jnp.asarray(x, dtype)


def _t(x, dtype=None):
    return state_from_numpy(x, "cpu", dtype=dtype)


def _align(a, b):
    """b with the global sign (phase) of a."""
    ph = np.vdot(b, a)
    return b * (ph / abs(ph))


# ---- Lanczos -------------------------------------------------------------


@pytest.mark.parametrize("reorth", [False, True, "selective"], ids=str)
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_lanczos_iteration_matches_jax(setup, reorth, cplx):
    v = setup["vc"] if cplx else setup["v"]
    m = 30
    fj = jla.lanczos_iteration(setup["mvj"], _j(v), m, reorth=reorth,
                               store_basis=True)
    ft = tla.lanczos_iteration(setup["mvt"], _t(v), m, reorth=reorth,
                               store_basis=True)
    assert ft.m_eff == int(fj.m_eff) == m
    np.testing.assert_allclose(ft.alphas.numpy(), np.asarray(fj.alphas),
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(ft.betas.numpy(), np.asarray(fj.betas),
                               rtol=0, atol=1e-9)
    assert abs(float(ft.v0_norm) - float(fj.v0_norm)) <= 1e-12
    # the stored basis: early vectors agree tightly; without
    # reorthogonalization rounding differences grow along the recurrence
    Vj, Vt = np.asarray(fj.basis), ft.basis.numpy()
    assert Vt.shape == Vj.shape == (m, 1 << L)
    assert np.abs(Vt[:10] - Vj[:10]).max() <= 1e-10
    if reorth:
        assert np.abs(Vt - Vj).max() <= 1e-8
        G = Vt.conj() @ Vt.T
        # full: orthogonal to rounding; selective: held below sqrt(eps)
        assert np.abs(G - np.eye(m)).max() <= (1e-12 if reorth is True
                                               else 1.5e-8)
    a, b, nrm = tla.lanczos_tridiag(setup["mvt"], _t(v), m)
    aj, bj, nj = jla.lanczos_tridiag(setup["mvj"], _j(v), m)
    assert b.shape == (m - 1,)
    np.testing.assert_allclose(a.numpy(), np.asarray(aj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), rtol=0, atol=1e-9)


def test_lanczos_breakdown_matches_jax(setup):
    """A start in a small invariant subspace: the masked steps emit beta=0
    and repeat the last alpha in both packages."""
    v = setup["gs"] + 0.5 * np.roll(setup["gs"], 0)
    fj = jla.lanczos_iteration(setup["mvj"], _j(v), 6, tol=1e-8)
    ft = tla.lanczos_iteration(setup["mvt"], _t(v), 6, tol=1e-8)
    assert ft.m_eff == int(fj.m_eff) == 1
    np.testing.assert_allclose(ft.alphas.numpy(), np.asarray(fj.alphas),
                               rtol=0, atol=1e-12)
    assert not ft.betas.any() and not np.asarray(fj.betas).any()


@pytest.mark.parametrize("reorth", ["full", "selective", False], ids=str)
def test_lanczos_groundstate_matches_jax(setup, reorth):
    v, m = setup["v"], 60
    Ej, pj, ij = jla.lanczos_groundstate(setup["mvj"], None, lanc_m=m,
                                         dtype=jnp.float64, reorth=reorth,
                                         v0=_j(v))
    Et, ptt, it = tla.lanczos_groundstate(setup["mvt"], None, lanc_m=m,
                                          dtype=torch.float64, reorth=reorth,
                                          v0=_t(v))
    assert abs(Et - Ej) <= 1e-9 and abs(Et - setup["E0"]) <= 1e-9
    assert it["m_eff"] == ij["m_eff"]
    if reorth:
        np.testing.assert_allclose(it["evals"], ij["evals"], rtol=0,
                                   atol=1e-8)
    else:
        # 60 steps without reorthogonalization lose orthogonality in a
        # 252-dimensional sector: the ghost Ritz values depend on the last
        # bits of every dot, the converged lowest one does not
        assert abs(it["evals"][0] - ij["evals"][0]) <= 1e-9
    assert it["residual"] <= max(10 * ij["residual"], 1e-8)
    pj = np.asarray(pj)
    assert np.abs(_align(pj, state_to_numpy(ptt)) - pj).max() <= 1e-8
    assert np.abs(_align(setup["gs"], state_to_numpy(ptt))
                  - setup["gs"]).max() <= 1e-7
    assert not ptt[~torch.as_tensor(setup["mask"])].any()


def test_twopass_and_restarted_match_jax(setup):
    v = setup["v"]
    Ej, pj, ij = jla.lanczos_groundstate_twopass(
        setup["mvj"], 1 << L, lanc_m=50, dtype=jnp.float64, v0=_j(v))
    Et, ptt, it = tla.lanczos_groundstate_twopass(
        setup["mvt"], 1 << L, lanc_m=50, dtype=torch.float64, v0=_t(v))
    assert abs(Et - Ej) <= 1e-9 and it["m_eff"] == ij["m_eff"]
    assert abs(it["residual"] - ij["residual"]) <= 1e-8
    pj = np.asarray(pj)
    assert np.abs(_align(pj, state_to_numpy(ptt)) - pj).max() <= 1e-8

    kw = dict(lanc_m=20, cycles=8, target_residual=1e-9)
    Ej, pj, ij = jla.lanczos_groundstate_restarted(
        setup["mvj"], 1 << L, dtype=jnp.float64, v0=_j(v), **kw)
    Et, ptt, it = tla.lanczos_groundstate_restarted(
        setup["mvt"], _t(v), **kw)
    assert abs(Et - Ej) <= 1e-9 and abs(Et - setup["E0"]) <= 1e-9
    assert it["cycles"] == ij["cycles"]
    assert it.get("polished", 0) == ij.get("polished", 0)
    assert it["residual"] <= 1e-9
    pj = np.asarray(pj)
    assert np.abs(_align(pj, state_to_numpy(ptt)) - pj).max() <= 1e-8
    assert not ptt[~torch.as_tensor(setup["mask"])].any()


def test_restarted_draws_its_own_masked_start(setup):
    """Without v0 the port draws a masked random start from an explicit
    generator (default dtype float32, real), as the JAX package does from a
    key: the result is the ground state and never leaves the sector."""
    mask = torch.as_tensor(setup["mask"])
    g = torch.Generator().manual_seed(5)
    E, psi, info = pt.lanczos_groundstate_restarted(
        setup["mvt"], N=1 << L, lanc_m=30, cycles=6, target_residual=1e-4,
        generator=g, mask=mask, device="cpu")
    assert psi.dtype == torch.float32 and not psi[~mask].any()
    assert abs(E - setup["E0"]) <= 1e-5 and info["residual"] <= 1e-4
    v = tla._random_start(64, torch.complex64,
                          torch.Generator().manual_seed(1), device="cpu")
    assert v.dtype == torch.complex64 and v.imag.abs().max() > 0
    with pytest.raises(ValueError, match="v0, or N"):
        pt.lanczos_groundstate_restarted(setup["mvt"])


def test_energy_bounds_match_jax_from_one_start(setup):
    """The JAX entry points draw their start from a key; from one shared
    start the port's bounds equal the JAX recurrence's Ritz extremes with
    the same outward pad."""
    v = setup["v"]
    fj = jla.lanczos_iteration(setup["mvj"], _j(v), 40)
    ev, _ = jla.tridiag_eigh(fj.alphas, fj.betas, fj.m_eff)
    lo, hi = pt.lanczos_extremal(setup["mvt"], 1 << L, lanc_m=40, v0=_t(v))
    assert abs(lo - ev.min()) <= 1e-9 and abs(hi - ev.max()) <= 1e-9
    blo, bhi = pt.estimate_energy_bounds(setup["mvt"], 1 << L, lanc_m=40,
                                         v0=_t(v), safety=0.01)
    pad = 0.01 * 0.5 * (hi - lo) + 1e-6
    assert abs(blo - (lo - pad)) <= 1e-12 and abs(bhi - (hi + pad)) <= 1e-12
    # a drawn start: masked, from the generator, outside the true spectrum
    g = torch.Generator().manual_seed(7)
    blo, bhi = pt.estimate_energy_bounds(
        setup["mvt"], 1 << L, generator=g, dtype=torch.float64,
        mask=torch.as_tensor(setup["mask"]))
    e_lo, e_hi = setup["spec"]
    assert blo < e_lo and bhi > e_hi


def test_lanczos_f32_matches_jax():
    mj, mt = _models(f64=False)
    mask = np.asarray(mj.valid_mask())
    v = np.where(mask, np.random.default_rng(2).standard_normal(1 << L),
                 0).astype(np.float32)
    mvj, mvt = sd.matvec_fn(mj, backend="blocked"), pt.matvec_fn(
        mt, device="cpu")
    fj = jla.lanczos_iteration(mvj, _j(v), 20)
    ft = tla.lanczos_iteration(mvt, _t(v), 20)
    assert ft.alphas.dtype == torch.float32
    np.testing.assert_allclose(ft.alphas.numpy(), np.asarray(fj.alphas),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ft.betas.numpy(), np.asarray(fj.betas),
                               rtol=0, atol=1e-5)


# ---- Chebyshev ------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 40])
def test_chebyshev_time_evolve_matches_jax(setup, n):
    x = setup["vc"] / np.linalg.norm(setup["vc"])
    oj = np.asarray(jch.chebyshev_time_evolve(_j(x), setup["mvj"], 0.3,
                                              BOUNDS, cheb_n=n))
    ot = tch.chebyshev_time_evolve(_t(x), setup["mvt"], 0.3, BOUNDS,
                                   cheb_n=n)
    assert ot.dtype == torch.complex128
    assert np.abs(state_to_numpy(ot) - oj).max() <= 1e-12
    if n == 40:  # converged: unitary, in the sector
        assert abs(np.linalg.norm(state_to_numpy(ot)) - 1) <= 1e-10
        assert not ot[~torch.as_tensor(setup["mask"])].any()
    # a real input is lifted to complex; precomputed coefficients agree
    xr = setup["v"] / np.linalg.norm(setup["v"])
    c = tch.chebyshev_coefficients(0.3, *BOUNDS, n)
    a = tch.chebyshev_time_evolve(_t(xr), setup["mvt"], 0.3, BOUNDS,
                                  cheb_n=n, coeffs=c)
    b = np.asarray(jch.chebyshev_time_evolve(_j(xr), setup["mvj"], 0.3,
                                             BOUNDS, cheb_n=n))
    assert np.abs(state_to_numpy(a) - b).max() <= 1e-12


def test_chebyshev_time_evolve_f32_matches_jax():
    mj, mt = _models(f64=False)
    x = np.asarray(sd.domain_wall_state(mj, dtype=jnp.complex64))
    oj = np.asarray(jch.chebyshev_time_evolve(
        _j(x), sd.matvec_fn(mj, backend="blocked"), 0.2, BOUNDS, cheb_n=30))
    ot = tch.chebyshev_time_evolve(_t(x), pt.matvec_fn(mt, device="cpu"),
                                   0.2, BOUNDS, cheb_n=30)
    assert ot.dtype == torch.complex64
    assert np.abs(state_to_numpy(ot) - oj).max() <= 1e-5


def test_moments_and_diagnostics_match_jax(setup):
    a, b = tch.rescaling_params(*BOUNDS)
    phi = setup["vc"] / np.linalg.norm(setup["vc"])
    chi = setup["v"] / np.linalg.norm(setup["v"])

    def mvrj(v):
        return (setup["mvj"](v) - b * v) / a

    def mvrt(v):
        return (setup["mvt"](v) - b * v) / a

    for doubling in (False, True):
        mj_ = np.asarray(jch.chebyshev_moments(mvrj, _j(phi), 33,
                                               doubling_trick=doubling))
        mt_ = tch.chebyshev_moments(mvrt, _t(phi), 33,
                                    doubling_trick=doubling)
        assert not mt_.is_complex()
        np.testing.assert_allclose(mt_.numpy(), mj_, rtol=0, atol=1e-12)
    cj = np.asarray(jch.chebyshev_cross_moments(mvrj, _j(chi), _j(2 * phi),
                                                24))
    ct = tch.chebyshev_cross_moments(mvrt, _t(chi), _t(2 * phi), 24)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=1e-12)
    om = np.linspace(-8, 8, 9)
    dj = jch.kpm_diagnostics(mvrj, _j(phi), om, a, b, M=16)
    dt = tch.kpm_diagnostics(mvrt, _t(phi), om, a, b, M=16)
    assert dt.keys() == dj.keys()
    for k in dj:
        np.testing.assert_allclose(dt[k], dj[k], rtol=0, atol=1e-10,
                                   err_msg=k)
    assert dt["x_in_range"] and dt["moments_bounded"]


# ---- Krylov ----------------------------------------------------------------


def test_krylov_matches_jax(setup):
    x = setup["vc"] / np.linalg.norm(setup["vc"])
    mvj, mvt = setup["mvj"], setup["mvt"]
    for renorm in (True, False):
        oj = np.asarray(jkr.krylov_time_evolve(_j(x), mvj, 0.3, kry_m=20,
                                               renormalize=renorm))
        ot = tkr.krylov_time_evolve(_t(x), mvt, 0.3, kry_m=20,
                                    renormalize=renorm)
        assert np.abs(state_to_numpy(ot) - oj).max() <= 1e-8
    oj = np.asarray(jkr.krylov_expm_multiply(_j(x), mvj, -0.2 + 0.1j,
                                             kry_m=20))
    ot = tkr.krylov_expm_multiply(_t(x), mvt, -0.2 + 0.1j, kry_m=20)
    assert np.abs(state_to_numpy(ot) - oj).max() <= 1e-8
    oj = np.asarray(jkr.krylov_imaginary_time_evolve(_j(x), mvj, 0.7,
                                                     kry_m=20))
    ot = tkr.krylov_imaginary_time_evolve(_t(x), mvt, 0.7, kry_m=20)
    assert np.abs(state_to_numpy(ot) - oj).max() <= 1e-8 * np.abs(oj).max()
    assert not ot[~torch.as_tensor(setup["mask"])].any()
    # against the exact propagator
    H = pt.build_dense_H(setup["mt"])
    ev, U = np.linalg.eigh(H)
    exact = U @ (np.exp(-0.3j * ev) * (U.T @ x))
    ot = tkr.krylov_time_evolve(_t(x), mvt, 0.3, kry_m=30)
    assert np.abs(state_to_numpy(ot) - exact).max() <= 1e-9


# ---- S(q, omega) -----------------------------------------------------------


def test_spectral_from_tridiagonal_matches_jax():
    rng = np.random.default_rng(9)
    a, b = rng.normal(size=(3, 12)), np.abs(rng.normal(size=(3, 11)))
    om = np.linspace(-1, 4, 30)
    for br in ("lorentz", "gauss"):
        np.testing.assert_allclose(
            tls.spectral_from_tridiagonal(a[0], b[0], 1.3, -2.0, om, 0.1, br,
                                          m_eff=9),
            jls.spectral_from_tridiagonal(a[0], b[0], 1.3, -2.0, om, 0.1, br,
                                          m_eff=9), rtol=0, atol=1e-13)
        np.testing.assert_allclose(
            tls.spectral_from_tridiagonal_batched(a, b, [1.0, 0.5, 2.0],
                                                  -2.0, om, 0.1, br),
            jls.spectral_from_tridiagonal_batched(a, b, [1.0, 0.5, 2.0],
                                                  -2.0, om, 0.1, br),
            rtol=0, atol=1e-13)
    with pytest.raises(ValueError, match="unknown broadening"):
        tls.spectral_from_tridiagonal(a[0], b[0], 1.0, 0.0, om, 0.1, "box")


def test_lanczos_sqw_and_kpm_sqw_match_jax(setup):
    gs = setup["gs"]
    q = [2 * np.pi / L, np.pi / 2, np.pi]
    om = np.linspace(0, 4, 40)
    # 16 steps: before the recurrence (no reorthogonalization) loses
    # orthogonality, the two packages agree to 1e-8; at 40 steps the ghost
    # poles depend on the last bits of every dot and the broadened spectra
    # agree to 1e-5
    for m, tol in ((16, 1e-8), (40, 1e-5)):
        Sj = np.asarray(jls.lanczos_sqw(_j(gs), setup["mj"], q, om,
                                        lanc_m=m, eta=0.1))
        St = tls.lanczos_sqw(_t(gs), setup["mt"], q, om, lanc_m=m, eta=0.1)
        assert St.shape == (3, 40)
        assert np.abs(St - Sj).max() <= tol * Sj.max(), m
    a, b = tch.rescaling_params(*BOUNDS)
    for E0 in (None, setup["E0"]):
        Kj = np.asarray(jkpm.kpm_sqw(_j(gs), setup["mj"], q, om, a=a, b=b,
                                     kpm_m=64, E0=E0))
        Kt = tkpm.kpm_sqw(_t(gs), setup["mt"], q, om, a=a, b=b, kpm_m=64,
                          E0=E0, matvec=setup["mvt"])
        assert Kt.shape == (3, 40) and Kt.dtype == torch.float64
        assert np.abs(Kt.numpy() - Kj).max() <= 1e-8 * max(Kj.max(), 1.0)
    assert Kt.min() >= 0 and Kt.max() > 0
    # default rescaling: bounds from a drawn start; same physics
    Kd = tkpm.kpm_sqw(_t(gs), setup["mt"], q, om, kpm_m=64, E0=setup["E0"],
                      generator=torch.Generator().manual_seed(3))
    assert torch.isfinite(Kd).all() and Kd.max() > 0
    phi = np.asarray(sd.sz_q_vector(setup["mj"], _j(gs), np.pi,
                                    dtype=jnp.complex128))
    phi = phi / np.linalg.norm(phi)
    sj = np.asarray(jkpm.kpm_sw(_j(phi), setup["mj"], om + setup["E0"], a, b,
                                kpm_m=48))
    st = tkpm.kpm_sw(_t(phi), setup["mt"], om + setup["E0"], a, b, kpm_m=48)
    assert np.abs(st.numpy() - sj).max() <= 1e-8 * max(sj.max(), 1.0)


def test_sqw_f32_matches_jax():
    """float32 ground state through both packages' complex64 path."""
    mj, mt = _models(f64=False)
    mask = np.asarray(mj.valid_mask())
    H = pt.build_dense_H(mt)
    ev, U = np.linalg.eigh(H[np.ix_(mask, mask)])
    gs = np.zeros(1 << L, np.float32)
    gs[mask] = U[:, 0]
    q, om = [np.pi / 2, np.pi], np.linspace(0, 4, 30)
    # The Lanczos coefficients are an ill-conditioned function of the
    # start vector (the nodes and weights of a Gauss quadrature): float32
    # rounding differences of 1e-7 between the packages' dots reach 1e-4 of
    # max S after 8 steps (the float64 run above agrees to 1e-8, so the
    # recurrences are the same); the KPM moments below are a stable
    # recurrence and hold 1e-5
    Sj = np.asarray(jls.lanczos_sqw(_j(gs), mj, q, om, lanc_m=8, eta=0.1,
                                    backend="blocked"))
    St = tls.lanczos_sqw(_t(gs), mt, q, om, lanc_m=8, eta=0.1)
    assert np.abs(St - Sj).max() <= 1e-3 * Sj.max()
    a, b = tch.rescaling_params(*BOUNDS)
    Kj = np.asarray(jkpm.kpm_sqw(_j(gs), mj, q, om, a=a, b=b, kpm_m=48,
                                 E0=float(ev[0]), backend="blocked"))
    Kt = tkpm.kpm_sqw(_t(gs), mt, q, om, a=a, b=b, kpm_m=48, E0=float(ev[0]))
    assert Kt.dtype == torch.float32
    assert np.abs(Kt.numpy() - Kj).max() <= 1e-5 * max(Kj.max(), 1.0)


def test_kpm_dynamical_family_matches_jax():
    Ls = 6
    mj, mt = _models(L=Ls, nup=None)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(1 << Ls) + 1j * rng.standard_normal(1 << Ls)
    x = x / np.linalg.norm(x)
    om = np.linspace(-3, 3, 25)
    a, b = 6.0, 0.0
    opA, opB = sd.make_spin_operator(1, "z"), sd.make_spin_operator(4, "plus")
    tA, tB = pt.make_spin_operator(1, "z"), pt.make_spin_operator(4, "plus")
    Sj = np.asarray(jkpm.kpm_dynamical_correlation(_j(x), opA, opB, om, mj,
                                                   n=40, a=a, b=b))
    St = tkpm.kpm_dynamical_correlation(_t(x), tA, tB, om, mt, n=40, a=a,
                                        b=b)
    assert np.abs(St.numpy() - Sj).max() <= 1e-8 * max(Sj.max(), 1.0)
    for kinds in (("z", "z"), ("minus", "plus")):
        Cj = np.asarray(jkpm.kpm_correlation_matrix(
            _j(x), om, mj, n=24, opA_kind=kinds[0], opB_kind=kinds[1], a=a,
            b=b))
        Ct = tkpm.kpm_correlation_matrix(
            _t(x), om, mt, n=24, opA_kind=kinds[0], opB_kind=kinds[1], a=a,
            b=b)
        assert Ct.shape == (Ls, Ls, 25)
        assert np.abs(Ct.numpy() - Cj).max() <= 1e-8 * max(Cj.max(), 1.0)
    sj = np.asarray(jkpm.kpm_structure_factor(_j(Cj), 0.7, np.arange(Ls)))
    st = tkpm.kpm_structure_factor(Ct, 0.7, np.arange(Ls))
    assert np.abs(st.numpy() - sj).max() <= 1e-10 * max(np.abs(sj).max(), 1)
    # the wrapper: domain-wall start in complex64 in both packages
    mj32, mt32 = _models(f64=False, L=Ls, nup=3)
    with jax.default_matmul_precision("highest"):
        Rj = np.asarray(jkpm.kpm_correlation_matrix(
            sd.domain_wall_state(mj32, dtype=jnp.complex64), om, mj32, n=20,
            a=a, b=b, backend="blocked"))
    Rt = tkpm.run_kpm_dynamical(mt32, om, n=20, device="cpu", a=a, b=b)
    assert Rt.dtype == torch.float32
    assert np.abs(Rt.numpy() - Rj).max() <= 1e-5 * max(Rj.max(), 1.0)


# ---- runners ---------------------------------------------------------------


def test_evolve_trajectory_matches_jax(setup):
    mj, mt = setup["mj"], setup["mt"]
    x0 = np.asarray(sd.domain_wall_state(mj, dtype=jnp.complex128))
    kw = dict(dt=0.2, n_steps=4, cheb_n=30, Ebounds=BOUNDS)
    pj, oj = jru.evolve_trajectory(mj, _j(x0), **kw)
    ptt, ot = pt.evolve_trajectory(mt, _t(x0), **kw)
    assert ot.shape == (4, L) and ptt.dtype == torch.complex128
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-12)
    assert np.abs(state_to_numpy(ptt) - np.asarray(pj)).max() <= 1e-12
    assert np.abs(ot.sum(axis=1)).max() <= 1e-12  # Sz=0 is conserved
    pj, oj = jru.evolve_trajectory(mj, _j(x0), 0.2, 3, method="krylov",
                                   kry_m=20)
    ptt, ot2 = pt.evolve_trajectory(mt, _t(x0), 0.2, 3, method="krylov",
                                    kry_m=20)
    np.testing.assert_allclose(ot2, oj, rtol=0, atol=1e-8)
    np.testing.assert_allclose(ot2, ot[:3], rtol=0, atol=1e-8)
    # a custom observable, a real float32 start, bounds drawn by the port
    _, o = pt.evolve_trajectory(
        mt, pt.neel_state(mt, dtype=torch.float32, device="cpu"), 0.1, 2,
        observe=lambda p, m: pt.szsz_matrix(p, m)[0],
        generator=torch.Generator().manual_seed(0))
    assert o.shape == (2, L, L) and o.dtype == np.float32
    with pytest.raises(ValueError, match="unknown method"):
        pt.evolve_trajectory(mt, _t(x0), 0.1, 1, method="euler")


def test_run_chebyshev_and_run_krylov_match_jax():
    """Both wrappers start from the domain wall in complex64. The
    Chebyshev bounds come from each package's own random start (a key
    there, a generator here); at cheb_n=50 and dt=0.2 the expansion is
    converged for any bounds that contain the spectrum, so the observables
    agree at float32 rounding."""
    mj, mt = _models(f64=False)
    mags_j, (qj, sj), bj = jru.run_chebyshev(mj, 0.2, backend="blocked")
    mags_t, (qt, st), bt = pt.run_chebyshev(
        mt, 0.2, device="cpu", generator=torch.Generator().manual_seed(1))
    assert mags_t.dtype == torch.float32
    np.testing.assert_allclose(mags_t.numpy(), np.asarray(mags_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=1e-6)
    assert abs(bt[0] - bj[0]) < 0.5 and abs(bt[1] - bj[1]) < 0.5
    mags_j, (_, sj) = jru.run_krylov(mj, 0.2, backend="blocked")
    mags_k, (_, sk) = pt.run_krylov(mt, 0.2, device="cpu")
    np.testing.assert_allclose(mags_k.numpy(), np.asarray(mags_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(sk.numpy(), np.asarray(sj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(mags_k.numpy(), mags_t.numpy(), rtol=0,
                               atol=1e-5)
