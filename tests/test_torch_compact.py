"""The compact sector layout of the port against the JAX package's default
layout (mode "sector") on the CPU: the combinadic rank and unrank, the
states, the ELL table (host build, torch build, JAX), the diagonal, the
ell apply, the dense matrix, the spin operators, the initial states, the
observables, and every flat solver and runner once on a compact model;
then compact against embedded on the same couplings.

Tolerances: tables and states exactly equal; float64 values to 1e-12 (an
apply, a diagonal) and 1e-9 along a Krylov recurrence (the two packages
sum the bonds and the dots in other orders); float32 1e-6 of max|y| for
one apply and 1e-5 through tens of steps. Inputs are made with numpy from
a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu import basis as jb
from spindynamics_tpu import model as jmodel
from spindynamics_tpu import observables as jobs
from spindynamics_tpu.solvers import chebyshev as jch
from spindynamics_tpu.solvers import kpm as jkpm
from spindynamics_tpu.solvers import lanczos as jla
from spindynamics_tpu.solvers import runners as jru
from spindynamics_tpu_torch import basis as tb
from spindynamics_tpu_torch import model as tmodel
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


def _lr(i, j):
    return 0.7 / (j - i) ** 1.5


def _pair(kind="xxz", L=L, nup=NUP, f64=True):
    """The same compact model built by both packages: the XXZ chain with a
    non-uniform field, an all-pairs long-range model, or a model without
    bonds."""
    dt = jnp.float64 if f64 else jnp.float32
    fld = np.linspace(-0.3, 0.2, L)
    if kind == "xxz":
        hop, zz = sd.nn_hopping(L, 1.0), [(i, i + 1, 0.5) for i in range(L - 1)]
    elif kind == "longrange":
        hop = sd.long_range_hopping(L, _lr)
        zz = sd.long_range_hopping(L, lambda i, j: 0.3 / (j - i) ** 2)
    else:
        hop, zz = [], [(i, i + 1, 0.5) for i in range(L - 1)]
    mj = sd.build_model(L, nup=nup, hopping=hop, onsite_field=fld, zz=zz,
                        dtype=dt)
    mt = model_from_numpy(mj.L, mj.nup, mj.hop_sites, np.asarray(mj.hop_J),
                          np.asarray(mj.field), mj.zz_sites,
                          np.asarray(mj.zz_J), layout="compact")
    return mj, mt


def _j(x, dtype=None):
    return jnp.asarray(x, dtype)


def _t(x, dtype=None):
    return state_from_numpy(x, "cpu", dtype=dtype)


def _align(a, b):
    ph = np.vdot(b, a)
    return b * (ph / abs(ph))


@pytest.fixture(scope="module")
def setup():
    mj, mt = _pair()
    rng = np.random.default_rng(21)
    N = mj.n_states
    v = rng.standard_normal(N)
    vc = rng.standard_normal(N) + 1j * rng.standard_normal(N)
    H = sd.build_dense_H(mj)
    evals, evecs = np.linalg.eigh(H)
    return dict(mj=mj, mt=mt, v=v, vc=vc, E0=float(evals[0]),
                gs=evecs[:, 0], mvj=sd.matvec_fn(mj),
                mvt=pt.matvec_fn(mt, device="cpu"))


# ---- basis: rank and unrank --------------------------------------------------


@pytest.mark.parametrize("L_,nup", [(1, 0), (1, 1), (6, 0), (6, 6), (8, 3),
                                    (10, 5), (13, 4), (16, 8)])
def test_rank_unrank_match_jax(L_, nup):
    states = jb.build_sector_basis(L_, nup)
    binom = jb.binomial_table(L_, nup)
    st = torch.as_tensor(states.astype(np.int64))
    r_t = tb.rank_states(st, L_, tb.binomial_table(L_, nup))
    r_j = np.asarray(jb.rank_states(states, L_, binom))
    assert r_t.dtype == torch.int64
    np.testing.assert_array_equal(r_t.numpy(), r_j)
    np.testing.assert_array_equal(r_t.numpy(), np.arange(len(states)))
    idx = np.arange(len(states))
    u_t = tb.unrank_states(torch.as_tensor(idx), L_, nup, binom)
    np.testing.assert_array_equal(
        u_t.numpy(), np.asarray(jb.unrank_states(idx, L_, nup, binom)))
    np.testing.assert_array_equal(u_t.numpy(), states.astype(np.int64))
    for i in idx[:: max(1, len(idx) // 17)]:
        assert tb.unrank(int(i), L_, nup) == jb.unrank(int(i), L_, nup) == \
            int(states[i])
        assert tb.rank_state(int(states[i]), L_, nup) == i


def test_rank_at_32_bits():
    """States with bit 31 set stay int64 and rank exactly (L = 32)."""
    s = torch.tensor([(1 << 31) | 0b111, (1 << 32) - (1 << 28)],
                     dtype=torch.int64)
    B = tb.binomial_table(32, 4)
    r = tb.rank_states(s, 32, B)
    assert r.tolist() == [tb.rank_state(int(x), 32, 4) for x in s]
    back = tb.unrank_states(r, 32, 4, B)
    assert torch.equal(back, s)


# ---- model: states, table, diagonal ------------------------------------------


@pytest.mark.parametrize("kind,L_,nup", [("xxz", 10, 5), ("longrange", 9, 4),
                                         ("xxz", 12, 3), ("nobonds", 8, 4)])
def test_states_tables_and_diag_match_jax(kind, L_, nup):
    """Host build, torch build (on the CPU here, the card's route) and the
    JAX package's builds give the same states and ELL table exactly; the
    diagonals agree to 1e-12."""
    mj, mt = _pair(kind, L_, nup)
    assert mt.mode == "compact" and mt.neighbor_table
    assert mt.n_states == mj.n_states and mt.valid_mask() is None
    s_h, d_h, t_h = tmodel.sector_setup(mt, "cpu")
    s_t, d_t, t_t = tmodel._device_sector_setup(mt, "cpu", torch.float64,
                                                True)
    states_j = np.asarray(mj.states)
    np.testing.assert_array_equal(s_h.numpy(), states_j)
    assert torch.equal(s_h, s_t) and torch.equal(mt.basis_states(), s_h)
    tab_j = jmodel._build_ell_table(states_j, np.asarray(mj.hop_i),
                                    np.asarray(mj.hop_j))
    assert t_h.dtype == t_t.dtype == torch.int32
    np.testing.assert_array_equal(t_h.numpy(), tab_j)
    assert torch.equal(t_h, t_t)
    if mj.nbr is not None:
        np.testing.assert_array_equal(t_h.numpy(), np.asarray(mj.nbr))
    np.testing.assert_allclose(d_h.numpy(), np.asarray(mj.diag), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(mj.diag), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(mt.diag("cpu").numpy(), np.asarray(mj.diag),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tmodel._compute_diag(states_j.astype(np.int64), np.asarray(mj.field),
                             np.asarray(mj.zz_i), np.asarray(mj.zz_j),
                             np.asarray(mj.zz_J), np.float64),
        jmodel._compute_diag(states_j, np.asarray(mj.field),
                             np.asarray(mj.zz_i), np.asarray(mj.zz_j),
                             np.asarray(mj.zz_J), np.float64),
        rtol=0, atol=0)


def test_compact_layout_rules():
    hop = [(0, 1, 1.0), (1, 2, 1.0)]
    m = pt.build_model(6, nup=3, hopping=hop, layout="compact")
    assert m.mode == "compact" and m.n_states == 20 and m.neighbor_table
    assert pt.build_model(6, nup=3, hopping=hop, layout="compact",
                          build_neighbor_table=False).neighbor_table is False
    full = pt.build_model(6, hopping=hop, build_neighbor_table=True)
    assert full.mode == "full" and full.neighbor_table
    assert not pt.build_model(6, hopping=hop).neighbor_table
    assert pt.xxz_chain(8, nup=4, layout="compact").mode == "compact"
    with pytest.raises(ValueError, match="build_neighbor_table"):
        pt.build_model(6, nup=3, hopping=hop, layout="embedded",
                       build_neighbor_table=True)
    with pytest.raises(ValueError, match="nup must be"):
        pt.build_model(6, nup=7, hopping=hop, layout="compact")
    with pytest.raises(ValueError, match="sector_setup"):
        tmodel.sector_setup(pt.build_model(6, nup=3, hopping=hop,
                                           layout="embedded"), "cpu")


# ---- the ell apply -----------------------------------------------------------


@pytest.mark.parametrize("kind", ["xxz", "longrange", "nobonds"])
@pytest.mark.parametrize("f64", [True, False], ids=["f64", "f32"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_apply_H_ell_matches_jax(kind, f64, cplx):
    """float64 1e-12 and float32 1e-6 of max|y| (the bonds are summed in
    another order); row chunks smaller than N give the same values, to
    the BLAS's rounding (its gemv blocks by the row count)."""
    mj, mt = _pair(kind, 9 if kind == "longrange" else L,
                   4 if kind == "longrange" else NUP, f64)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(mj.n_states)
    if cplx:
        x = x + 1j * rng.standard_normal(mj.n_states)
    x = x.astype({(True, False): np.float64, (True, True): np.complex128,
                  (False, False): np.float32,
                  (False, True): np.complex64}[(f64, cplx)])
    yj = np.asarray(sd.apply_H(jnp.asarray(x), mj))
    yt = pt.apply_H(_t(x), mt)
    assert yt.dtype == _t(x).dtype
    tol = (1e-12 if f64 else 1e-6) * np.abs(yj).max()
    assert np.abs(state_to_numpy(yt) - yj).max() <= tol
    yf = pt.apply_H_ell(_t(x), mt, chunk=7)
    assert (yf - yt).abs().max() <= tol
    mv = pt.matvec_fn(mt, device="cpu")
    assert mv.backend == "ell" and torch.equal(mv(_t(x)), yt)


def test_full_model_with_table_routes_to_ell():
    """A full model built with build_neighbor_table=True is applied by
    'ell' (as in the JAX package); its table is the XOR partner and the
    apply equals the dense matrix's."""
    Lf = 7
    fld = np.linspace(-0.2, 0.3, Lf)
    mj = sd.build_model(Lf, hopping=sd.nn_hopping(Lf, 0.8),
                        onsite_field=fld, zz=[(0, 3, 0.4), (2, 5, -0.3)],
                        dtype=jnp.float64, build_neighbor_table=True)
    mt = pt.build_model(Lf, hopping=pt.nn_hopping(Lf, 0.8), onsite_field=fld,
                        zz=[(0, 3, 0.4), (2, 5, -0.3)], dtype=torch.float64,
                        build_neighbor_table=True)
    _, _, t = tmodel.sector_setup(mt, "cpu")
    np.testing.assert_array_equal(t.numpy(), np.asarray(mj.nbr))
    _, _, t2 = tmodel._device_sector_setup(mt, "cpu", torch.float64, True)
    assert torch.equal(t, t2)
    mv = pt.matvec_fn(mt, device="cpu")
    assert mv.backend == "ell"
    x = np.random.default_rng(5).standard_normal(1 << Lf)
    H = pt.build_dense_H(mt)
    np.testing.assert_allclose(H, sd.build_dense_H(mj), rtol=0, atol=0)
    for y in (mv(_t(x)), pt.apply_H(_t(x), mt)):
        assert np.abs(y.numpy() - H @ x).max() <= 1e-12
    assert np.abs(np.asarray(sd.apply_H(_j(x), mj)) - H @ x).max() <= 1e-12


def test_ell_refusals():
    m = pt.build_model(6, nup=3, hopping=[(0, 1, 1.0)], layout="compact",
                       build_neighbor_table=False)
    x = torch.ones(20, dtype=torch.float64)
    with pytest.raises(ValueError, match="no ELL neighbour table"):
        pt.apply_H(x, m)
    with pytest.raises(ValueError, match="no ELL neighbour table"):
        pt.matvec_fn(m, device="cpu")
    mc = pt.build_model(6, nup=3, hopping=[(0, 1, 1.0)], layout="compact")
    for backend in ("blocked", "fused"):
        with pytest.raises(ValueError, match="compact model takes"):
            pt.apply_H(x.float(), mc, backend=backend)
        with pytest.raises(ValueError, match="compact model takes"):
            pt.matvec_fn(mc, backend=backend, device="cpu")
    # a model without bonds needs no table
    m0 = pt.build_model(6, nup=3, zz=[(0, 1, 1.0)], layout="compact",
                        build_neighbor_table=False)
    y = pt.apply_H(x, m0)
    assert torch.equal(y, x * m0.diag("cpu", torch.float64))


def test_dense_H_and_module_move(setup):
    """build_dense_H of a compact model equals the JAX package's; an ell
    FlatHamiltonian registers states, diagonal and table as buffers, so
    .to() moves them, and a dense module on a compact model agrees."""
    mj, mt = setup["mj"], setup["mt"]
    H = pt.build_dense_H(mt)
    np.testing.assert_allclose(H, sd.build_dense_H(mj), rtol=0, atol=0)
    mv = pt.FlatHamiltonian(mt, device="cpu")
    names = {n for n, _ in mv.named_buffers()}
    assert {"states", "diag", "nbr"} <= names
    assert mv.nbr.shape == (mt.n_states, mt.n_bonds)
    assert mv.state_dict() == {}  # non-persistent
    moved = mv.to(torch.device("meta"))
    assert moved.nbr.device.type == "meta" and moved.device.type == "meta"
    mv = pt.FlatHamiltonian(mt, device="cpu")
    x = _t(setup["vc"])
    yd = pt.FlatHamiltonian(mt, backend="dense", device="cpu")(x)
    assert (mv(x) - yd).abs().max() <= 1e-12 * yd.abs().max()
    # a float32 state through a float64 module: the diagonal and couplings
    # are cast to the state's dtype, as in the JAX package
    y32 = mv(x.to(torch.complex64))
    assert y32.dtype == torch.complex64
    assert (y32 - yd).abs().max() <= 1e-6 * yd.abs().max()


# ---- spin operators, initial states, observables ----------------------------


@pytest.mark.parametrize("kind", ["z", "plus", "minus", "x", "y"])
def test_spin_operators_match_jax(setup, kind):
    mj, mt = setup["mj"], setup["mt"]
    x = setup["vc"]
    for site in (0, 3, L - 1):
        oj = np.asarray(sd.apply_spin_operator(_j(x), mj, site, kind))
        ot = pt.apply_spin_operator(_t(x), mt, site, kind)
        assert ot.dtype == _t(oj).dtype
        np.testing.assert_allclose(state_to_numpy(ot), oj, rtol=0,
                                   atol=1e-15)
    wj = np.asarray(sd.sz_q_weights(mj, 0.9, dtype=jnp.complex128))
    wt = pt.sz_q_weights(mt, 0.9, dtype=torch.complex128)
    np.testing.assert_allclose(wt.numpy(), wj, rtol=0, atol=1e-14)
    np.testing.assert_allclose(
        pt.sz_q_vector(mt, _t(x), 0.9, dtype=torch.complex128).numpy(),
        np.asarray(sd.sz_q_vector(mj, _j(x), 0.9, dtype=jnp.complex128)),
        rtol=0, atol=1e-14)


def test_initial_states_match_jax(setup):
    mj, mt = setup["mj"], setup["mt"]
    for f_t, f_j in ((pt.domain_wall_state, sd.domain_wall_state),
                     (pt.neel_state, sd.neel_state)):
        a = f_t(mt, dtype=torch.float64, device="cpu")
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(f_j(mj, dtype=jnp.float64)))
    bits = 0b1011000110
    assert pt.state_index(mt, bits) == sd.state_index(mj, bits)
    flips = [1, 3, 4, 6, 9]
    np.testing.assert_array_equal(
        pt.polarized_state_with_flips(mt, flips, dtype=torch.float64,
                                      device="cpu").numpy(),
        np.asarray(sd.polarized_state_with_flips(mj, flips,
                                                 dtype=jnp.float64)))
    with pytest.raises(ValueError, match="wrong magnetization"):
        pt.state_index(mt, 0b111)
    with pytest.raises(ValueError, match="wrong magnetization"):
        pt.polarized_state(mt, device="cpu")


def test_observables_match_jax(setup):
    mj, mt = setup["mj"], setup["mt"]
    x = setup["vc"] / np.linalg.norm(setup["vc"])
    for ft, fj in ((pt.magnetization_per_site, sd.magnetization_per_site),
                   (pt.connected_correlations, sd.connected_correlations)):
        np.testing.assert_allclose(ft(_t(x), mt).numpy(),
                                   np.asarray(fj(_j(x), mj)), rtol=0,
                                   atol=1e-14)
    zt, st_ = pt.szsz_matrix(_t(x), mt, chunk=37)
    zj, sj = jobs.szsz_matrix(_j(x), mj)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-14)
    np.testing.assert_allclose(st_.numpy(), np.asarray(sj), atol=1e-14)
    qt, Sq_t = pt.structure_factor_Sq(_t(x), mt)
    qj, Sq_j = sd.structure_factor_Sq(_j(x), mj)
    np.testing.assert_allclose(Sq_t.numpy(), np.asarray(Sq_j), atol=1e-13)
    dt_ = pt.structure_factor_Sq_dict(_t(x), mt)
    assert len(dt_) == L


# ---- the flat solvers and runners on a compact model ------------------------


def test_groundstate_matches_jax(setup):
    v = setup["v"]
    Ej, pj, _ = jla.lanczos_groundstate(setup["mvj"], None, lanc_m=60,
                                        dtype=jnp.float64, v0=_j(v))
    Et, ptt, it = pt.lanczos_groundstate(setup["mvt"], None, lanc_m=60,
                                         dtype=torch.float64, v0=_t(v))
    assert abs(Et - Ej) <= 1e-9 and abs(Et - setup["E0"]) <= 1e-9
    assert np.abs(_align(np.asarray(pj), state_to_numpy(ptt))
                  - np.asarray(pj)).max() <= 1e-8
    kw = dict(lanc_m=20, cycles=8, target_residual=1e-9)
    Ej, pj, ij = jla.lanczos_groundstate_restarted(
        setup["mvj"], setup["mj"].n_states, dtype=jnp.float64, v0=_j(v),
        **kw)
    Et, ptt, it = pt.lanczos_groundstate_restarted(setup["mvt"], _t(v), **kw)
    assert abs(Et - Ej) <= 1e-9 and it["cycles"] == ij["cycles"]
    assert it["residual"] <= 1e-9


def test_sqw_match_jax(setup):
    gs = setup["gs"]
    q = [2 * np.pi / L, np.pi]
    om = np.linspace(0, 4, 30)
    Sj = np.asarray(sd.lanczos_sqw(_j(gs), setup["mj"], q, om, lanc_m=16,
                                   eta=0.1))
    St = pt.lanczos_sqw(_t(gs), setup["mt"], q, om, lanc_m=16, eta=0.1)
    assert np.abs(St - Sj).max() <= 1e-8 * Sj.max()
    a, b = pt.rescaling_params(*BOUNDS)
    Kj = np.asarray(sd.kpm_sqw(_j(gs), setup["mj"], q, om, a=a, b=b,
                               kpm_m=64, E0=setup["E0"]))
    Kt = pt.kpm_sqw(_t(gs), setup["mt"], q, om, a=a, b=b, kpm_m=64,
                    E0=setup["E0"], matvec=setup["mvt"])
    assert np.abs(Kt.numpy() - Kj).max() <= 1e-8 * max(Kj.max(), 1.0)


def test_kpm_correlation_matrix_matches_jax():
    mj, mt = _pair(L=8, nup=4)
    x = np.random.default_rng(6).standard_normal(mj.n_states) + 0j
    x = x / np.linalg.norm(x)
    om = np.linspace(-3, 3, 21)
    for kinds in (("z", "z"), ("z", "plus")):
        Cj = np.asarray(jkpm.kpm_correlation_matrix(
            _j(x), om, mj, n=20, opA_kind=kinds[0], opB_kind=kinds[1],
            a=6.0, b=0.0))
        Ct = pt.kpm_correlation_matrix(_t(x), om, mt, n=20,
                                       opA_kind=kinds[0], opB_kind=kinds[1],
                                       a=6.0, b=0.0)
        assert Ct.shape == (8, 8, 21)
        assert np.abs(Ct.numpy() - Cj).max() <= 1e-8 * max(Cj.max(), 1.0)


@pytest.mark.parametrize("method", ["chebyshev", "krylov"])
def test_evolve_trajectory_matches_jax(setup, method):
    mj, mt = setup["mj"], setup["mt"]
    x0 = np.asarray(sd.domain_wall_state(mj, dtype=jnp.complex128))
    kw = (dict(cheb_n=30, Ebounds=BOUNDS) if method == "chebyshev"
          else dict(kry_m=20))
    pj, oj = jru.evolve_trajectory(mj, _j(x0), 0.2, 3, method=method, **kw)
    ptt, ot = pt.evolve_trajectory(mt, _t(x0), 0.2, 3, method=method, **kw)
    tol = 1e-12 if method == "chebyshev" else 1e-8
    np.testing.assert_allclose(ot, oj, rtol=0, atol=tol)
    assert np.abs(state_to_numpy(ptt) - np.asarray(pj)).max() <= tol


def test_run_chebyshev_and_run_krylov_match_jax():
    """Each package draws its own bounds start; at cheb_n=50 and dt=0.2 the
    expansion is converged for any bounds that contain the spectrum."""
    mj, mt = _pair(f64=False)
    mags_j, (_, sj), _ = jru.run_chebyshev(mj, 0.2)
    mags_t, (_, st), _ = pt.run_chebyshev(
        mt, 0.2, device="cpu", generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(mags_t.numpy(), np.asarray(mags_j), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)
    mags_j, (_, sj) = jru.run_krylov(mj, 0.2)
    mags_k, (_, sk) = pt.run_krylov(mt, 0.2, device="cpu")
    np.testing.assert_allclose(mags_k.numpy(), np.asarray(mags_j), rtol=0,
                               atol=1e-5)


def test_chebyshev_f32_matches_jax():
    mj, mt = _pair(f64=False)
    x = np.asarray(sd.domain_wall_state(mj, dtype=jnp.complex64))
    oj = np.asarray(jch.chebyshev_time_evolve(_j(x), sd.matvec_fn(mj), 0.2,
                                              BOUNDS, cheb_n=30))
    ot = pt.chebyshev_time_evolve(_t(x), pt.matvec_fn(mt, device="cpu"),
                                  0.2, BOUNDS, cheb_n=30)
    assert ot.dtype == torch.complex64
    assert np.abs(state_to_numpy(ot) - oj).max() <= 1e-5


# ---- compact against embedded ----------------------------------------------


def test_compact_matches_embedded():
    """The same couplings on the compact and the embedded layouts: the
    applies agree on the sector's rows, and so do the ground state, a
    trajectory and the observables."""
    kw = dict(hopping=pt.nn_hopping(L, 1.0),
              onsite_field=np.linspace(-0.3, 0.2, L),
              zz=[(i, i + 1, 0.5) for i in range(L - 1)],
              dtype=torch.float64)
    mc = pt.build_model(L, nup=NUP, layout="compact", **kw)
    me = pt.build_model(L, nup=NUP, layout="embedded", **kw)
    states = mc.basis_states()
    assert torch.equal(states, torch.nonzero(me.valid_mask())[:, 0])
    x = np.random.default_rng(8).standard_normal(mc.n_states)
    xe = torch.zeros(me.n_states, dtype=torch.float64)
    xe[states] = _t(x)
    yc = pt.apply_H(_t(x), mc)
    ye = pt.apply_H(xe, me)
    assert (ye[states] - yc).abs().max() <= 1e-12 * yc.abs().max()
    Ec, _, _ = pt.lanczos_groundstate(pt.matvec_fn(mc, device="cpu"), None,
                                      lanc_m=60, dtype=torch.float64,
                                      v0=_t(x))
    Ee, _, _ = pt.lanczos_groundstate(pt.matvec_fn(me, device="cpu"), None,
                                      lanc_m=60, dtype=torch.float64,
                                      v0=xe.clone())
    assert abs(Ec - Ee) <= 1e-9
    kw_t = dict(dt=0.2, n_steps=3, cheb_n=30, Ebounds=BOUNDS)
    _, oc = pt.evolve_trajectory(mc, pt.domain_wall_state(
        mc, dtype=torch.complex128, device="cpu"), **kw_t)
    _, oe = pt.evolve_trajectory(me, pt.domain_wall_state(
        me, dtype=torch.complex128, device="cpu"), **kw_t)
    np.testing.assert_allclose(oc, oe, rtol=0, atol=1e-12)
