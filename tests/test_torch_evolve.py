"""The port's kron time evolution against the JAX package, from the same
numpy-made inputs at L <= 12: Chebyshev coefficients, initial-state
bitstrings, magnetization and Sz apply, pair dots, the planes apply on
zero-imaginary and complex starts, the plain Chebyshev step, the
trajectory, energy bounds, Krylov and imaginary time, the pair Lanczos and
quantum typicality; and the chip smoke's exact-evolution oracle. The K2
route and K2's emulation are in tests/test_torch_cheb_term.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu import observables_kron as jok
from spindynamics_tpu.models import initial_states as jis
from spindynamics_tpu.ops import sector_kron as jsk
from spindynamics_tpu.solvers import chebyshev as jch
from spindynamics_tpu.solvers import kron_evolve as jke
from spindynamics_tpu.solvers.blockvec import BlockVec as JBV
from spindynamics_tpu_torch import observables_kron as tok
from spindynamics_tpu_torch.models import initial_states as tis
from spindynamics_tpu_torch.ops import sector_kron as tsk
from spindynamics_tpu_torch.solvers import chebyshev as tch
from spindynamics_tpu_torch.solvers import kron_evolve as tke


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per test process, so
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(L, Jz=0.5, field=True, splits=None, jdtype=jnp.float32,
            tdtype=torch.float32):
    fld = np.linspace(-0.1, 0.2, L) if field else None
    kw = dict(Jxy=1.0, Jz=Jz, h=fld, nup=L // 2, kron_splits=splits)
    mj = sd.xxz_chain(L, dtype=jdtype, layout="sector_kron", **kw)
    mt = pt.xxz_chain(L, dtype=tdtype, **kw)
    return (mj, jsk.make_sector_kron_layout(mj, mj.kron_splits),
            mt, tsk.make_sector_kron_layout(mt, mt.kron_splits))


def _leaves(lay, rng):
    """Numpy-made random per-group leaves, zero on the tile-pad slots."""
    out = []
    for (_, _, _, ch, cm, cl, cmp, clp) in lay.groups:
        x = np.zeros((ch, cmp, clp))
        x[:, :cm, :cl] = rng.standard_normal((ch, cm, cl))
        out.append(x)
    return out


def _pair(lay, seed, zero_im=False):
    """A normalized (re, im) pair as numpy leaves."""
    rng = np.random.default_rng(seed)
    re = _leaves(lay, rng)
    im = [np.zeros_like(x) for x in re] if zero_im else _leaves(lay, rng)
    n = np.sqrt(sum(float((x * x).sum()) for x in re + im))
    return [x / n for x in re], [x / n for x in im]


def _jpair(p, dtype=jnp.float32):
    return tuple(JBV([jnp.asarray(x, dtype) for x in plane]) for plane in p)


def _tpair(p, dtype=torch.float32):
    return tuple(pt.BlockVec([torch.tensor(x, dtype=dtype) for x in plane])
                 for plane in p)


def _maxdiff(pj, ptp):
    return max(float(np.abs(np.asarray(a, np.float64)
                            - b.double().numpy()).max())
               for P, Q in zip(pj, ptp) for a, b in zip(P.leaves, Q.leaves))


@pytest.mark.parametrize("dt,lo,hi,n", [(0.1, -9.0, 9.0, 40),
                                        (0.37, -3.2, 11.5, 17)])
def test_chebyshev_coefficients_match_jax(dt, lo, hi, n):
    cj, aj, bj = jch.chebyshev_coefficients(dt, lo, hi, n)
    ct, at, bt = tch.chebyshev_coefficients(dt, lo, hi, n)
    assert ct.dtype == np.complex128 and np.array_equal(ct, cj)
    assert (at, bt) == (aj, bj)


@pytest.mark.parametrize("L", [8, 11])
def test_bitstrings_match_jax(L):
    mj, _, mt, _ = _models(L, field=False)
    assert tis.domain_wall_bitstring(mt) == jis.domain_wall_bitstring(mj)
    assert tis.neel_bitstring(mt) == jis.neel_bitstring(mj)
    for up in (True, False):
        assert (tis.polarized_bitstring(mt, up)
                == jis.polarized_bitstring(mj, up))


def test_magnetization_and_apply_sz_match_jax_f64():
    mj, lj, mt, lt = _models(12, splits=(5, 4, 3), jdtype=jnp.float64,
                             tdtype=torch.float64)
    p = _pair(lj, 1)
    pj, ptp = _jpair(p, jnp.float64), _tpair(p, torch.float64)
    for xj, xt in ((pj[0], ptp[0]), (pj, ptp)):  # one plane, then a pair
        mj_ = np.asarray(jok.magnetization_per_site_kron(xj, lj))
        mt_ = tok.magnetization_per_site_kron(xt, lt)
        assert mt_.dtype == torch.float64 and mt_.shape == (12,)
        np.testing.assert_allclose(mt_.numpy(), mj_, rtol=0, atol=1e-13)
    for site in (0, 4, 5, 8, 9, 11):  # every part, both ends of each
        a = jok.bv_apply_sz(pj[1], lj, site)
        b = tok.bv_apply_sz(ptp[1], lt, site)
        for x, y in zip(a.leaves, b.leaves):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0,
                                       atol=1e-15)


def test_pair_dot_and_norm2_match_jax_f32():
    _, lj, _, lt = _models(12)
    x, y = _pair(lj, 2), _pair(lj, 3)
    xj, yj, xt, yt = _jpair(x), _jpair(y), _tpair(x), _tpair(y)
    for a, b in zip(jke.pair_dot(xj, yj), tke.pair_dot(xt, yt)):
        assert b.dtype == torch.float32
        assert abs(float(b) - float(a)) <= 2e-7
    assert abs(float(tke.pair_norm2(xt)) - float(jke.pair_norm2(xj))) <= 2e-7
    # the compensated sums are within float32 rounding of the exact value
    exact = sum(float((u * v).sum()) for u, v in zip(x[0] + x[1],
                                                     y[0] + y[1]))
    assert abs(float(tke.pair_dot(xt, yt)[0]) - exact) <= 1e-7


@pytest.mark.parametrize("zero_im", [True, False], ids=["real", "complex"])
def test_planes_apply_matches_jax(zero_im):
    """The reused pieces on this slice's inputs (a zero imaginary plane, a
    complex start): KronHamiltonian through KronPlanes, with K1's plain
    version and the plain apply, and BlockVec arithmetic on pairs."""
    _, lj, _, lt = _models(12, splits=(5, 4, 3))
    p = _pair(lj, 4, zero_im=zero_im)
    pj, ptp = _jpair(p), _tpair(p)
    hj = jke.kron_planes_matvec_fn(lj, fused=False)(pj)
    scale = max(float(np.abs(np.asarray(x)).max()) for P in hj
                for x in P.leaves)
    for fused in (True, False):
        planes = tke.kron_planes_matvec_fn(lt, device="cpu", fused=fused)
        assert planes.cheb_fused == fused
        ht = planes(ptp)
        assert _maxdiff(hj, ht) <= 5e-6 * scale
        if zero_im:
            assert not any(x.any() for x in ht[1].leaves)
    s = 0.37
    wj = (hj[0] - pj[0] * s, hj[1] - pj[1] * s)
    wt = (ht[0] - ptp[0] * s, ht[1] - ptp[1] * s)
    assert _maxdiff(wj, wt) <= 5e-6 * scale


@pytest.mark.parametrize("zero_im", [True, False], ids=["real", "complex"])
def test_plain_cheb_step_matches_jax_f32(monkeypatch, zero_im):
    """The plain recurrence (cheb_fused=False) against JAX's XLA scan
    (SDTPU_CHEB_FUSED=0), both float32 with float32 accumulators: the same
    math up to float32 reassociation inside the applies."""
    monkeypatch.setenv("SDTPU_CHEB_FUSED", "0")
    _, lj, _, lt = _models(10, field=False)
    p = _pair(lj, 5, zero_im=zero_im)
    Eb, n = (-8.0, 8.0), 12
    oj = jke.chebyshev_time_evolve_kron(
        _jpair(p), jke.kron_planes_matvec_fn(lj, fused=False), 0.15, Eb,
        cheb_n=n)
    planes = tke.kron_planes_matvec_fn(lt, device="cpu", cheb_fused=False)
    ot = tke.chebyshev_time_evolve_kron(_tpair(p), planes, 0.15, Eb,
                                        cheb_n=n)
    for P, Q in zip(oj, ot):
        for a, b in zip(P.leaves, Q.leaves):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-6,
                                       atol=2e-7)


def test_trajectory_matches_jax_and_conserves():
    """evolve_trajectory_kron from the domain wall with explicit bounds:
    the port's default route (K2's plain version on the CPU) against the
    JAX package's XLA route, both float32."""
    mj, lj, mt, lt = _models(10, field=False)
    kw = dict(dt=0.1, n_steps=3, cheb_n=16, Ebounds=(-9.0, 9.0))
    bits = jis.domain_wall_bitstring(mj)
    _, oj, ij = jke.evolve_trajectory_kron(mj, bits, fused=False, **kw)
    pair, ot, it = tke.evolve_trajectory_kron(
        mt, tis.domain_wall_bitstring(mt), device="cpu", **kw)
    assert ot.shape == (3, 10) and pair[0].dtype == torch.float32
    np.testing.assert_allclose(ot, oj, rtol=0, atol=2e-6)
    np.testing.assert_allclose(it["norms"], ij["norms"], rtol=0, atol=2e-6)
    assert it["Ebounds"] == (-9.0, 9.0) and len(it["step_seconds"]) == 3
    assert np.all(np.abs(ot.sum(axis=1)) < 1e-5)  # Sz = 0 sector
    assert np.all(np.abs(it["norms"] - 1.0) < 1e-5)


def test_energy_bounds_match_jax():
    _, lj, _, lt = _models(12)
    v = _leaves(lj, np.random.default_rng(6))
    bj = jke.kron_energy_bounds(lj, jke.kron_planes_matvec_fn(lj, fused=False),
                                v0=JBV([jnp.asarray(x, jnp.float32)
                                        for x in v]))
    bt = tke.kron_energy_bounds(lt,
                                tke.kron_planes_matvec_fn(lt, device="cpu"),
                                v0=pt.BlockVec([torch.tensor(
                                    x, dtype=torch.float32) for x in v]))
    np.testing.assert_allclose(bt, bj, rtol=0, atol=2e-4)
    # the default start is a seed-7 generator on the apply's device
    b7 = tke.kron_energy_bounds(
        lt, tke.kron_planes_matvec_fn(lt, device="cpu"))
    assert b7 == tke.kron_energy_bounds(
        lt, tke.kron_planes_matvec_fn(lt, device="cpu"))
    assert b7[0] < bt[0] + 0.5 and b7[1] > bt[1] - 0.5


def test_krylov_real_time_matches_jax():
    _, lj, _, lt = _models(10)
    p = _pair(lj, 7)
    oj = jke.krylov_time_evolve_kron(
        _jpair(p), jke.kron_planes_matvec_fn(lj, fused=False), 0.3, kry_m=16)
    ot = tke.krylov_time_evolve_kron(
        _tpair(p), tke.kron_planes_matvec_fn(lt, device="cpu"), 0.3, kry_m=16)
    # the JAX package solves the 16 x 16 tridiagonal in float32, the port
    # in float64: agreement at float32 resolution of the unit-norm state
    assert _maxdiff(oj, ot) <= 2e-6


@pytest.mark.parametrize("method", ["krylov", "chebyshev"])
def test_imaginary_time_matches_jax(method):
    _, lj, _, lt = _models(10)
    p = _pair(lj, 8)
    pmj = jke.kron_planes_matvec_fn(lj, fused=False)
    pmt = tke.kron_planes_matvec_fn(lt, device="cpu")
    if method == "krylov":
        oj = jke.krylov_imaginary_time_evolve_kron(_jpair(p), pmj, 0.8,
                                                   kry_m=20, renormalize=True)
        ot = tke.krylov_imaginary_time_evolve_kron(_tpair(p), pmt, 0.8,
                                                   kry_m=20, renormalize=True)
    else:
        Eb = (-7.5, 6.0)
        oj = jke.chebyshev_imaginary_time_kron(_jpair(p), pmj, 0.8, Eb)
        ot = tke.chebyshev_imaginary_time_kron(_tpair(p), pmt, 0.8, Eb)
    assert abs(float(tke.pair_norm2(ot)) - 1.0) < 1e-6
    assert _maxdiff(oj, ot) <= 2e-6


@pytest.mark.parametrize("case", ["full", "breakdown"])
def test_lanczos_tridiag_pair_matches_jax_f64(case):
    """float64 on both sides. 'breakdown': a 6-state sector (L=6, nup=1)
    with lanc_m=10, so the masking of the steps past the invariant
    subspace is compared too."""
    if case == "full":
        L, nup, m = 10, 5, 24
    else:
        L, nup, m = 6, 1, 10
    kw = dict(Jxy=1.0, Jz=0.6, h=np.linspace(-0.3, 0.2, L), nup=nup)
    mj = sd.xxz_chain(L, dtype=jnp.float64, layout="sector_kron", **kw)
    mt = pt.xxz_chain(L, dtype=torch.float64, **kw)
    lj = jsk.make_sector_kron_layout(mj, mj.kron_splits)
    lt = tsk.make_sector_kron_layout(mt, mt.kron_splits)
    p = _pair(lj, 9)
    aj, bj, nj = jke.lanczos_tridiag_pair(
        jke.kron_planes_matvec_fn(lj, fused=False), _jpair(p, jnp.float64), m)
    at, bt, nt = tke.lanczos_tridiag_pair(
        tke.kron_planes_matvec_fn(lt, device="cpu", fused=False,
                                  dtype=torch.float64),
        _tpair(p, torch.float64), m)
    assert at.shape == (m,) and bt.shape == (m - 1,)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0, atol=1e-10)
    assert abs(float(nt) - float(nj)) < 1e-12
    if case == "breakdown":
        assert not bt[6:].any() and bt[4] > 0  # beta past dim 6 is 0
        assert torch.all(at[6:] == at[5])      # repeats the last alpha


@pytest.mark.parametrize("method", ["chebyshev", "krylov"])
def test_typicality_matches_jax(method):
    """Same numpy r0 and explicit bounds: the port (K2's plain version for
    the co-evolution) against the JAX package's XLA route, float32."""
    mj, lj, mt, lt = _models(10, Jz=0.7)
    r = _pair(lj, 10)
    ts = (0.0, 0.3, 0.6)
    kw = dict(cheb_n=24, Ebounds=(-8.0, 7.0), imag_method=method, kry_m=20)
    gj = jke.typicality_correlation_kron(mj, 0.6, 2, 5, ts, fused=False,
                                         r0=_jpair(r), **kw)
    gt = tke.typicality_correlation_kron(mt, 0.6, 2, 5, ts, r0=_tpair(r),
                                         **kw)
    assert gt.dtype == np.complex128 and gt.shape == (3,)
    np.testing.assert_allclose(gt, gj, rtol=0, atol=2e-6)
    assert abs(gt[0].imag) < 1e-6  # <Sz_a Sz_b> at t = 0 is real


def test_mesh_and_bf16_are_not_ported():
    """(The name is from when they were not.) `mesh=` runs the sharded path:
    a two-shard trajectory and typicality correlation agree with the
    unsharded ones (2e-5, float32); tests/test_torch_parallel.py holds them
    to the JAX package."""
    _, _, mt, _ = _models(8, field=False)
    mesh = pt.LocalMesh(2, "cpu")
    kw = dict(cheb_n=12, Ebounds=(-3.5, 3.5))
    pair, obs, _ = tke.evolve_trajectory_kron(mt, 0b1111, 0.1, 1, mesh=mesh,
                                              **kw)
    _, obs_u, _ = tke.evolve_trajectory_kron(mt, 0b1111, 0.1, 1,
                                             device="cpu", **kw)
    assert pair[0].mesh is mesh and np.abs(obs - obs_u).max() <= 2e-5
    g = tke.typicality_correlation_kron(mt, 1.0, 0, 1, (0.0,), mesh=mesh,
                                        **kw)
    g_u = tke.typicality_correlation_kron(mt, 1.0, 0, 1, (0.0,),
                                          device="cpu", **kw)
    assert np.abs(g - g_u).max() <= 2e-5
    # the port reads no environment for routing: K2's use is a field
    planes = tke.kron_planes_matvec_fn(tsk.make_sector_kron_layout(
        mt, mt.kron_splits), device="cpu")
    assert planes.cheb_fused and planes.cheb_top_k == 32
    with pytest.raises(ValueError, match="fused KronHamiltonian"):
        tke.kron_planes_matvec_fn(planes.layout, device="cpu", fused=False,
                                  cheb_fused=True)


def test_exact_oracle_matches_port_and_jax():
    """The chip smoke's exact-evolution oracle (dense H over the port's
    sector basis) against the JAX package's dense H, and the port's
    float64 plain trajectory against the oracle."""
    L = 8
    mj, _, mt, _ = _models(L, field=True, jdtype=jnp.float64,
                           tdtype=torch.float64)
    Hj = np.asarray(sd.build_dense_H(sd.xxz_chain(
        L, Jxy=1.0, Jz=0.5, h=np.linspace(-0.1, 0.2, L), nup=L // 2,
        dtype=jnp.float64)))
    H, states = chip_smoke.dense_sector_H(mt)
    np.testing.assert_allclose(H, Hj, rtol=0, atol=1e-12)
    bits = tis.domain_wall_bitstring(mt)
    sz = chip_smoke.exact_sz_trajectory(mt, bits, 0.1, 4)
    _, obs, _ = tke.evolve_trajectory_kron(mt, bits, 0.1, 4, cheb_n=30,
                                           device="cpu",
                                           state_dtype=torch.float64)
    assert sz.shape == obs.shape == (4, L)
    # float64 states, float32 Chebyshev accumulator (as the JAX package)
    np.testing.assert_allclose(obs, sz, rtol=0, atol=1e-6)
