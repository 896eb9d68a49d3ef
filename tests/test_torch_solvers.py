"""The port's solvers against the JAX package from the same numpy-made
inputs (f64 on the CPU, plain blocks apply on both sides): Lanczos
coefficients, the restarted ground state, the L=16 oracle energy, KPM
moments and reconstruction, and the S^z_q weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu import observables_kron as jok
from spindynamics_tpu.ops import sector_kron as jsk
from spindynamics_tpu.solvers import blockvec as jbv
from spindynamics_tpu.solvers import chebyshev as jch
from spindynamics_tpu.solvers import lanczos as jla
from spindynamics_tpu_torch import observables_kron as tok
from spindynamics_tpu_torch.ops import sector_kron as tsk
from spindynamics_tpu_torch.solvers import blockvec as tbv
from spindynamics_tpu_torch.solvers import chebyshev as tch
from spindynamics_tpu_torch.solvers import lanczos as tla
from spindynamics_tpu_torch.utils.convert import blockvec_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per test process, so
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(L=12, splits=(5, 4, 3), seed=0):
    """Same f64 model, layout, matvec and numpy-made start on both sides."""
    fld = np.linspace(-0.2, 0.3, L)
    kw = dict(Jxy=1.0, Jz=0.8, h=fld, nup=L // 2, kron_splits=splits)
    mj = sd.xxz_chain(L, dtype=jnp.float64, layout="sector_kron", **kw)
    mt = pt.xxz_chain(L, dtype=torch.float64, **kw)
    lj = jsk.make_sector_kron_layout(mj, mj.kron_splits)
    lt = tsk.make_sector_kron_layout(mt, mt.kron_splits)
    x = np.random.default_rng(seed).standard_normal(lj.n_states)
    x = np.where(np.asarray(mj.valid_mask()), x, 0.0)
    leaves = [np.asarray(b) for b in jsk.flat_to_blocks(jnp.asarray(x), lj)]
    return (jbv.bv_matvec_fn(lj), jbv.BlockVec([jnp.asarray(l) for l in leaves]),
            tbv.bv_matvec_fn(lt), blockvec_from_numpy(leaves, "cpu",
                                                      torch.float64),
            lj, lt)


def test_lanczos_iteration_matches_jax():
    mvj, vj, mvt, vt, _, _ = _setup()
    fj = jla.lanczos_iteration(mvj, vj, 20)
    ft = tla.lanczos_iteration(mvt, vt, 20)
    assert ft.m_eff == int(fj.m_eff) == 20
    assert abs(float(ft.v0_norm) - float(fj.v0_norm)) < 1e-10
    np.testing.assert_allclose(ft.alphas.numpy(), np.asarray(fj.alphas),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(ft.betas.numpy(), np.asarray(fj.betas),
                               rtol=0, atol=1e-10)


def test_restarted_groundstate_matches_jax():
    mvj, vj, mvt, vt, _, _ = _setup(seed=1)
    Ej, psij, infoj = jla.lanczos_groundstate_restarted(
        mvj, None, lanc_m=30, cycles=3, dtype=jnp.float64, v0=vj)
    Et, psit, infot = tla.lanczos_groundstate_restarted(
        mvt, vt, lanc_m=30, cycles=3)
    assert abs(Et - Ej) < 1e-9
    assert infot["cycles"] == infoj["cycles"]
    ov = sum(float(np.vdot(np.asarray(a), b.numpy()))
             for a, b in zip(psij.leaves, psit.leaves))
    assert abs(abs(ov) - 1.0) < 1e-8


def test_groundstate_L16_oracle_f64():
    m = pt.heisenberg_chain(16, nup=8, dtype=torch.float64)
    E0, psi, info, lay = pt.groundstate_kron(m, lanc_m=40, cycles=6,
                                             device="cpu",
                                             target_residual=1e-7)
    assert abs(E0 - (-11.67077735)) < 1e-6  # docs/PARITY.md, CPU x64
    assert info["residual"] < 1e-7
    assert len(psi.leaves) == len(lay.groups)


def test_restart_cycle_is_deterministic_f32():
    """The fused f32 path (axpy-seeded recurrence, compensated dots): two
    cycles from identical starts give bit-identical results, the property
    the second pass relies on."""
    m = pt.xxz_chain(12, Jxy=1.0, Jz=0.8, nup=6)
    lay = tsk.make_sector_kron_layout(m, m.kron_splits)
    H = pt.KronHamiltonian(lay, device="cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    v = tbv.bv_random(lay, g, device="cpu")
    runs = [tla.restart_cycle(H, pt.BlockVec([l.clone() for l in v.leaves]),
                              20) for _ in range(2)]
    (E1, p1, i1), (E2, p2, i2) = runs
    assert E1 == E2 and i1["residual"] == i2["residual"]
    assert all(torch.equal(a, b) for a, b in zip(p1.leaves, p2.leaves))


@pytest.mark.parametrize("doubling", [True, False])
def test_chebyshev_moments_match_jax(doubling):
    mvj, vj, mvt, vt, _, _ = _setup(seed=2)
    a, b = 9.0, 0.3
    nj = float(jnp.sqrt(sum(jnp.vdot(l, l) for l in vj.leaves)))
    vj = vj * (1.0 / nj)
    vt = vt * (1.0 / nj)

    def rj(bv):
        return (mvj(bv) - b * bv) * (1.0 / a)

    def rt(bv):
        return (mvt(bv) - bv * b) * (1.0 / a)

    mj_ = np.asarray(jch.chebyshev_moments(rj, vj, 24, doubling_trick=doubling))
    mt_ = tch.chebyshev_moments(rt, vt, 24, doubling_trick=doubling).numpy()
    assert mt_.shape == (24,)
    np.testing.assert_allclose(mt_, mj_, rtol=0, atol=1e-10)


@pytest.mark.parametrize("conv", ["kpm_sw", "series"])
def test_kpm_reconstruct_matches_jax(conv):
    rng = np.random.default_rng(4)
    mu = rng.standard_normal((3, 40)) * np.exp(-0.1 * np.arange(40))
    omega = np.linspace(-3.0, 3.5, 57)
    kw = (dict(doubling=True, density_2_over_a=False) if conv == "kpm_sw"
          else dict(doubling=False, density_2_over_a=True, clamp=None))
    for kernel in ("jackson", "lorentz", "none"):
        Sj = np.asarray(jch.kpm_reconstruct(jnp.asarray(mu),
                                            jnp.asarray(omega), 3.2, 0.1,
                                            kernel=kernel, **kw))
        St = tch.kpm_reconstruct(torch.as_tensor(mu), omega, 3.2, 0.1,
                                 kernel=kernel, **kw).numpy()
        np.testing.assert_allclose(St, Sj, rtol=0, atol=1e-10)
    assert tch.rescaling_params(-2.0, 4.0) == jch.rescaling_params(-2.0, 4.0)


def test_sz_q_weights_and_apply_match_jax():
    _, vj, _, vt, lj, lt = _setup(L=16, splits=None, seed=5)
    for q in (0.0, 2 * np.pi * 3 / 16, np.pi):
        for dt in (np.float32, np.float64):
            wj = jok.bv_sz_q_weights(lj, q, dtype=dt)
            wt = tok.bv_sz_q_weights(lt, q, dtype=dt)
            assert len(wj) == len(wt)
            for a, b in zip(wj, wt):
                assert all(x.dtype == y.dtype and np.array_equal(x, y)
                           for x, y in zip(a, b))
        w = jok.bv_sz_q_weights(lj, q, dtype=np.float64)
        rj, ij = jok.bv_sz_q_apply(vj, w)
        rt, it = tok.bv_sz_q_apply(vt, w)
        for a, b in zip(rj.leaves + ij.leaves, rt.leaves + it.leaves):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-13)


def test_basis_state_matches_jax():
    _, _, _, _, lj, lt = _setup(L=16, splits=None)
    for bits in (0b0101010101010101, 0b1111000011110000, 0b0000000011111111):
        a = jbv.bv_basis_state(lj, bits, jnp.float64)
        b = tbv.bv_basis_state(lt, bits, torch.float64, "cpu")
        assert all(np.array_equal(np.asarray(x), y.numpy())
                   for x, y in zip(a.leaves, b.leaves))
    with pytest.raises(ValueError):
        tbv.bv_basis_state(lt, 0b111, torch.float64, "cpu")


def test_compensated_dots_match_jax():
    from spindynamics_tpu.utils import compensated as jc
    from spindynamics_tpu_torch.utils import compensated as tc

    rng = np.random.default_rng(6)
    x = rng.standard_normal(4096).astype(np.float32)
    y = (x + 1e-3 * rng.standard_normal(4096)).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for a, b in zip(tc.two_prod(xt, yt), jc.two_prod(jnp.asarray(x),
                                                     jnp.asarray(y))):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tc.two_sum(xt, yt), jc.two_sum(jnp.asarray(x),
                                                   jnp.asarray(y))):
        assert np.array_equal(a.numpy(), np.asarray(b))
    exact = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    ulp = float(np.spacing(np.float32(exact)))
    # the product rounding is gone: within an ulp or two of the f32 result
    assert abs(float(tc.dot2(xt, yt)) - exact) <= 2 * ulp
    assert abs(float(tc.vdot2(xt, yt)) - float(jc.vdot2(x, y))) <= 2 * ulp
    n = float(np.sqrt(np.dot(x.astype(np.float64), x.astype(np.float64))))
    assert abs(float(tc.norm2(xt)) - n) <= 2 * float(np.spacing(np.float32(n)))
