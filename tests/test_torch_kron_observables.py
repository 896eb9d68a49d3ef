"""The kron correlation observables (szsz_matrix_kron,
connected_correlations_kron, structure_factor_Sq_kron, bv_sz_q) and
kpm_correlation_matrix_kron against the JAX package from the same
numpy-made states, and against the port's flat observables and flat
kpm_correlation_matrix on the embedded layout for the same state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu import observables_kron as jok
from spindynamics_tpu.ops import sector_kron as jsk
from spindynamics_tpu.solvers import runners as jrun
from spindynamics_tpu.solvers.blockvec import BlockVec as JBV
from spindynamics_tpu_torch import observables as tobs
from spindynamics_tpu_torch import observables_kron as tok
from spindynamics_tpu_torch.ops import sector_kron as tsk
from spindynamics_tpu_torch.ops.spin_ops import sz_q_vector
from spindynamics_tpu_torch.solvers import kpm as tkpm
from spindynamics_tpu_torch.solvers import runners as trun


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per test process, so
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(L, splits=None, jdtype=jnp.float64, tdtype=torch.float64):
    kw = dict(Jxy=1.0, Jz=0.5, nup=L // 2, kron_splits=splits)
    mj = sd.xxz_chain(L, dtype=jdtype, layout="sector_kron", **kw)
    mt = pt.xxz_chain(L, dtype=tdtype, **kw)
    return (mj, jsk.make_sector_kron_layout(mj, mj.kron_splits),
            mt, tsk.make_sector_kron_layout(mt, mt.kron_splits))


def _pair(lay, seed):
    """A normalized (re, im) pair as numpy leaves, zero on the pad slots."""
    rng = np.random.default_rng(seed)
    planes = []
    for _ in range(2):
        out = []
        for (_, _, _, ch, cm, cl, cmp, clp) in lay.groups:
            x = np.zeros((ch, cmp, clp))
            x[:, :cm, :cl] = rng.standard_normal((ch, cm, cl))
            out.append(x)
        planes.append(out)
    n = np.sqrt(sum(float((x * x).sum()) for p in planes for x in p))
    return tuple([x / n for x in p] for p in planes)


def _jbv(leaves, dtype):
    return JBV([jnp.asarray(x, dtype) for x in leaves])


def _tbv(leaves, dtype):
    return pt.BlockVec([torch.tensor(x, dtype=dtype) for x in leaves])


def _to_embedded(leaves, lay):
    """The flat 2^L vector (bit i = site i) of a kron state given as numpy
    leaves: rank (h, m, l) of a group holds the amplitude of the state
    whose hi, mid and lo bit fields are the parts' rank-ordered states."""
    L1, L2, L3 = lay.splits
    perms = tsk.kron_part_perms(lay.splits)
    psi = np.zeros(1 << lay.L, dtype=np.asarray(leaves[0]).dtype)
    for x, (k_h, k_m, k_l, ch, cm, cl, cmp, clp) in zip(leaves, lay.groups):
        hi = tsk._perm_sector_states(L3, k_h, perms[2]).astype(np.int64)
        mid = tsk._perm_sector_states(L2, k_m, perms[1]).astype(np.int64)
        lo = tsk._perm_sector_states(L1, k_l, perms[0]).astype(np.int64)
        idx = ((hi[:, None, None] << (L1 + L2)) | (mid[None, :, None] << L1)
               | lo[None, None, :])
        psi[idx] = np.asarray(x)[:hi.shape[0], :cm, :cl]
    return psi


@pytest.mark.parametrize("L,splits,prec", [
    (8, None, "f64"), (10, (4, 3, 3), "f64"), (12, (5, 4, 3), "f64"),
    (12, None, "f32")], ids=["L8", "L10", "L12", "L12-f32"])
def test_correlation_observables_match_jax(L, splits, prec):
    """szsz, <Sz_i>, C_r and S(q) of a real BlockVec and of an (re, im)
    pair: float64 to 1e-10, float32 to 1e-5."""
    jd, td, tol = ((jnp.float64, torch.float64, 1e-10) if prec == "f64"
                   else (jnp.float32, torch.float32, 1e-5))
    mj, lj, mt, lt = _models(L, splits, jd, td)
    p = _pair(lj, L)
    for xj, xt in ((_jbv(p[0], jd), _tbv(p[0], td)),
                   (tuple(_jbv(q, jd) for q in p),
                    tuple(_tbv(q, td) for q in p))):
        zj, sj = jok.szsz_matrix_kron(xj, lj)
        zt, st = tok.szsz_matrix_kron(xt, lt)
        assert zt.dtype == td and zt.shape == (L, L) and st.shape == (L,)
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0,
                                   atol=tol)
        np.testing.assert_allclose(
            tok.connected_correlations_kron(xt, lt).numpy(),
            np.asarray(jok.connected_correlations_kron(xj, lj)), rtol=0,
            atol=tol)
        qj, Sj = jok.structure_factor_Sq_kron(xj, lj)
        qt, St = tok.structure_factor_Sq_kron(xt, lt)
        assert isinstance(St, np.ndarray) and np.array_equal(qt, qj)
        np.testing.assert_allclose(St, Sj, rtol=0, atol=tol)


@pytest.mark.parametrize("L,splits", [(8, None), (12, (5, 4, 3))])
def test_szsz_structure(L, splits):
    """Of a normalized state in the Sz = 0 sector: the diagonal is 1/4 of
    the norm, the matrix is symmetric, every row sums to 0 (sum_j Sz_j = 0
    on every basis state), and the magnetization is the one-site pass's."""
    _, lj, _, lt = _models(L, splits)
    p = tuple(_tbv(q, torch.float64) for q in _pair(lj, 3))
    for x in (p, p[0]):
        n2 = sum(float(w.sum()) for w in tok.bv_probs(x))
        szsz, si = tok.szsz_matrix_kron(x, lt)
        assert torch.allclose(torch.diagonal(szsz),
                              torch.full((L,), 0.25 * n2,
                                         dtype=torch.float64), atol=1e-14)
        assert torch.allclose(szsz, szsz.T, atol=1e-15)
        assert float(szsz.sum(dim=1).abs().max()) < 1e-14
        assert torch.allclose(si, tok.magnetization_per_site_kron(x, lt),
                              atol=1e-15)


@pytest.mark.parametrize("L,splits", [(10, (4, 3, 3)), (12, None)])
def test_correlation_observables_match_flat(L, splits):
    """The same state on the embedded layout through the port's flat
    observables."""
    _, lj, mt, lt = _models(L, splits)
    me = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2, dtype=torch.float64,
                      layout="embedded")
    p = _pair(lj, 7)
    flat = torch.complex(torch.tensor(_to_embedded(p[0], lt)),
                         torch.tensor(_to_embedded(p[1], lt)))
    assert abs(float(torch.linalg.vector_norm(flat)) - 1.0) < 1e-12
    pair = tuple(_tbv(q, torch.float64) for q in p)
    zk, sk = tok.szsz_matrix_kron(pair, lt)
    zf, sf = tobs.szsz_matrix(flat, me)
    assert torch.allclose(zk, zf, atol=1e-12)
    assert torch.allclose(sk, sf, atol=1e-12)
    assert torch.allclose(tok.connected_correlations_kron(pair, lt),
                          tobs.connected_correlations(flat, me), atol=1e-12)
    qk, Sk = tok.structure_factor_Sq_kron(pair, lt)
    qf, Sf = tobs.structure_factor_Sq(flat, me)
    np.testing.assert_allclose(qk, qf.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Sk, Sf.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("L,splits", [(9, (3, 3, 3)), (12, (5, 4, 3))])
def test_bv_sz_q_matches_jax_and_flat(L, splits):
    """phi = S^z_q psi of a real BlockVec and of an (re, im) pair against
    the JAX function (1e-12 in float64) and against the flat sz_q_vector of
    the embedded layout."""
    mj, lj, mt, lt = _models(L, splits)
    me = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2, dtype=torch.float64,
                      layout="embedded")
    p = _pair(lj, 11)
    for q in (0.7, np.pi):
        for real in (True, False):
            xj = (_jbv(p[0], jnp.float64) if real
                  else tuple(_jbv(u, jnp.float64) for u in p))
            xt = (_tbv(p[0], torch.float64) if real
                  else tuple(_tbv(u, torch.float64) for u in p))
            # the JAX weights default to float32: ask for float64 there
            hl = [x.shape[0] for x in p[0]]
            rj, ij = jok.bv_sz_q_apply(
                xj, jok.bv_sz_q_weights(lj, q, hl, dtype=np.float64))
            rt, it = tok.bv_sz_q(xt, lt, q)
            for a, b in zip(rj.leaves + ij.leaves, rt.leaves + it.leaves):
                assert b.dtype == torch.float64
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                           atol=1e-12)
            flat = torch.complex(
                torch.tensor(_to_embedded(p[0], lt)),
                torch.tensor(_to_embedded(p[1], lt)) * (0.0 if real else 1.0))
            want = sz_q_vector(me, flat, q, dtype=torch.complex128)
            got = torch.complex(
                torch.tensor(_to_embedded([x.numpy() for x in rt.leaves], lt)),
                torch.tensor(_to_embedded([x.numpy() for x in it.leaves], lt)))
            assert float((got - want).abs().max()) < 1e-12
    # float32 leaves get float32 weights, as the JAX default
    r32, _ = tok.bv_sz_q(_tbv(p[0], torch.float32), lt, 0.7)
    rj32, _ = jok.bv_sz_q(_jbv(p[0], jnp.float32), lj, 0.7)
    for a, b in zip(rj32.leaves, r32.leaves):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-7)


OMEGA = np.linspace(-6.0, 6.0, 61)


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_kpm_correlation_matrix_kron_matches_jax(prec):
    """A numpy-made real state, given (a, b), a subset of B sites: float64
    to 1e-9 of the peak, float32 (the fused apply on both sides) to 1e-4."""
    L, n, sites = 10, 30, (2, 5, 9)
    jd, td, tol = ((jnp.float64, torch.float64, 1e-9) if prec == "f64"
                   else (jnp.float32, torch.float32, 1e-4))
    mj, lj, mt, lt = _models(L, (4, 3, 3), jd, td)
    x = _pair(lj, 5)[0]
    nrm = np.sqrt(sum(float((u * u).sum()) for u in x))
    x = [u / nrm for u in x]
    kw = dict(n=n, E0=-4.0, a=7.5, b=0.3, sites=sites)
    Cj, ij = jrun.kpm_correlation_matrix_kron(mj, OMEGA, psi0=_jbv(x, jd),
                                              **kw)
    Ct, it = trun.kpm_correlation_matrix_kron(mt, OMEGA, psi0=_tbv(x, td),
                                              **kw)
    assert Ct.shape == Cj.shape == (L, len(sites), OMEGA.shape[0])
    assert (it["a"], it["b"], it["E0"]) == (ij["a"], ij["b"], ij["E0"])
    peak = float(np.abs(Cj).max())
    assert peak > 1e-3 and np.all(Ct >= 0.0)
    assert np.abs(Ct - Cj).max() <= tol * peak


def test_kpm_correlation_matrix_kron_matches_flat():
    """The flat kpm_correlation_matrix on the embedded layout for the same
    state and (a, b): the columns of the chosen B sites agree."""
    L, n, sites = 10, 30, (0, 4, 7)
    _, lj, mt, lt = _models(L, (4, 3, 3))
    me = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2, dtype=torch.float64,
                      layout="embedded")
    x = _pair(lj, 6)[0]
    nrm = np.sqrt(sum(float((u * u).sum()) for u in x))
    x = [u / nrm for u in x]
    Ck, info = pt.kpm_correlation_matrix_kron(
        mt, OMEGA, n=n, psi0=_tbv(x, torch.float64), E0=-4.0, a=7.5, b=0.3,
        sites=sites)
    Cf = tkpm.kpm_correlation_matrix(
        torch.tensor(_to_embedded(x, lt)), OMEGA, me, n=n, a=7.5, b=0.3,
        matvec=pt.matvec_fn(me, device="cpu")).numpy()
    peak = float(Cf.max())
    assert np.abs(Ck - Cf[:, list(sites), :]).max() <= 1e-9 * peak
    assert "bounds" not in info  # (a, b) given: no bounds solve


def test_kpm_correlation_matrix_kron_own_ground_state_and_bounds():
    """Without psi0 and (a, b): the ground state and the bounds Lanczos run
    first; all sites by default; C is finite and non-negative, and the
    on-site column's omega-integral is the 2/a density of <Sz_j^2> = 1/4
    folded with the kernel (positive)."""
    L = 8
    m = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2)
    C, info = pt.kpm_correlation_matrix_kron(m, OMEGA, n=24, device="cpu")
    assert C.shape == (L, L, OMEGA.shape[0])
    assert np.all(np.isfinite(C)) and np.all(C >= 0.0) and C.max() > 0
    lo, hi = info["bounds"]
    assert lo < info["E0"] + 1e-6 and hi > 0 and info["residual"] <= 1e-3
    assert abs(info["a"] - (hi - lo) / 2.0) < 1e-9
    # a mesh runs the same solve on row-sharded states
    Cm, _ = pt.kpm_correlation_matrix_kron(m, OMEGA, n=24, sites=[3],
                                           mesh=pt.LocalMesh(2, "cpu"))
    assert np.abs(Cm[:, 0] - C[:, 3]).max() <= 1e-3 * C.max()
