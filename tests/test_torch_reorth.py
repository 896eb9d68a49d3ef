"""groundstate_kron(reorth=) on BlockVec states: one stored-basis Lanczos
cycle with selective (omega-triggered) or full reorthogonalization, the
basis kept as stacked per-group leaves, against the JAX package's
groundstate_kron(reorth=) from the same start, unsharded and on a mesh
(the port's LocalMesh(2) against a JAX mesh of two virtual devices)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu.ops import sector_kron as jsk
from spindynamics_tpu.solvers.blockvec import bv_random as j_bv_random
from spindynamics_tpu_torch.utils.convert import blockvec_from_numpy

L, LANC_M = 10, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    kw = dict(Jxy=1.0, Jz=0.5, nup=L // 2, kron_splits=(4, 3, 3))
    mj = sd.xxz_chain(L, dtype=jnp.float32, layout="sector_kron", **kw)
    mt = pt.xxz_chain(L, **kw)
    lj = jsk.make_sector_kron_layout(mj, mj.kron_splits, mj.kron_pads)
    # JAX's own start (PRNGKey(0)), handed to the port as numpy leaves
    start = [np.asarray(l) for l in
             j_bv_random(lj, jax.random.PRNGKey(0), jnp.float32).leaves]
    # the float64 energy: dense H over all 2^L states (the ground state is
    # in the Sz = 0 sector)
    E64 = np.linalg.eigvalsh(pt.build_dense_H(pt.xxz_chain(L, Jxy=1.0,
                                                            Jz=0.5)))[0]
    return mj, mt, start, float(E64)


def _overlap(psi_j, psi_t):
    return abs(sum(float(np.vdot(np.asarray(a, np.float64),
                                 b.double().numpy()))
                   for a, b in zip(psi_j.leaves, psi_t.leaves)))


@pytest.mark.parametrize("reorth,mesh", [("selective", False),
                                         ("full", False),
                                         ("selective", True)],
                         ids=["selective-unsharded", "full-unsharded",
                              "selective-mesh2"])
def test_groundstate_kron_reorth_matches_jax(models, reorth, mesh):
    """E0 within 1e-5 of the JAX solve from the same start (two float32
    runs of one recurrence; the JAX tests hold selective and full to 2e-4
    of each other) and 2e-4 of the float64 energy, residual < 5e-2 (the
    JAX test's bound), the Ritz vectors' overlap 1 - 1e-4, and the basis
    stored as stacked BlockVec leaves: psi is a BlockVec of rank-3 leaves
    on the mesh when one is given."""
    mj, mt, start, E64 = models
    jmesh = Mesh(np.array(jax.devices()[:2]), ("rows",)) if mesh else None
    Ej, psi_j, info_j, _ = sd.groundstate_kron(
        mj, lanc_m=LANC_M, fused=False, reorth=reorth, mesh=jmesh)
    tmesh = pt.LocalMesh(2, "cpu") if mesh else None
    Et, psi_t, info_t, lay = pt.groundstate_kron(
        mt, lanc_m=LANC_M, reorth=reorth, mesh=tmesh,
        v0=blockvec_from_numpy(start, "cpu"))
    assert abs(Et - Ej) <= 1e-5 and abs(Et - E64) <= 2e-4
    assert info_t["residual"] < 5e-2 and info_t["m_eff"] == info_j["m_eff"]
    assert isinstance(psi_t, pt.BlockVec) and psi_t.leaves[0].ndim == 3
    if mesh:
        assert psi_t.mesh is tmesh
        spec = pt.kron_shard_spec(lay, 2)
        psi_t = pt.unshard_kron_blockvec(psi_t, spec)
        psi_j = sd.BlockVec([np.asarray(l) for l in psi_j.leaves])
        from spindynamics_tpu.parallel import sharded_kron_scaling as jss
        psi_j = jss.unshard_kron_blockvec(psi_j, jss.kron_shard_spec(
            jsk.make_sector_kron_layout(mj, mj.kron_splits, mj.kron_pads),
            2))
    assert _overlap(psi_j, psi_t) >= 1 - 1e-4
