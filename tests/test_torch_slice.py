"""The whole slice at L=12 in float32 (the fused path: K1's plain version on
the CPU here, Pallas interpret mode on the JAX side): ground state against
the JAX package and the x64 oracle, and S(q, omega) from the JAX ground
state carried across as numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu_torch.ops.sector_kron import make_sector_kron_layout
from spindynamics_tpu_torch.utils.convert import (
    blockvec_from_numpy, blockvec_to_numpy, model_from_jax_arrays,
    model_from_numpy)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per test process, so
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

L = 12


@pytest.fixture(scope="module")
def jax_groundstate():
    mj = sd.xxz_chain(L, Jxy=1.0, Jz=1.0, nup=L // 2, dtype=jnp.float32,
                      layout="sector_kron")
    E0, psi, info, lay = sd.groundstate_kron(mj, lanc_m=30, cycles=6,
                                             target_residual=1e-4)
    m64 = sd.xxz_chain(L, Jxy=1.0, Jz=1.0, nup=L // 2, dtype=jnp.float64)
    E64 = float(np.linalg.eigvalsh(np.asarray(sd.build_dense_H(m64)))[0])
    return mj, E0, psi, info, E64


def _port_model(mj):
    return model_from_numpy(
        mj.L, mj.nup, mj.hop_sites, np.asarray(mj.hop_J),
        np.asarray(mj.field), mj.zz_sites, np.asarray(mj.zz_J),
        mj.kron_splits)


def test_groundstate_matches_jax_and_oracle(jax_groundstate):
    mj, Ej, _, _, E64 = jax_groundstate
    mt = _port_model(mj)
    assert mt.dtype == torch.float32 and mt.kron_splits == mj.kron_splits
    rng = np.random.default_rng(0)
    leaves = []
    for (_, _, _, ch, cm, cl, cmp, clp) in make_sector_kron_layout(
            mt, mt.kron_splits).groups:
        x = np.zeros((ch, cmp, clp))
        x[:, :cm, :cl] = rng.standard_normal((ch, cm, cl))
        leaves.append(x)
    E0, psi, info, lay = pt.groundstate_kron(
        mt, lanc_m=30, cycles=6, target_residual=1e-4,
        v0=blockvec_from_numpy(leaves, "cpu"))
    assert psi.dtype == torch.float32
    assert abs(E0 - Ej) < 2e-4
    assert abs(E0 - E64) < 2e-4
    assert info["residual"] < 1e-4
    # pad slots stay exactly zero through the whole solve
    for l, (_, _, _, ch, cm, cl, cmp, clp) in zip(psi.leaves, lay.groups):
        assert not l[:, cm:, :].any() and not l[:, :, cl:].any()


def test_kpm_sqw_on_jax_groundstate(jax_groundstate):
    mj, Ej, psij, infoj, _ = jax_groundstate
    qs = [2 * np.pi * k / L for k in (1, 3, 6)]
    omega = np.linspace(0.0, 4.0, 40)
    bounds = (-8.0, 8.0)
    Sj, _ = sd.kpm_sqw_kron(mj, qs, omega, kpm_m=32, psi0=psij, E0=Ej,
                            info=infoj, bounds=bounds)
    leaves = [np.asarray(l) for l in psij.leaves]
    psit = blockvec_from_numpy(leaves, "cpu")
    assert all(np.array_equal(a, b)
               for a, b in zip(blockvec_to_numpy(psit), leaves))
    St, info = pt.kpm_sqw_kron(model_from_jax_arrays(
        mj.L, mj.nup, mj.hop_sites, np.asarray(mj.hop_J),
        np.asarray(mj.field), mj.zz_sites, np.asarray(mj.zz_J),
        mj.kron_splits), qs, omega, kpm_m=32, psi0=psit, E0=Ej,
        bounds=bounds)
    assert St.shape == (len(qs), len(omega))
    scale = float(np.abs(Sj).max())
    assert np.abs(St - np.asarray(Sj)).max() <= 2e-3 * scale
    assert np.all(np.isfinite(St)) and St.min() >= 0.0
    assert info["a"] == pytest.approx(8.0) and info["E0"] == Ej


def test_kpm_sqw_full_path_port_only(jax_groundstate):
    """The port's own end-to-end call (ground state + Lanczos bounds + KPM)
    at L=12: finite, non-negative, E0 at the oracle."""
    _, _, _, _, E64 = jax_groundstate
    m = pt.heisenberg_chain(L, nup=L // 2)
    S, info = pt.kpm_sqw_kron(m, [np.pi / 2, np.pi], np.linspace(0, 4, 30),
                              device="cpu",
                              kpm_m=24, lanc_m=30, target_residual=1e-4)
    assert np.all(np.isfinite(S)) and S.min() >= 0.0 and S.max() > 0.0
    assert abs(info["E0"] - E64) < 2e-4
    lo, hi = info["bounds"]
    assert lo < info["E0"] < hi
