"""Checkpoint/resume of the port (utils/checkpoint.py,
lanczos_groundstate_checkpointed, evolve_trajectory(checkpoint_dir=)) on
the CPU: round trips of flat tensors and BlockVecs with their metadata and
extra arrays; a cut and resumed ground state (flat, and BlockVec on the
kron layout) equal to the uninterrupted one bit for bit, its E0 against
the JAX package's checkpointed solve from the same start (float64, 1e-10);
the target_residual early return; and the trajectory cases of
tests/test_runners_checkpoint.py on the port's complex trajectory."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu.solvers import runners as jru
from spindynamics_tpu_torch.ops.sector_kron import make_sector_kron_layout
from spindynamics_tpu_torch.solvers.blockvec import bv_random
from spindynamics_tpu_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint)
from spindynamics_tpu_torch.utils.convert import model_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return pt.xxz_chain(8, Jxy=1.0, Jz=0.5, nup=4, dtype=torch.float64,
                        layout="compact")


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128])
def test_checkpoint_round_trip(tmp_path, dtype):
    g = torch.Generator().manual_seed(0)
    psi = torch.randn(70, generator=g, dtype=torch.float64).to(dtype)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, psi, meta={"step": 7, "Ebounds": [-1.5, 2.25]},
                    extra_arrays={"alphas": np.arange(3.0),
                                  "obs": torch.ones(2, 4)})
    psi2, meta, extra = load_checkpoint(path)
    assert torch.equal(psi2, psi) and psi2.dtype == dtype
    assert meta == {"step": 7, "Ebounds": [-1.5, 2.25], "_format": "torch"}
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["_format"] == "torch"
    np.testing.assert_array_equal(extra["alphas"], np.arange(3.0))
    assert isinstance(extra["obs"], np.ndarray) and extra["obs"].shape == (2,
                                                                           4)
    psi3, _, _ = load_checkpoint(path, device="cpu")
    assert torch.equal(psi3, psi)


def test_blockvec_round_trip_and_refusals(tmp_path):
    m = pt.heisenberg_chain(10, nup=5)
    lay = make_sector_kron_layout(m, m.kron_splits)
    bv = bv_random(lay, torch.Generator().manual_seed(3), torch.float32,
                   "cpu")
    path = str(tmp_path / "bv")
    save_checkpoint(path, bv, meta={"cycle": 2})
    back, meta, extra = load_checkpoint(path)
    assert isinstance(back, pt.BlockVec) and back.mesh is None
    assert len(back.leaves) == len(bv.leaves) and extra == {}
    assert all(torch.equal(a, b) for a, b in zip(back.leaves, bv.leaves))
    mesh = pt.LocalMesh(1, "cpu")
    assert load_checkpoint(path, mesh=mesh)[0].mesh is mesh
    # a JAX checkpoint directory is refused by name
    jpath = str(tmp_path / "jax")
    os.makedirs(jpath)
    with open(os.path.join(jpath, "meta.json"), "w") as f:
        json.dump({"_format": "npz"}, f)
    with pytest.raises(ValueError, match="JAX package"):
        load_checkpoint(jpath)


def test_groundstate_resume_bit_for_bit_and_jax(tmp_path, model):
    """2 cycles, a 'crash', then a resume to 4 equals 4 cycles run at once,
    bit for bit; E0 equals the JAX package's checkpointed solve from the
    same start (float64)."""
    mv = pt.matvec_fn(model, device="cpu")
    v0 = np.random.default_rng(4).standard_normal(model.n_states)
    kw = dict(lanc_m=12, cycles=4, dtype=torch.float64)
    E_a, psi_a, info_a = pt.lanczos_groundstate_checkpointed(
        mv, model.n_states, str(tmp_path / "a"),
        v0=torch.as_tensor(v0), **kw)
    assert info_a["cycles"] == 4 and info_a["resumed_at"] is None
    pt.lanczos_groundstate_checkpointed(
        mv, model.n_states, str(tmp_path / "b"), v0=torch.as_tensor(v0),
        **dict(kw, cycles=2))
    # the resume ignores v0: the state comes from the checkpoint
    E_b, psi_b, info_b = pt.lanczos_groundstate_checkpointed(
        mv, model.n_states, str(tmp_path / "b"), v0=torch.zeros(70), **kw)
    assert info_b["resumed_at"] == 2 and info_b["cycles"] == 4
    assert E_a == E_b and torch.equal(psi_a, psi_b)
    _, meta, extra = load_checkpoint(str(tmp_path / "b"))
    assert meta["cycle"] == 4 and meta["lanc_m"] == 12
    assert meta["E0"] == E_b and extra["evals"].ndim == 1
    mj = sd.xxz_chain(8, Jxy=1.0, Jz=0.5, nup=4, dtype=jnp.float64)
    Ej, pj, ij = jru.lanczos_groundstate_checkpointed(
        sd.matvec_fn(mj), mj.n_states, str(tmp_path / "jax"),
        v0=jnp.asarray(v0), **dict(kw, dtype=jnp.float64))
    assert abs(E_a - Ej) <= 1e-10
    pj = np.asarray(pj)
    ph = np.vdot(psi_a.numpy(), pj)
    assert np.abs(psi_a.numpy() * ph / abs(ph) - pj).max() <= 1e-8
    # the caller's start is copied, not consumed
    v = torch.as_tensor(v0)
    pt.lanczos_groundstate_checkpointed(mv, None, str(tmp_path / "c"),
                                        v0=v, **dict(kw, cycles=1))
    assert torch.equal(v, torch.as_tensor(v0))


def test_groundstate_target_residual_early_return(tmp_path, model):
    mv = pt.matvec_fn(model, device="cpu")
    g = torch.Generator().manual_seed(1)
    E, psi, info = pt.lanczos_groundstate_checkpointed(
        mv, model.n_states, str(tmp_path / "t"), lanc_m=30, cycles=6,
        dtype=torch.float64, generator=g, target_residual=1e-6)
    assert info["cycles"] < 6 and info["residual"] < 1e-6
    # a resume whose saved residual is already below the target returns at
    # once: the saved E0 and state, no cycle run
    E2, psi2, info2 = pt.lanczos_groundstate_checkpointed(
        lambda v: pytest.fail("no apply on an early return"), None,
        str(tmp_path / "t"), lanc_m=30, cycles=6, dtype=torch.float64,
        target_residual=1e-6, device="cpu")
    assert E2 == E and torch.equal(psi2, psi)
    assert info2 == {"residual": info["residual"],
                     "resumed_at": info["cycles"], "cycles": info["cycles"]}


def test_blockvec_groundstate_resume(tmp_path):
    """The kron layout's BlockVec states through the same checkpointed
    restarts: a cut and resumed run equals the whole one bit for bit."""
    m = pt.heisenberg_chain(10, nup=5)
    lay = make_sector_kron_layout(m, m.kron_splits)
    H = pt.KronHamiltonian(lay, device="cpu")
    v0 = bv_random(lay, torch.Generator().manual_seed(2), torch.float32,
                   "cpu")
    kw = dict(lanc_m=30, cycles=3, v0=v0)
    E_a, psi_a, _ = pt.lanczos_groundstate_checkpointed(
        H, None, str(tmp_path / "a"), **kw)
    pt.lanczos_groundstate_checkpointed(H, None, str(tmp_path / "b"),
                                        **dict(kw, cycles=1))
    E_b, psi_b, info = pt.lanczos_groundstate_checkpointed(
        H, None, str(tmp_path / "b"), **kw)
    assert isinstance(psi_b, pt.BlockVec) and info["resumed_at"] == 1
    assert E_a == E_b
    assert all(torch.equal(a, b) for a, b in zip(psi_a.leaves, psi_b.leaves))
    exact = np.linalg.eigvalsh(pt.build_dense_H(pt.heisenberg_chain(
        10, nup=5, layout="compact")))[0]
    assert abs(E_a - exact) <= 1e-4


# ---- the trajectory cases of tests/test_runners_checkpoint.py ---------------


def test_trajectory_methods_agree(model):
    psi0 = pt.domain_wall_state(model, dtype=torch.complex128, device="cpu")
    _, obs_c = pt.evolve_trajectory(model, psi0, 0.1, 5, method="chebyshev",
                                    cheb_n=30, Ebounds=(-8.0, 8.0))
    _, obs_k = pt.evolve_trajectory(model, psi0, 0.1, 5, method="krylov",
                                    kry_m=30)
    assert np.allclose(obs_c, obs_k, atol=1e-5)


@pytest.mark.parametrize("method", ["chebyshev", "krylov"])
def test_trajectory_checkpoint_resume(tmp_path, model, method):
    """An interrupted and resumed trajectory equals the uninterrupted one
    bit for bit; the Chebyshev bounds come back from the checkpoint."""
    psi0 = pt.domain_wall_state(model, dtype=torch.complex64, device="cpu")
    kw = dict(method=method, cheb_n=24, kry_m=20)
    bounds = (-8.0, 8.0) if method == "chebyshev" else None
    want_psi, want_obs = pt.evolve_trajectory(model, psi0, 0.1, 8,
                                              Ebounds=bounds, **kw)
    ck = str(tmp_path / "traj")
    # "crash" after 5 of 8 steps (a save at step 3, the partial run's last
    # save at step 5)
    pt.evolve_trajectory(model, psi0, 0.1, 5, Ebounds=bounds,
                         checkpoint_dir=ck, checkpoint_every=3, **kw)
    _, meta, extra = load_checkpoint(ck)
    assert meta["step"] == 5 and extra["obs"].shape == (5, 8)
    assert meta["Ebounds"] == (list(bounds) if bounds else None)
    # resume to 8 steps; Ebounds omitted, restored from the metadata
    got_psi, got_obs = pt.evolve_trajectory(
        model, psi0, 0.1, 8, checkpoint_dir=ck, checkpoint_every=3,
        resume=True, **kw)
    assert torch.equal(got_psi, want_psi)
    assert got_obs.shape == want_obs.shape
    assert np.array_equal(got_obs, want_obs)
    # resuming a finished run returns the saved state
    again_psi, again_obs = pt.evolve_trajectory(
        model, psi0, 0.1, 8, checkpoint_dir=ck, resume=True, **kw)
    assert torch.equal(again_psi, want_psi)
    assert np.array_equal(again_obs, want_obs)


def test_trajectory_resume_requires_dir(model):
    psi0 = pt.domain_wall_state(model, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        pt.evolve_trajectory(model, psi0, 0.1, 2, Ebounds=(-8.0, 8.0),
                             resume=True)


def test_trajectory_matches_jax_planes_run(tmp_path):
    """The JAX package keeps these arguments on its plane trajectory; the
    port's complex trajectory with a checkpoint gives the same
    observables (float32 planes against complex64: 5e-5)."""
    mj = sd.xxz_chain(8, Jxy=1.0, Jz=0.5, nup=4, dtype=jnp.float64)
    mt = model_from_numpy(8, 4, mj.hop_sites, np.asarray(mj.hop_J),
                          np.asarray(mj.field), mj.zz_sites,
                          np.asarray(mj.zz_J), layout="compact")
    bounds = (-8.0, 8.0)
    _, obs_p = jru.evolve_trajectory_planes(
        mj, sd.domain_wall_state(mj, dtype=jnp.float32), 0.1, 4,
        Ebounds=bounds, cheb_n=30, checkpoint_dir=str(tmp_path / "j"),
        checkpoint_every=2)
    _, obs_t = pt.evolve_trajectory(
        mt, pt.domain_wall_state(mt, dtype=torch.complex64, device="cpu"),
        0.1, 4, Ebounds=bounds, cheb_n=30,
        checkpoint_dir=str(tmp_path / "t"), checkpoint_every=2)
    assert np.allclose(obs_t, obs_p, atol=5e-5)


def test_planes_trajectory_matches_jax_with_resume(tmp_path):
    """evolve_trajectory_planes against the JAX function (the JAX test's
    cases): float32 [2, N] planes and observables within 5e-5 of the JAX
    plane recurrence (the port runs the complex64 step), a run cut after
    5 of 8 steps and resumed (Ebounds from the metadata) equal to the
    uninterrupted one bit for bit, and a finished run's resume returning
    the saved state."""
    mj = sd.xxz_chain(8, Jxy=1.0, Jz=0.5, nup=4, dtype=jnp.float64)
    mt = model_from_numpy(8, 4, mj.hop_sites, np.asarray(mj.hop_J),
                          np.asarray(mj.field), mj.zz_sites,
                          np.asarray(mj.zz_J), layout="compact")
    bounds = (-8.0, 8.0)
    psi0 = np.asarray(sd.domain_wall_state(mj, dtype=jnp.float32))
    want_planes, want_obs = jru.evolve_trajectory_planes(
        mj, jnp.asarray(psi0), 0.1, 8, Ebounds=bounds, cheb_n=24)
    x0 = torch.tensor(psi0)
    planes, obs = pt.evolve_trajectory_planes(mt, x0, 0.1, 8,
                                              Ebounds=bounds, cheb_n=24)
    assert planes.shape == (2, mt.n_states) and planes.dtype == torch.float32
    assert obs.shape == want_obs.shape
    assert np.allclose(planes.numpy(), np.asarray(want_planes), atol=5e-5)
    assert np.allclose(obs, want_obs, atol=5e-5)
    ck = str(tmp_path / "traj")
    pt.evolve_trajectory_planes(mt, x0, 0.1, 5, Ebounds=bounds, cheb_n=24,
                                checkpoint_dir=ck, checkpoint_every=3)
    _, meta, extra = load_checkpoint(ck)
    assert meta["step"] == 5 and extra["obs"].shape == (5, 8)
    got_planes, got_obs = pt.evolve_trajectory_planes(
        mt, x0, 0.1, 8, cheb_n=24, checkpoint_dir=ck, checkpoint_every=3,
        resume=True)
    assert torch.equal(got_planes, planes)
    assert np.array_equal(got_obs, obs)
    again_planes, again_obs = pt.evolve_trajectory_planes(
        mt, x0, 0.1, 8, cheb_n=24, checkpoint_dir=ck, resume=True)
    assert torch.equal(again_planes, planes)
    assert np.array_equal(again_obs, obs)
    # a complex start and a [2, N] start are the same planes
    c0 = torch.complex(x0, torch.zeros_like(x0))
    for start in (c0, torch.stack([x0, torch.zeros_like(x0)])):
        p2, _ = pt.evolve_trajectory_planes(mt, start, 0.1, 2,
                                            Ebounds=bounds, cheb_n=24)
        assert torch.equal(p2, pt.evolve_trajectory_planes(
            mt, x0, 0.1, 2, Ebounds=bounds, cheb_n=24)[0])


def test_planes_trajectory_observables_contract(model):
    """As in the JAX package: resume needs a directory, a phase-sensitive
    `observe` without diagonal_in_z is refused, `observe_planes` gets the
    planes (here Re<psi0|psi(t)>, bounded by 1)."""
    psi0 = pt.neel_state(model, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="checkpoint_dir"):
        pt.evolve_trajectory_planes(model, psi0, 0.1, 2,
                                    Ebounds=(-8.0, 8.0), resume=True)
    with pytest.raises(ValueError, match="diagonal"):
        pt.evolve_trajectory_planes(model, psi0, 0.1, 2,
                                    Ebounds=(-6.0, 6.0), cheb_n=16,
                                    observe=lambda p, m: p[0])
    _, obs = pt.evolve_trajectory_planes(
        model, psi0, 0.1, 3, Ebounds=(-6.0, 6.0), cheb_n=16,
        observe_planes=lambda planes, m: torch.dot(psi0, planes[0]))
    assert obs.shape == (3,) and np.all(np.abs(obs) <= 1.0 + 1e-5)
