"""The port's row-sharded flat path against the JAX package's, on the CPU,
case by case after tests/test_sharding.py: LocalMesh(2, 4, 8) runs of the
port's sharded applies (the automatic route of matvec_fn / apply_H on a
model placed by shard_model, the all-gather and halo ELL applies, the
pairwise-exchange blocked apply) and of its flat solvers, observables and
trajectories on sharded states, against the JAX package's unsharded
functions in float64 at the JAX tests' tolerances; the halo plan against
JAX's build_halo_plan bit for bit; JAX's own shard_map applies on a
2-device mesh against LocalMesh(2); two gloo ranks against LocalMesh(2).
Inputs are made with numpy from a seed and go through both packages."""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu.parallel import mesh as jmesh
from spindynamics_tpu.parallel import sharded_apply as jsa
from spindynamics_tpu_torch.parallel import sharded_apply as tsa
from spindynamics_tpu_torch.utils.convert import (
    flat_tables_from_numpy, model_from_numpy)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_worker as worker  # noqa: E402

F64 = torch.float64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(L, Jz=0.5, nup=None, layout="compact", **kw):
    """(JAX model, port model) of one XXZ chain in float64."""
    mj = sd.xxz_chain(L, Jxy=1.0, Jz=Jz, nup=nup, dtype=jnp.float64,
                      layout=layout, **kw)
    mt = pt.xxz_chain(L, Jxy=1.0, Jz=Jz, nup=nup, dtype=F64,
                      layout=(layout if nup is not None else "full"), **kw)
    return mj, mt


@pytest.fixture(scope="module")
def problem():
    """The JAX tests' problem: the L=10 Sz=0 XXZ chain (N = 252) and a
    normalized complex state."""
    mj, mt = _pair(10, nup=5)
    rng = np.random.default_rng(0)
    psi = rng.normal(size=mj.n_states) + 1j * rng.normal(size=mj.n_states)
    psi /= np.linalg.norm(psi)
    return mj, mt, psi


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("D", [2, 4, 8])
def test_auto_matvec_matches(problem, D):
    """The same apply_H / matvec_fn, on a model placed by shard_model and
    a state placed by shard_state: the unsharded result, pad rows exactly
    zero (N = 252 pads to 256 at D = 8)."""
    mj, mt, psi = problem
    want = np.asarray(sd.apply_H(jnp.asarray(psi), mj))
    mesh = pt.LocalMesh(D, "cpu")
    m_sh = pt.shard_model(mt, mesh)
    psi_sh = pt.shard_state(_t(psi), mesh)
    for got in (pt.apply_H(psi_sh, m_sh),
                pt.matvec_fn(m_sh, device="cpu")(psi_sh)):
        got = got.numpy()
        assert got.shape[0] == m_sh.n_states == -(-252 // D) * D
        assert np.allclose(got[:mt.n_states], want, atol=1e-12)
        assert not got[mt.n_states:].any()


@pytest.mark.parametrize("halo", [False, True], ids=["gather", "halo"])
@pytest.mark.parametrize("D", [2, 8])
def test_shard_map_matvec_matches(problem, D, halo):
    """sharded_matvec_fn (all-gather) and sharded_matvec_halo_fn: the
    unsharded JAX apply at 1e-12; the padded tail stays exactly zero."""
    mj, mt, psi = problem
    want = np.asarray(sd.apply_H(jnp.asarray(psi), mj))
    fn = pt.sharded_matvec_halo_fn if halo else pt.sharded_matvec_fn
    mesh = pt.LocalMesh(D, "cpu")
    matvec, pm = fn(mt, mesh)
    full = matvec(pt.shard_state(_t(psi), mesh))
    got = pt.unpad_state(full, mt.n_states).numpy()
    assert np.allclose(got, want, atol=1e-12)
    assert not full[mt.n_states:].any()
    assert pm.dim == mt.n_states and pm.n_states == full.shape[0]


@pytest.mark.parametrize("D", [2, 4, 8])
def test_halo_matvec_no_full_allgather(problem, D):
    """The memory-scaling contract: the halo apply makes no all-gather,
    D-1 exchange rounds of D blocks of Hp amplitudes each; the all-gather
    apply one all-gather of D (D-1) blocks of B."""
    _, mt, psi = problem
    mesh = pt.LocalMesh(D, "cpu")
    x = pt.shard_state(_t(psi), mesh)
    matvec, pm = pt.sharded_matvec_halo_fn(mt, mesh)
    mesh.reset_counters()
    matvec(x)
    c = mesh.counters()
    assert c["n_all_gather"] == 0 and c["all_gather_bytes"] == 0
    assert c["n_permute"] == D - 1
    assert c["permute_bytes"] == D * (D - 1) * matvec.Hp * 16
    gather, _ = pt.sharded_matvec_fn(mt, mesh)
    mesh.reset_counters()
    gather(x)
    c = mesh.counters()
    assert (c["n_all_gather"], c["n_permute"]) == (1, 0)
    assert c["all_gather_bytes"] == D * (D - 1) * (pm.n_states // D) * 16


@pytest.mark.parametrize("kind", ["long_range", "convert"])
def test_halo_matvec_long_range(kind):
    """Non-nearest-neighbour bonds stress the halo plan (the remote sets
    differ per pair). `convert`: the JAX package's padded model and its
    diag and nbr arrays carried across (utils.convert), the port's
    padded build equal to them bit for bit."""
    L = 10
    hopping = ([(i, (i + 3) % L, 0.7) for i in range(L)]
               + [(i, i + 1, 1.0) for i in range(L - 1)])
    mj = sd.build_model(L, nup=4, hopping=hopping, dtype=jnp.float64,
                        build_neighbor_table=True)
    rng = np.random.default_rng(3)
    psi = rng.normal(size=mj.n_states)
    want = np.asarray(sd.apply_H(jnp.asarray(psi), mj))
    mesh = pt.LocalMesh(8, "cpu")
    tables = None
    if kind == "convert":
        pj = jsa.pad_model(mj, 8)
        mt = model_from_numpy(L, 4, mj.hop_sites, np.asarray(mj.hop_J),
                              np.asarray(mj.field), mj.zz_sites,
                              np.asarray(mj.zz_J), layout="compact",
                              n_states=pj.n_states)
        assert (mt.n_states, mt.dim) == (pj.n_states, pj.dim)
        states, diag, nbr = pt.model.sector_setup(mt, "cpu")
        np.testing.assert_array_equal(states.numpy(), np.asarray(pj.states))
        np.testing.assert_array_equal(diag.numpy(), np.asarray(pj.diag))
        np.testing.assert_array_equal(nbr.numpy(), np.asarray(pj.nbr))
        np.testing.assert_array_equal(mt.valid_mask().numpy(),
                                      np.asarray(pj.valid_mask()))
        tables = flat_tables_from_numpy(pj.diag, pj.nbr, "cpu")
    else:
        mt = pt.build_model(L, nup=4, hopping=hopping, dtype=F64,
                            layout="compact")
    matvec, _ = pt.sharded_matvec_halo_fn(mt, mesh, tables=tables)
    got = matvec(pt.shard_state(_t(psi), mesh))[:mj.n_states].numpy()
    assert np.allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("D", [2, 3, 4, 8])
@pytest.mark.parametrize("L,nup,long_range", [(10, 5, False), (10, 4, True),
                                              (12, 6, False)])
def test_halo_plan_matches_jax_bit_for_bit(L, nup, long_range, D):
    """build_halo_plan (numpy) and build_halo_plan_torch equal JAX's
    build_halo_plan on the same padded table, bit for bit."""
    hopping = [(i, i + 1, 1.0) for i in range(L - 1)]
    if long_range:
        hopping += [(i, (i + 3) % L, 0.7) for i in range(L)]
    mj = sd.build_model(L, nup=nup, hopping=hopping, dtype=jnp.float64,
                        build_neighbor_table=True)
    pj = jsa.pad_model(mj, D)
    nbr = np.asarray(pj.nbr)
    want = jsa.build_halo_plan(nbr, pj.n_states, D)
    got = tsa.build_halo_plan(nbr, pj.n_states, D)
    got_t = tsa.build_halo_plan_torch(torch.tensor(nbr), pj.n_states, D)
    assert got[2] == want[2] == got_t[2]
    for a, b, c in zip(got[:2], want[:2], got_t[:2]):
        assert a.dtype == b.dtype == np.int32 and c.dtype == torch.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c.numpy(), b)


@pytest.mark.parametrize("D", [4, 8])
def test_sharded_lanczos_groundstate(problem, D):
    """The solver stack on sharded states: E0 of the padded model (mask
    from its valid rows) equals the JAX unsharded E0 to 1e-9; the Ritz
    vector has no weight on the pad rows; estimate_energy_bounds runs on
    the same matvec."""
    mj, mt, _ = problem
    E0_j, _, _ = sd.lanczos_groundstate(sd.matvec_fn(mj), mj.n_states,
                                        lanc_m=50, dtype=jnp.float64)
    m_sh = pt.shard_model(mt, pt.LocalMesh(D, "cpu"))
    mv = pt.matvec_fn(m_sh, device="cpu")
    E0, psi, info = pt.lanczos_groundstate(
        mv, m_sh.n_states, lanc_m=50, dtype=F64, mask=m_sh.valid_mask(),
        generator=torch.Generator().manual_seed(0), device="cpu")
    assert E0 == pytest.approx(float(E0_j), abs=1e-9)
    assert info["residual"] < 1e-6
    assert not psi[mt.n_states:].any()
    lo, hi = pt.estimate_energy_bounds(
        mv, m_sh.n_states, dtype=F64, mask=m_sh.valid_mask(),
        generator=torch.Generator().manual_seed(1), device="cpu")
    assert lo <= E0 + 1e-9 and hi > lo


@pytest.mark.parametrize("D", [2, 8])
def test_sharded_chebyshev_evolution(problem, D):
    mj, mt, psi = problem
    bounds = (-8.0, 8.0)
    want = np.asarray(sd.chebyshev_time_evolve(
        jnp.asarray(psi), sd.matvec_fn(mj), 0.1, bounds, cheb_n=24))
    m_sh = pt.shard_model(mt, pt.LocalMesh(D, "cpu"))
    got = pt.chebyshev_time_evolve(pt.shard_state(_t(psi), m_sh.mesh),
                                   pt.matvec_fn(m_sh, device="cpu"), 0.1,
                                   bounds, cheb_n=24).numpy()
    assert np.allclose(got[:mt.n_states], want, atol=1e-11)
    assert not got[mt.n_states:].any()


@pytest.mark.parametrize("D", [2, 8])
def test_sharded_observables(problem, D):
    """<Sz_i> of a sharded state (pad rows excluded) equals JAX's."""
    mj, mt, psi = problem
    want = np.asarray(sd.magnetization_per_site(jnp.asarray(psi), mj))
    m_sh = pt.shard_model(mt, pt.LocalMesh(D, "cpu"))
    got = pt.magnetization_per_site(pt.shard_state(_t(psi), m_sh.mesh), m_sh)
    assert np.allclose(got.numpy(), want, atol=1e-12)
    from spindynamics_tpu.observables import szsz_matrix

    zz, si = pt.szsz_matrix(pt.shard_state(_t(psi), m_sh.mesh), m_sh)
    zzj, sij = szsz_matrix(jnp.asarray(psi), mj)
    assert np.allclose(zz.numpy(), np.asarray(zzj), atol=1e-12)
    assert np.allclose(si.numpy(), np.asarray(sij), atol=1e-12)


@pytest.mark.parametrize("backend", ["tensor", "blocked"])
def test_sharded_full_mode(backend):
    """Full-space models on a sharded state (the JAX tests' tensor backend
    at L=8 and blocked backend at L=10): the sharded blocked apply,
    which computes the same H as either backend."""
    L = 8 if backend == "tensor" else 10
    mj = sd.xxz_chain(L, Jxy=1.0, Jz=0.3, nup=None, dtype=jnp.float64,
                      build_neighbor_table=False)
    mt = pt.xxz_chain(L, Jxy=1.0, Jz=0.3, nup=None, dtype=F64)
    rng = np.random.default_rng(1 if backend == "tensor" else 3)
    psi = rng.normal(size=mj.n_states)
    want = np.asarray(sd.apply_H(jnp.asarray(psi), mj, backend=backend))
    mesh = pt.LocalMesh(8, "cpu")
    mv = pt.matvec_fn(mt, backend=backend, mesh=mesh, device="cpu")
    assert mv.sharded is not None and mv.backend == backend
    got = mv(pt.shard_state(_t(psi), mesh)).numpy()
    assert np.allclose(got, want, atol=1e-12)
    assert mesh.counters()["n_permute"] > 0


def test_sharded_embedded_groundstate():
    """Embedded layout + sharded blocked apply + sharded state: the
    ground state equals the JAX compact one to 1e-9."""
    mj = sd.xxz_chain(10, Jxy=1.0, Jz=0.5, nup=5, dtype=jnp.float64)
    E0_j, _, _ = sd.lanczos_groundstate(sd.matvec_fn(mj), mj.n_states,
                                        lanc_m=50, dtype=jnp.float64)
    mt = pt.xxz_chain(10, Jxy=1.0, Jz=0.5, nup=5, dtype=F64,
                      layout="embedded")
    m_sh = pt.shard_model(mt, pt.LocalMesh(8, "cpu"))
    E0, psi, info = pt.lanczos_groundstate(
        pt.matvec_fn(m_sh, device="cpu"), m_sh.n_states, lanc_m=50,
        dtype=F64, mask=m_sh.valid_mask(),
        generator=torch.Generator().manual_seed(0), device="cpu")
    assert E0 == pytest.approx(float(E0_j), abs=1e-9)
    assert not psi[~m_sh.valid_mask()].any()


@pytest.mark.parametrize("nup", [None, 6], ids=["full", "embedded"])
def test_sharded_blocked_explicit_exchange(nup):
    """sharded_blocked_matvec_fn (a pairwise exchange per crossing bond)
    equals the JAX blocked apply, full and embedded, plan (3, 3): B = 64
    blocks over 8 shards."""
    from spindynamics_tpu.ops.blocked import make_blocked_plan as jplan
    from spindynamics_tpu_torch.ops.blocked import make_blocked_plan

    mj = sd.xxz_chain(12, Jxy=1.0, Jz=0.4, nup=nup, dtype=jnp.float64,
                      layout="embedded" if nup else "compact",
                      build_neighbor_table=False)
    mt = pt.xxz_chain(12, Jxy=1.0, Jz=0.4, nup=nup, dtype=F64,
                      layout="embedded" if nup else "full")
    psi = np.random.default_rng(11).normal(size=mj.n_states)
    want = np.asarray(sd.apply_H(jnp.asarray(psi), mj, backend="blocked"))
    assert jplan(mj, 3, 3).special == make_blocked_plan(mt, 3, 3).special
    mesh = pt.LocalMesh(8, "cpu")
    mv = pt.sharded_blocked_matvec_fn(mt, mesh,
                                      plan=make_blocked_plan(mt, 3, 3))
    got = mv(pt.shard_state(_t(psi), mesh)).numpy()
    assert np.allclose(got, want, atol=1e-12), np.abs(got - want).max()
    assert mesh.counters()["n_permute"] == len(mv.crossing) > 0


def test_sharded_blocked_long_range():
    """Long-range model: crossing bonds with residual local flips."""
    from spindynamics_tpu_torch.ops.blocked import make_blocked_plan

    J = lambda i, j: 1.0 / (j - i) ** 2  # noqa: E731
    mj = sd.long_range_xy_chain(10, J, nup=None, dtype=jnp.float64,
                                build_neighbor_table=False)
    mt = pt.long_range_xy_chain(10, J, nup=None, dtype=F64)
    psi = np.random.default_rng(13).normal(size=mj.n_states)
    want = np.asarray(sd.apply_H(jnp.asarray(psi), mj, backend="blocked"))
    mesh = pt.LocalMesh(8, "cpu")
    mv = pt.sharded_blocked_matvec_fn(mt, mesh,
                                      plan=make_blocked_plan(mt, 2, 2))
    assert any(c[2] for c in mv.crossing)  # a residual local flip
    got = mv(pt.shard_state(_t(psi), mesh)).numpy()
    assert np.allclose(got, want, atol=1e-12), np.abs(got - want).max()


def test_sharded_planes_trajectory():
    """The plane trajectory with each plane sharded over the mesh: one
    step equals the JAX plane recurrence's (float32, 1e-6), and the
    observables the unsharded port run's."""
    from spindynamics_tpu.solvers.planes import chebyshev_time_evolve_planes

    mj = sd.xxz_chain(10, Jxy=1.0, Jz=0.5, nup=5, dtype=jnp.float64,
                      layout="embedded")
    mt = pt.xxz_chain(10, Jxy=1.0, Jz=0.5, nup=5, dtype=F64,
                      layout="embedded")
    psi0 = np.asarray(sd.domain_wall_state(mj, dtype=jnp.float32))
    planes = jnp.stack([jnp.asarray(psi0), jnp.zeros_like(psi0)])
    bounds = (-8.0, 8.0)
    want = np.asarray(chebyshev_time_evolve_planes(planes, mj, 0.2, bounds,
                                                   cheb_n=24))
    mesh = pt.LocalMesh(8, "cpu")
    got, obs = pt.evolve_trajectory_planes(mt, _t(psi0), 0.2, 1,
                                           Ebounds=bounds, cheb_n=24,
                                           mesh=mesh)
    assert got.shape == (2, mt.n_states) and got.dtype == torch.float32
    assert np.allclose(got.numpy(), want, atol=1e-6)
    _, obs1 = pt.evolve_trajectory_planes(mt, _t(psi0), 0.2, 1,
                                          Ebounds=bounds, cheb_n=24,
                                          device="cpu")
    assert np.allclose(obs, obs1, atol=1e-6)


def test_sharded_trajectory_matches_unsharded(problem):
    """evolve_trajectory with mesh= (the state padded and kept sharded)
    against the unsharded run: <Sz_i> per step within 1e-12."""
    _, mt, _ = problem
    psi0 = pt.domain_wall_state(mt, dtype=F64, device="cpu")
    _, want = pt.evolve_trajectory(mt, psi0, 0.1, 3, cheb_n=24,
                                   Ebounds=(-8.0, 8.0))
    mesh = pt.LocalMesh(8, "cpu")
    psi, got = pt.evolve_trajectory(mt, psi0, 0.1, 3, cheb_n=24,
                                    Ebounds=(-8.0, 8.0), mesh=mesh)
    assert psi.shape[0] == 256 and not psi[mt.n_states:].any()
    assert np.allclose(got, want, atol=1e-12)


def test_jax_halo_apply_on_two_devices(problem):
    """JAX's own sharded_matvec_halo_fn and sharded_matvec_fn on a
    2-device mesh against the port's on LocalMesh(2): the same padded
    rows and the same halo plan size."""
    mj, mt, psi = problem
    jm = jmesh.make_mesh(2)
    mv_j, pj = jsa.sharded_matvec_halo_fn(mj, jm)
    want = np.asarray(mv_j(jmesh.shard_state(jsa.pad_state(
        jnp.asarray(psi), 2), jm)))
    mesh = pt.LocalMesh(2, "cpu")
    mv, pm = pt.sharded_matvec_halo_fn(mt, mesh)
    got = mv(pt.shard_state(_t(psi), mesh)).numpy()
    assert pm.n_states == pj.n_states
    assert mv.Hp == jsa.build_halo_plan(np.asarray(pj.nbr), pj.n_states,
                                        2)[2]
    assert np.allclose(got, want, atol=1e-12)
    mv_g, _ = jsa.sharded_matvec_fn(mj, jm)
    want_g = np.asarray(mv_g(jmesh.shard_state(jnp.asarray(psi), jm)))
    got_g = pt.sharded_matvec_fn(mt, mesh)[0](
        pt.shard_state(_t(psi), mesh)).numpy()
    assert np.allclose(got_g, want_g, atol=1e-12)


def test_jax_sharded_blocked_on_two_devices():
    """JAX's sharded_blocked_matvec_fn on a 2-device mesh against the
    port's on LocalMesh(2), embedded L=12, plan (3, 3)."""
    from spindynamics_tpu.ops.blocked import make_blocked_plan as jplan
    from spindynamics_tpu.parallel.sharded_blocked import (
        sharded_blocked_matvec_fn as jsb)
    from spindynamics_tpu_torch.ops.blocked import make_blocked_plan

    mj = sd.xxz_chain(12, Jxy=1.0, Jz=0.4, nup=6, dtype=jnp.float64,
                      layout="embedded", build_neighbor_table=False)
    mt = pt.xxz_chain(12, Jxy=1.0, Jz=0.4, nup=6, dtype=F64,
                      layout="embedded")
    psi = np.random.default_rng(17).normal(size=mj.n_states)
    jm = jmesh.make_mesh(2)
    want = np.asarray(jsb(mj, jm, plan=jplan(mj, 3, 3))(
        jmesh.shard_state(jnp.asarray(psi), jm)))
    mesh = pt.LocalMesh(2, "cpu")
    got = pt.sharded_blocked_matvec_fn(mt, mesh,
                                       plan=make_blocked_plan(mt, 3, 3))(
        pt.shard_state(_t(psi), mesh)).numpy()
    assert np.allclose(got, want, atol=1e-12)


def test_sharded_routes_refuse_what_has_no_sharded_form():
    """With a mesh, K3 ('fused') and the sector_blocked layout raise, and
    so does a shard count the blocked apply cannot place: no sharded
    state falls back to an unsharded apply."""
    m = pt.xxz_chain(10, nup=5, layout="embedded")
    with pytest.raises(ValueError, match="no sharded form"):
        pt.matvec_fn(m, backend="fused", mesh=pt.LocalMesh(2, "cpu"))
    with pytest.raises(ValueError, match="power of two"):
        pt.matvec_fn(m, mesh=pt.LocalMesh(3, "cpu"))
    sb = pt.xxz_chain(10, nup=5, layout="sector_blocked")
    with pytest.raises(ValueError, match="no sharded form"):
        pt.matvec_fn(sb, mesh=pt.LocalMesh(2, "cpu"))
    with pytest.raises(ValueError, match="flat models"):
        pt.pad_model(pt.xxz_chain(10, nup=5), 4)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_process_mesh_two_ranks_match_local_mesh(tmp_path):
    """Two gloo ranks, each holding only its rows: the halo and
    all-gather applies, the blocked apply, the ground state, one
    Chebyshev step, <Sz_i> and both trajectories equal the LocalMesh(2)
    run (float64; the rows at 1e-12, E0 at 1e-10); each rank's exchange
    bytes are half the LocalMesh counters'."""
    L = 10
    port = _free_port()
    cmd = [sys.executable, worker.__file__]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd + [str(r), "2", str(port), str(L),
                                     str(tmp_path), "flat"], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:  # a hung rank never outlives the test
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    ref = worker.run_flat_case(L, pt.LocalMesh(2, "cpu"))
    B = int(ref["rows"]) // 2
    for r, got in enumerate(ranks):
        assert int(got["rows"]) == B
        rows = slice(r * B, (r + 1) * B)
        for k in ("halo", "gather", "psi", "cheb", "traj_psi"):
            assert np.allclose(got[k], ref[k][rows], atol=1e-12), k
        assert np.allclose(got["blocked"], ref["blocked"][
            r * ref["blocked"].shape[0] // 2:
            (r + 1) * ref["blocked"].shape[0] // 2], atol=1e-12)
        assert np.allclose(got["planes"], ref["planes"][:, rows], atol=1e-6)
        for k in ("mag", "traj", "planes_obs"):
            assert np.allclose(got[k], ref[k], atol=1e-12), k
        assert abs(float(got["E0"]) - float(ref["E0"])) <= 1e-10
        assert float(got["residual"]) < 1e-6
        for k in ("all_gather_bytes", "permute_bytes"):
            assert 2 * int(got[f"cnt_{k}"]) == int(ref[f"cnt_{k}"]), k
