"""The port's sharded kron path (`mesh=`) against the JAX package's, on the
CPU: the shard spec and the state maps, the block-distributed apply on a
LocalMesh (fused: the plain version of K1's crossw variant; and unfused)
against the JAX sharded apply on its virtual-device CPU mesh (Pallas in
interpret mode), the x64 oracle and the port's own unsharded apply; the
collective traffic model and the meshes' counters; a two-process ProcessMesh
over gloo against LocalMesh(2); the six `mesh=` entry points and the sharded
observables against their JAX `mesh=` runs. Inputs are made with numpy from
a seed and go through both packages. The crossw kernel itself runs on the
card (chip_smoke.py, tests/test_torch_cuda.py); its descriptor and tile
arithmetic are emulated in tests/test_torch_kron_group.py.
"""

import inspect
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu.ops import sector_kron as jsk
from spindynamics_tpu.parallel import sharded_kron_scaling as jss
from spindynamics_tpu.solvers.blockvec import BlockVec as JBlockVec
from spindynamics_tpu_torch.ops import kron_group as kg
from spindynamics_tpu_torch.ops import sector_kron as tsk
from spindynamics_tpu_torch.parallel import sharded_kron_scaling as tss
from spindynamics_tpu_torch.utils.convert import (
    blockvec_from_numpy, blockvec_to_numpy)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_dist_worker as worker  # noqa: E402

_JDT = {"f32": jnp.float32, "f64": jnp.float64, "bf16": jnp.bfloat16}
_TDT = {"f32": torch.float32, "f64": torch.float64}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(D):
    return Mesh(np.array(jax.devices()[:D]), ("rows",))


def _models(L, splits=None, Jz=0.7, field=False, jdt="f32", tdt="f32"):
    """(JAX model, its layout, port model, its layout) of one XXZ chain."""
    fld = np.linspace(-0.2, 0.3, L) if field else None
    kw = dict(Jxy=1.0, Jz=Jz, h=fld, nup=L // 2, kron_splits=splits)
    mj = sd.xxz_chain(L, dtype=_JDT[jdt], layout="sector_kron", **kw)
    mt = pt.xxz_chain(L, dtype=_TDT[tdt], **kw)
    return (mj, jsk.make_sector_kron_layout(mj, mj.kron_splits, mj.kron_pads),
            mt, tsk.make_sector_kron_layout(mt, mt.kron_splits))


def _longrange(L, splits, jdt="f64", tdt="f64"):
    hop = [(i, j, 0.3 + 0.1 * (i + j)) for i in range(L)
           for j in range(i + 1, L)]
    zz = [(i, i + 1, 0.2) for i in range(L - 1)] + [(0, L - 1, 0.15)]
    kw = dict(nup=L // 2, hopping=hop, zz=zz,
              onsite_field=np.linspace(-0.1, 0.2, L), kron_splits=splits)
    mj = sd.build_model(L, dtype=_JDT[jdt], layout="sector_kron", **kw)
    mt = pt.build_model(L, dtype=_TDT[tdt], **kw)
    return (mj, jsk.make_sector_kron_layout(mj, mj.kron_splits, mj.kron_pads),
            mt, tsk.make_sector_kron_layout(mt, mt.kron_splits))


def _leaves(lay, seed, dtype=np.float32):
    """Plain numpy leaves [ch, cmp, clp], zero on the tile pads."""
    return [l.astype(dtype) for l in worker.case_state(lay, seed)]


def _jsharded(leaves, spec, mesh, dtype=None):
    """JAX BlockVec in sharded form on `mesh` from plain numpy leaves."""
    bv = JBlockVec([jnp.asarray(l, dtype) for l in leaves])
    sh = NamedSharding(mesh, P("rows"))
    return JBlockVec([jax.device_put(l, sh)
                      for l in jss.shard_kron_blockvec(bv, spec).leaves])


def _oracle64(mj64, lay64, leaves):
    """The x64 blocks apply of the JAX package on the given leaves."""
    y = jsk.apply_H_sector_kron([jnp.asarray(l, jnp.float64) for l in leaves],
                                None, lay64)
    return [np.asarray(l) for l in y]


def _max_err(a_leaves, b_leaves):
    return max(float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())
               for a, b in zip(a_leaves, b_leaves))


def _port_apply(mt, leaves, D, dtype=torch.float32, **kw):
    """(plain numpy output leaves, H, mesh) of the port's sharded apply."""
    mesh = pt.LocalMesh(D, "cpu")
    H, lay, spec = pt.sharded_kron_scaling_bv_matvec_fn(mt, mesh, **kw)
    x = blockvec_from_numpy(leaves, "cpu", dtype=dtype, spec=spec, mesh=mesh)
    mesh.reset_counters()
    y = H(x)
    assert y.mesh is mesh and y.dtype == dtype
    return blockvec_to_numpy(y, spec), H, mesh


# ---- the shard spec and the state maps -------------------------------------


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_shard_spec_and_state_maps_match_jax(D):
    mj, lj, mt, lt = _models(16, (6, 4, 6))
    sj, st = jss.kron_shard_spec(lj, D), pt.kron_shard_spec(lt, D)
    for name in ("D", "b", "ch_pad", "local_offsets", "local_len",
                 "n_sharded"):
        assert getattr(sj, name) == getattr(st, name), name
    x = np.random.default_rng(D).standard_normal(lt.n_states).astype(
        np.float32)
    xs_j = np.asarray(jss.shard_kron_state(jnp.asarray(x), sj))
    xs_t = tss.shard_kron_state(torch.as_tensor(x), st)
    assert np.array_equal(xs_j, xs_t.numpy())  # same order, exactly
    assert np.array_equal(tss.unshard_kron_state(xs_t, st).numpy(), x)
    bv = pt.BlockVec(tsk.flat_to_blocks(torch.as_tensor(x), lt))
    sh = pt.shard_kron_blockvec(bv, st)
    for l, lj_, chp in zip(sh.leaves, jss.shard_kron_blockvec(
            JBlockVec(jsk.flat_to_blocks(jnp.asarray(x), lj)), sj).leaves,
            st.ch_pad):
        assert l.shape[0] == chp and np.array_equal(l.numpy(),
                                                    np.asarray(lj_))
    for a, b in zip(pt.unshard_kron_blockvec(sh, st).leaves, bv.leaves):
        assert torch.equal(a, b)


def test_convert_takes_the_sharded_form():
    """JAX sharded leaves as numpy arrays carry across: whole [D*b, ...]
    leaves or plain ones give the same sharded BlockVec, and back."""
    mj, lj, mt, lt = _models(14, (6, 4, 4))
    spec = pt.kron_shard_spec(lt, 4)
    plain = _leaves(lt, 2)
    jsh = [np.asarray(l) for l in jss.shard_kron_blockvec(
        JBlockVec([jnp.asarray(l) for l in plain]),
        jss.kron_shard_spec(lj, 4)).leaves]
    mesh = pt.LocalMesh(4, "cpu")
    a = blockvec_from_numpy(jsh, "cpu", spec=spec, mesh=mesh)
    b = blockvec_from_numpy(plain, "cpu", spec=spec, mesh=mesh)
    assert a.mesh is mesh and tss.is_sharded_form(a, spec, mesh)
    for x, y, z in zip(a.leaves, b.leaves, jsh):
        assert torch.equal(x, y) and np.array_equal(x.numpy(), z)
    for x, y in zip(blockvec_to_numpy(a, spec), plain):
        assert np.array_equal(x, y)
    with pytest.raises(ValueError, match="both spec and mesh"):
        blockvec_from_numpy(plain, "cpu", spec=spec)


# ---- the sharded apply ------------------------------------------------------


@pytest.fixture(scope="module")
def l16():
    """L=16, splits (6, 4, 6), a field: hi axes up to 20 rows, so local
    blocks have b > 1 and windows cross shard boundaries (the JAX tests'
    case), with the x64 oracle and the port's unsharded fused apply."""
    mj, lj, mt, lt = _models(16, (6, 4, 6), field=True)
    mj64, lj64, _, _ = _models(16, (6, 4, 6), field=True, jdt="f64")
    x = _leaves(lt, 3)
    y64 = _oracle64(mj64, lj64, x)
    H0 = pt.KronHamiltonian(lt, device="cpu")
    y0 = blockvec_to_numpy(H0(blockvec_from_numpy(x, "cpu")))
    return mj, lj, mt, lt, x, y64, y0


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_sharded_apply_matches_x64_and_unsharded(l16, D, fused):
    """LocalMesh(D) apply against the x64 oracle (1e-5 of max|y|, the JAX
    tests' bound) and the port's unsharded fused apply (2e-6: the same
    float32 sums, the W_hi partials added in another order); hi padding
    rows exactly 0."""
    mj, lj, mt, lt, x, y64, y0 = l16
    y, H, mesh = _port_apply(mt, x, D, use_fused=fused)
    scale = max(float(np.abs(b).max()) for b in y64)
    assert _max_err(y, y64) <= 1e-5 * scale
    assert _max_err(y, y0) <= 2e-6 * scale
    xs = blockvec_from_numpy(x, "cpu", spec=H.spec, mesh=mesh)
    for l, (_, _, _, ch, cm, cl, _, _) in zip(H(xs).leaves, lt.groups):
        assert not l[ch:].any()
        assert not l[:, cm:].any() and not l[:, :, cl:].any()


@pytest.mark.parametrize("D,fused", [(4, True), (2, False), (4, False),
                                     (1, False)])
def test_sharded_apply_matches_jax_sharded(l16, D, fused):
    """Against the JAX sharded BlockVec apply on D virtual devices (fused:
    its Pallas kernel with crossw windows, interpret mode): 2e-6 of max|y|,
    the band the JAX tests hold between their sharded and single-device
    fused applies. (At most 4 devices: see the note on the JAX reference
    runs below.)"""
    mj, lj, mt, lt, x, y64, y0 = l16
    mesh = _jmesh(D)
    mv, _, spec = jss.sharded_kron_scaling_bv_matvec_fn(mj, mesh,
                                                        use_fused=fused)
    yj = jss.unshard_kron_blockvec(mv(_jsharded(x, spec, mesh)), spec)
    y, _, _ = _port_apply(mt, x, D, use_fused=fused)
    scale = max(float(np.abs(b).max()) for b in y64)
    assert _max_err(y, [np.asarray(l) for l in yj.leaves]) <= 2e-6 * scale


def test_single_device_mesh_runs_the_unsharded_launches(l16):
    """D == 1: nothing is windowed, the mid|hi terms are K1's shifted reads
    of the source groups, and the result is the unsharded fused apply's,
    bit for bit."""
    mj, lj, mt, lt, x, y64, y0 = l16
    y, H, mesh = _port_apply(mt, x, 1)
    assert H.cfg is not None and not H.cfg.windowed
    assert H.cfg.win_order == [] and H.cfg.moves == ()
    assert mesh.counters()["window_bytes"] == 0
    calls = H._state()[1][0]["calls"]
    assert any(c.crossh for c in calls if c is not None)
    assert not any(c.crossw for c in calls if c is not None)
    for a, b in zip(y, y0):
        assert np.array_equal(a, b)


def test_sharded_apply_of_some_groups(l16):
    """forward(bv, groups=...) (the bucketed Ritz finalize's call): those
    groups' outputs equal the full apply's, the others are None, and only
    their partials are scattered."""
    mj, lj, mt, lt, x, y64, y0 = l16
    mesh = pt.LocalMesh(4, "cpu")
    H = pt.ShardedKronHamiltonian(lt, mesh, device="cpu")
    xs = blockvec_from_numpy(x, "cpu", spec=H.spec, mesh=mesh)
    full = H(xs)
    n_all = mesh.counters()["n_reduce_scatter"]
    keep = (0, 5, len(lt.groups) - 1)
    mesh.reset_counters()
    part = H(xs, groups=keep)
    assert 0 < mesh.counters()["n_reduce_scatter"] < n_all
    for gi, (a, b) in enumerate(zip(part.leaves, full.leaves)):
        assert (a is None) if gi not in keep else torch.equal(a, b)
    # only the windows those groups read are exchanged: over a partition
    # of the groups (the finalize's buckets) the traffic adds up to one
    # whole apply's, the model's
    model = pt.collective_traffic_model(lt, H.spec, H.cfg)
    edges = np.linspace(0, len(lt.groups), 5).astype(int)
    mesh.reset_counters()
    per_bucket = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        before = mesh.window_bytes
        H(xs, groups=range(lo, hi))
        per_bucket.append(mesh.window_bytes - before)
    cnt = mesh.counters()
    for k in ("n_reduce_scatter", "reduce_scatter_bytes", "window_bytes"):
        assert cnt[k] == model[k], k
    assert max(per_bucket) < model["window_bytes"]


def test_sharded_bf16_amplitude_mode():
    """bfloat16 states on the sharded path (L=14, splits (6, 4, 4), D=4):
    float32 partials and sums, bfloat16 seeds, windows and outputs. 2e-2 of
    max|y| against the x64 oracle and against the JAX bf16 sharded apply
    (the JAX test's bound: one rounding of the state's 8 bits)."""
    mj, lj, mt, lt = _models(14, (6, 4, 4), jdt="bf16")
    mj64, lj64, _, _ = _models(14, (6, 4, 4), jdt="f64")
    x = [np.asarray(jnp.asarray(l).astype(jnp.bfloat16).astype(jnp.float32))
         for l in _leaves(lt, 4)]  # bf16-representable inputs
    y64 = _oracle64(mj64, lj64, x)
    scale = max(float(np.abs(b).max()) for b in y64)
    mesh = _jmesh(4)
    mv, _, spec = jss.sharded_kron_scaling_bv_matvec_fn(mj, mesh)
    yj = jss.unshard_kron_blockvec(
        mv(_jsharded(x, spec, mesh, jnp.bfloat16)), spec)
    y, H, tmesh = _port_apply(mt, x, 4, dtype=torch.bfloat16)
    assert _max_err(y, y64) <= 2e-2 * scale
    assert _max_err(y, [np.asarray(l, np.float32) for l in yj.leaves]
                    ) <= 2e-2 * scale
    # windows travel in the state type: half the float32 bytes
    model = pt.collective_traffic_model(lt, H.spec, H.cfg, itemsize=2)
    assert tmesh.counters()["window_bytes"] == model["window_bytes"] > 0


@pytest.mark.parametrize("D", [1, 2])
def test_zext_guard_regression_khmax_tail_groups(D):
    """The hi-run placement of _hi_partial with a SOURCE hi axis larger than
    the destination's (k_h-max groups), small D and tail groups forced with
    top_k=8: the JAX package needs a scratch three hi axes long there (an
    undersized one put the slab on the wrong rows); the port places static
    slices. Against the x64 oracle (1e-5) and the JAX sharded apply (5e-6:
    most groups are tail groups here, float32 products through XLA there
    and through torch here, summed in other orders)."""
    mj, lj, mt, lt = _models(14, (6, 4, 4))
    mj64, lj64, _, _ = _models(14, (6, 4, 4), jdt="f64")
    x = _leaves(lt, 6)
    y64 = _oracle64(mj64, lj64, x)
    scale = max(float(np.abs(b).max()) for b in y64)
    y, H, _ = _port_apply(mt, x, D, top_k=8)
    assert len(H.cfg.fused_set) == 8 < len(lt.groups)
    assert any(lt.groups[g_src][3] > lt.groups[gi][3]
               for gi in range(len(lt.groups)) if gi not in H.cfg.fused_set
               for (g_src, pa, pb, _, _) in lt.cross_meta[gi] if 2 in (pa, pb))
    assert _max_err(y, y64) <= 1e-5 * scale
    mesh = _jmesh(D)
    mv, _, spec = jss.sharded_kron_scaling_bv_matvec_fn(mj, mesh, top_k=8)
    yj = jss.unshard_kron_blockvec(mv(_jsharded(x, spec, mesh)), spec)
    assert _max_err(y, [np.asarray(l) for l in yj.leaves]) <= 5e-6 * scale


@pytest.mark.parametrize("D", [2, 4])
def test_long_range_bonds_fall_to_the_scatter(D):
    """All-pairs hopping: mid|hi and lo|hi terms that are not run x run
    (unfusable crossh) go into the reduce-scattered partial, multi-run
    local factors through _runs_to_matrix, and K1's unsupported lo|mid
    entries through the generic path. float64 unfused against the JAX x64
    apply (1e-10) and the JAX float64 sharded apply (1e-6: its multi-run
    factors pass through a float32 matrix, the port's stay float64);
    float32 fused against the oracle at 1e-5."""
    mj, lj, mt, lt = _longrange(10, (4, 3, 3))
    x = _leaves(lt, 7, np.float64)
    y64 = _oracle64(mj, lj, x)
    scale = max(float(np.abs(b).max()) for b in y64)
    y, H, _ = _port_apply(mt, x, D, dtype=torch.float64)
    assert H.cfg is None
    assert _max_err(y, y64) <= 1e-10 * scale
    mesh = _jmesh(D)
    mv, _, spec = jss.sharded_kron_scaling_bv_matvec_fn(mj, mesh,
                                                        use_fused=False)
    yj = jss.unshard_kron_blockvec(
        mv(_jsharded(x, spec, mesh, jnp.float64)), spec)
    assert _max_err(y, [np.asarray(l) for l in yj.leaves]) <= 1e-6 * scale
    _, _, mt32, lt32 = _longrange(10, (4, 3, 3), tdt="f32")
    y32, H32, _ = _port_apply(mt32, [l.astype(np.float32) for l in x], D)
    plans = H32.cfg.plans
    assert any(not p.crossh_fusable for p in plans)
    assert any(p.unsupported for p in plans)
    assert _max_err(y32, y64) <= 1e-5 * scale
    with pytest.raises(ValueError, match="float32"):
        pt.sharded_kron_scaling_bv_matvec_fn(mt, pt.LocalMesh(D, "cpu"),
                                             use_fused=True)


def test_flat_form_round_trip(l16):
    """The flat wrapper keeps the JAX signature and ordering: a flat
    block-distributed state in, the same out, equal to the JAX flat
    sharded matvec."""
    mj, lj, mt, lt, x, y64, y0 = l16
    flat = np.concatenate([l.reshape(-1) for l in x])
    mesh = _jmesh(4)
    mvj, _, sj = jss.sharded_kron_scaling_matvec_fn(mj, mesh, use_fused=False)
    xs = jax.device_put(jss.shard_kron_state(jnp.asarray(flat), sj),
                        NamedSharding(mesh, P("rows")))
    yj = np.asarray(jss.unshard_kron_state(mvj(xs), sj))
    mv, lay, spec = tss.sharded_kron_scaling_matvec_fn(
        mt, pt.LocalMesh(4, "cpu"), use_fused=False)
    ys = mv(tss.shard_kron_state(torch.as_tensor(flat), spec))
    assert ys.shape == (spec.n_sharded,)
    y = tss.unshard_kron_state(ys, spec).numpy()
    scale = float(np.abs(yj).max())
    assert np.abs(y - yj).max() <= 2e-6 * scale


# ---- collectives: the model, the counters, the schedule ---------------------


@pytest.mark.parametrize("D,fused", [(8, True), (2, True), (4, False)])
def test_traffic_model_matches_jax_and_counters(l16, D, fused):
    mj, lj, mt, lt, x, y64, y0 = l16
    mvj, _, sj = jss.sharded_kron_scaling_bv_matvec_fn(mj, _jmesh(D),
                                                       use_fused=fused)
    want = jss.collective_traffic_model(lj, sj, mvj._cfg)
    _, H, mesh = _port_apply(mt, x, D, use_fused=fused)
    got = pt.collective_traffic_model(lt, H.spec, H.cfg)
    assert got == want
    if fused:
        assert H.cfg.win_order == mvj._cfg.win_order
    cnt = mesh.counters()
    for k in ("n_reduce_scatter", "reduce_scatter_bytes", "window_bytes"):
        assert cnt[k] == got[k], k
    assert cnt["window_bytes_remote"] == 0
    assert cnt["n_window_exchange"] == (1 if fused else 0)
    assert (got["window_bytes"] > 0) == fused


def test_scatters_are_started_ahead_of_the_kernels(l16):
    """No scatter's operand depends on a kernel output: every partial is
    computed from the input state, and the apply starts each group's
    scatter before that group runs, with at most _SCATTER_AHEAD scatters
    in flight (so that many partials alive per shard)."""
    mj, lj, mt, lt, x, y64, y0 = l16
    mesh = pt.LocalMesh(4, "cpu")
    H = pt.ShardedKronHamiltonian(lt, mesh, device="cpu")
    y = H(blockvec_from_numpy(x, "cpu", spec=H.spec, mesh=mesh))
    scale = max(float(np.abs(b).max()) for b in y0)
    assert _max_err(blockvec_to_numpy(y, H.spec), y0) <= 2e-6 * scale
    ev = H.schedule
    scat = [i for i, e in enumerate(ev) if e[0] == "scatter"]
    grp = {e[1]: i for i, e in enumerate(ev) if e[0] == "group"}
    model = pt.collective_traffic_model(lt, H.spec, H.cfg)
    assert len(scat) == model["n_reduce_scatter"] == mesh.n_reduce_scatter
    assert [e[1] for e in ev if e[0] == "group"] == list(range(len(lt.groups)))
    for i in scat:
        assert i < grp[ev[i][1]]  # started before its group runs
    worst, waiting = 0, set()
    for e in ev:
        if e[0] == "scatter":
            waiting.add(e[1])
        else:
            waiting.discard(e[1])
        worst = max(worst, len(waiting))
    assert 1 < worst <= tss._SCATTER_AHEAD


def test_window_segments_cover_each_window_once():
    """The static (sender, receiver) row ranges of every window move: they
    tile the window's rows exactly, inside both blocks, whatever the block
    sizes of source and destination."""
    from spindynamics_tpu_torch.parallel.mesh import window_segments

    mj, lj, mt, lt = _models(16, (6, 4, 6))
    for D in (2, 3, 4, 8):
        H = pt.ShardedKronHamiltonian(lt, pt.LocalMesh(D, "cpu"),
                                      device="cpu")
        assert H.cfg.moves
        for mv in H.cfg.moves:
            (_, rb0, cb0, lnb, b_src, b_dst) = mv
            seen = []
            for (s, r, a, c, n) in window_segments(mv, D):
                assert 0 <= a and a + n <= b_src and 0 <= c and c + n <= b_dst
                src0, dst0 = s * b_src + a, r * b_dst + c
                assert dst0 - cb0 == src0 - rb0
                seen.extend(range(dst0, dst0 + n))
            assert sorted(seen) == list(range(cb0, cb0 + lnb))


# ---- ProcessMesh: two gloo processes ----------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("L", [12, 14])
def test_process_mesh_two_ranks_match_local_mesh(L, tmp_path):
    """Two ranks over gloo, each holding only its block: one apply, the
    sharded observables and one groundstate_kron equal the LocalMesh(2)
    run of the same numpy-made state. Apply and observables at 1e-6 of the
    scale: the per-shard code and its float32 sums are the same, and at
    D=2 the reduce-scatter adds two partials (a + b = b + a), so the runs
    are equal bit for bit in practice; the bound leaves room for a
    backend that blocks a product over a view otherwise. E0 at 1e-5."""
    port = _free_port()
    cmd = [sys.executable, worker.__file__]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(cmd + [str(r), "2", str(port), str(L),
                                     str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
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
    mesh = pt.LocalMesh(2, "cpu")
    ref = worker.run_case(L, mesh)
    lay = tsk.make_sector_kron_layout(worker.case_model(L))
    spec = pt.kron_shard_spec(lay, 2)
    model = pt.collective_traffic_model(
        lay, spec, pt.ShardedKronHamiltonian(lay, mesh, device="cpu").cfg)
    scale = max(float(np.abs(ref[f"y{gi}"]).max())
                for gi in range(len(lay.groups)))
    for r, got in enumerate(ranks):
        assert list(got["rows"]) == spec.b  # its block and nothing else
        for gi, b in enumerate(spec.b):
            want = ref[f"y{gi}"][r * b:(r + 1) * b]
            assert got[f"y{gi}"].shape == want.shape
            assert np.abs(got[f"y{gi}"] - want).max() <= 1e-6 * scale
        assert np.abs(got["szsz"] - ref["szsz"]).max() <= 1e-6
        assert np.abs(got["si"] - ref["si"]).max() <= 1e-6
        assert abs(float(got["E0"]) - float(ref["E0"])) <= 1e-5
        assert float(got["residual"]) < 1e-3
        assert int(got["cnt_n_reduce_scatter"]) == model["n_reduce_scatter"]
        assert (int(got["cnt_reduce_scatter_bytes"])
                == model["reduce_scatter_bytes"])
    # the windows' content is dealt over the ranks; only the rows that
    # cross the shard boundary travel (the model is an upper bound)
    assert sum(int(g["cnt_window_bytes"]) for g in ranks) == \
        model["window_bytes"]
    remote = sum(int(g["cnt_window_bytes_remote"]) for g in ranks)
    assert remote <= model["window_bytes"]
    # (L=12's hi axes have one row: shard 1 holds padding, nothing crosses)
    assert (remote > 0) == (L == 14)
    assert float(ranks[0]["E0"]) == float(ranks[1]["E0"])


def test_distributed_glue_single_process():
    """Without a launcher's variables nothing is initialized, and the
    topology's mesh is a LocalMesh."""
    from spindynamics_tpu_torch.parallel import distributed as dist_mod

    assert pt.initialize_distributed() is False
    assert dist_mod.is_multiprocess() is False
    mesh = pt.mesh_from_topology(4, device="cpu")
    assert isinstance(mesh, pt.LocalMesh) and mesh.D == 4
    assert mesh.device == torch.device("cpu")
    assert pt.mesh_from_topology().D == 1
    assert pt.local_shard_info(mesh) == {
        "n_shards": 4, "local_shard_ids": [0, 1, 2, 3], "process_index": 0,
        "process_count": 1}
    with pytest.raises(RuntimeError, match="initialized"):
        pt.ProcessMesh()


# ---- the mesh= entry points against their JAX mesh= runs --------------------
#
# The JAX reference runs here are whole solves executed op by op on sharded
# arrays. They use a mesh of TWO virtual devices (and splits whose hi axes
# have up to 6 rows, so that both shards hold real rows): every sharded op
# is a rendezvous of the device threads, and with 8 participants on 8 busy
# cores XLA's CPU runtime can wait for one that never arrives and abort the
# process after 40 s (three of eight concurrent copies of such a solve did;
# none of eight on two devices). The port runs the same inputs on
# LocalMesh(4); the single jitted applies above use 4 devices at most, and
# the port's own LocalMesh(8) is held to the x64 oracle.

_JD, _TD = 2, 4  # shards of the JAX reference runs and of the port's


def _bounds(mt):
    """Chebyshev bounds of the model from the port's unsharded 40-step
    Lanczos (seed 7): the same interval for every run compared."""
    lt = tsk.make_sector_kron_layout(mt, mt.kron_splits)
    H = pt.KronHamiltonian(lt, device="cpu", fused=False,
                           dtype=torch.float32)
    from spindynamics_tpu_torch.solvers.kron_evolve import kron_energy_bounds

    return kron_energy_bounds(lt, H)


@pytest.fixture(scope="module")
def gs12():
    """L=12 XXZ chain (Jz=0.5, splits (4, 4, 4)): the JAX sharded ground
    state (its leaves carried over as numpy), and both models."""
    mj, lj, mt, lt = _models(12, (4, 4, 4), Jz=0.5)
    mesh = _jmesh(_JD)
    E0, psi, info, _ = sd.groundstate_kron(
        mj, lanc_m=30, cycles=3, target_residual=1e-4, mesh=mesh,
        fused=False)
    return mj, lj, mt, lt, mesh, float(E0), psi, info


def test_groundstate_kron_on_mesh(gs12):
    """groundstate_kron(mesh=): E0 within 1e-3 of the JAX sharded solve
    (the JAX test's bound against its compact reference) and within 1e-5
    of the port's unsharded solve from the same numpy start; residual <
    1e-3; the Ritz vector stays sharded and on the mesh."""
    mj, lj, mt, lt, jmesh, E_j, psi_j, info_j = gs12
    v0 = _leaves(lt, 8)
    mesh = pt.LocalMesh(_TD, "cpu")
    E0, psi, info, lay = pt.groundstate_kron(
        mt, lanc_m=30, cycles=3, target_residual=1e-4, mesh=mesh,
        v0=blockvec_from_numpy(v0, "cpu"))
    E1, _, _, _ = pt.groundstate_kron(
        mt, lanc_m=30, cycles=3, target_residual=1e-4,
        v0=blockvec_from_numpy(v0, "cpu"))
    assert abs(E0 - E_j) <= 1e-3 and abs(E0 - E1) <= 1e-5
    assert info["residual"] < 1e-3
    spec = pt.kron_shard_spec(lay, _TD)
    assert psi.mesh is mesh and tss.is_sharded_form(psi, spec, mesh)
    assert mesh.counters()["n_all_reduce"] > 0
    # the default start is the unsharded draw, cut: same E0 as without mesh
    E2, _, _, _ = pt.groundstate_kron(mt, lanc_m=30, cycles=3,
                                      target_residual=1e-4,
                                      mesh=pt.LocalMesh(2, "cpu"))
    E3, _, _, _ = pt.groundstate_kron(mt, lanc_m=30, cycles=3,
                                      target_residual=1e-4, device="cpu")
    assert abs(E2 - E3) <= 1e-5


def test_kpm_sqw_kron_on_mesh(gs12):
    """kpm_sqw_kron(mesh=) from the JAX sharded ground state and bounds:
    within 2e-3 of the peak of the JAX mesh run (float32 moments of 40
    terms; the JAX test holds its mesh run to 5e-2 from its own ground
    state) and of the port's unsharded run."""
    mj, lj, mt, lt, jmesh, E_j, psi_j, info_j = gs12
    q = [np.pi / 2, np.pi]
    omega = np.linspace(0, 4, 40)
    bounds = _bounds(mt)
    S_j, _ = sd.solvers.runners.kpm_sqw_kron(
        mj, q, omega, kpm_m=40, fused=False, mesh=jmesh, psi0=psi_j, E0=E_j,
        bounds=bounds)
    mesh = pt.LocalMesh(_TD, "cpu")
    spec = pt.kron_shard_spec(lt, _TD)
    plain_j = jss.unshard_kron_blockvec(psi_j, jss.kron_shard_spec(lj, _JD))
    psi = blockvec_from_numpy([np.asarray(l) for l in plain_j.leaves], "cpu",
                              spec=spec, mesh=mesh)
    S, info = pt.kpm_sqw_kron(mt, q, omega, kpm_m=40, mesh=mesh, psi0=psi,
                              E0=E_j, bounds=bounds)
    plain = pt.unshard_kron_blockvec(psi, spec)
    S_u, _ = pt.kpm_sqw_kron(mt, q, omega, kpm_m=40, psi0=plain, E0=E_j,
                             bounds=bounds, device="cpu")
    scale = float(np.abs(S_j).max())
    assert S.shape == S_j.shape and scale > 0
    assert np.abs(S - S_j).max() <= 2e-3 * scale
    assert np.abs(S - S_u).max() <= 2e-3 * scale
    # a plain psi0 is sharded on entry: the same result
    S_p, _ = pt.kpm_sqw_kron(mt, q[:1], omega, kpm_m=40, mesh=mesh,
                             psi0=plain, E0=E_j, bounds=bounds)
    assert np.abs(S_p[0] - S[0]).max() <= 1e-6 * scale


@pytest.fixture(scope="module")
def gs12_64():
    """The same chain in float64 with a numpy-made normalized state as
    psi0 (any state serves the spectral recurrences), for 1e-8 checks."""
    mj, lj, mt, lt = _models(12, (4, 4, 4), Jz=0.5, jdt="f64", tdt="f64")
    x = _leaves(lt, 9, np.float64)
    nrm = np.sqrt(sum(float((l * l).sum()) for l in x))
    return mj, lj, mt, lt, [l / nrm for l in x]


@pytest.mark.parametrize("plane_mode", ["pair", "split"])
def test_lanczos_sqw_kron_on_mesh(gs12_64, plane_mode):
    """lanczos_sqw_kron(mesh=) in float64, 12 steps, against the JAX mesh
    run from the same state (1e-8 of the peak: both are the same
    recurrence in float64) and against the port's unsharded run."""
    mj, lj, mt, lt, x = gs12_64
    q = [0.0, np.pi / 3, np.pi]
    omega = np.linspace(0, 3, 25)
    jmesh = _jmesh(_JD)
    sj = jss.kron_shard_spec(lj, _JD)
    S_j, _ = sd.solvers.runners.lanczos_sqw_kron(
        mj, q, omega, lanc_m=12, eta=0.1, fused=False, mesh=jmesh,
        psi0=_jsharded(x, sj, jmesh, jnp.float64), E0=-5.0,
        plane_mode=plane_mode)
    mesh = pt.LocalMesh(_TD, "cpu")
    psi = blockvec_from_numpy(x, "cpu", dtype=torch.float64,
                              spec=pt.kron_shard_spec(lt, _TD), mesh=mesh)
    S, info = pt.lanczos_sqw_kron(mt, q, omega, lanc_m=12, eta=0.1,
                                  fused=False, mesh=mesh, psi0=psi, E0=-5.0,
                                  plane_mode=plane_mode)
    S_u, _ = pt.lanczos_sqw_kron(
        mt, q, omega, lanc_m=12, eta=0.1, fused=False, E0=-5.0,
        psi0=blockvec_from_numpy(x, "cpu", dtype=torch.float64),
        plane_mode=plane_mode)
    scale = float(np.abs(S_j).max())
    assert info["plane_mode"] == plane_mode and scale > 0
    assert np.abs(S - S_j).max() <= 1e-8 * scale
    assert np.abs(S - S_u).max() <= 1e-8 * scale


def test_kpm_correlation_matrix_kron_on_mesh(gs12_64):
    """kpm_correlation_matrix_kron(mesh=) in float64 (2 B sites x 20
    moments, given a and b) against the JAX mesh run and the port's
    unsharded run: 1e-8 of the peak."""
    mj, lj, mt, lt, x = gs12_64
    omega = np.linspace(-1, 3, 20)
    kw = dict(n=20, fused=False, E0=-5.0, a=9.0, b=0.3, sites=[1, 6])
    jmesh = _jmesh(_JD)
    sj = jss.kron_shard_spec(lj, _JD)
    C_j, _ = sd.solvers.runners.kpm_correlation_matrix_kron(
        mj, omega, mesh=jmesh, psi0=_jsharded(x, sj, jmesh, jnp.float64),
        **kw)
    mesh = pt.LocalMesh(_TD, "cpu")
    psi = blockvec_from_numpy(x, "cpu", dtype=torch.float64,
                              spec=pt.kron_shard_spec(lt, _TD), mesh=mesh)
    C, _ = pt.kpm_correlation_matrix_kron(mt, omega, mesh=mesh, psi0=psi,
                                          **kw)
    C_u, _ = pt.kpm_correlation_matrix_kron(
        mt, omega, psi0=blockvec_from_numpy(x, "cpu", dtype=torch.float64),
        **kw)
    scale = float(np.abs(C_j).max())
    assert C.shape == (12, 2, 20) and scale > 0
    assert np.abs(C - C_j).max() <= 1e-8 * scale
    assert np.abs(C - C_u).max() <= 1e-8 * scale


@pytest.fixture(scope="module")
def evolve14():
    """L=14, splits (6, 4, 4), Jz=0.7 (tests/test_kron_evolve.py's model)."""
    return _models(14, (6, 4, 4))


def test_evolve_trajectory_kron_on_mesh(evolve14):
    """The domain-wall trajectory with mesh=: <Sz_i> within 2e-5 of the
    JAX mesh run (the JAX test's bound between its mesh and single-device
    runs) and of the port's unsharded run (K2's plain version there, the
    plain recurrence here), norms within 1e-4 of 1; the state stays on the
    mesh."""
    mj, lj, mt, lt = evolve14
    bits = pt.domain_wall_bitstring(mt)
    assert bits == sd.models.initial_states.domain_wall_bitstring(mj)
    Eb = _bounds(mt)
    _, obs_j, _ = sd.evolve_trajectory_kron(mj, bits, 0.1, 2, cheb_n=16,
                                            fused=False, mesh=_jmesh(_JD),
                                            Ebounds=Eb)
    mesh = pt.LocalMesh(_TD, "cpu")
    pair, obs, info = pt.evolve_trajectory_kron(mt, bits, 0.1, 2, cheb_n=16,
                                                mesh=mesh, Ebounds=Eb)
    _, obs_u, _ = pt.evolve_trajectory_kron(mt, bits, 0.1, 2, cheb_n=16,
                                            Ebounds=Eb, device="cpu")
    assert np.abs(obs - np.asarray(obs_j)).max() <= 2e-5
    assert np.abs(obs - obs_u).max() <= 2e-5
    assert abs(info["norms"][-1] - 1.0) < 1e-4
    assert pair[0].mesh is mesh and pair[1].mesh is mesh
    assert tss.is_sharded_form(pair[0], pt.kron_shard_spec(lt, _TD), mesh)
    # bounds from the sharded Lanczos: the unsharded draw, cut (L=12)
    _, _, m12, _ = _models(12, (4, 4, 4))
    b12 = pt.domain_wall_bitstring(m12)
    _, _, i2 = pt.evolve_trajectory_kron(m12, b12, 0.1, 1, cheb_n=8,
                                         mesh=pt.LocalMesh(2, "cpu"))
    _, _, i3 = pt.evolve_trajectory_kron(m12, b12, 0.1, 1, cheb_n=8,
                                         device="cpu")
    assert np.allclose(i2["Ebounds"], i3["Ebounds"], atol=1e-4)


def test_evolve_trajectory_kron_bf16_on_mesh():
    """A sharded bfloat16 trajectory (L=12): the JAX package needs a
    bfloat16 model for it (its kernel dtype follows the model), the port's
    K1 follows the leaves, so a float32 model serves. <Sz_i> within 2e-2 of
    the JAX bf16 mesh run and of the float32 run, norm drift < 5e-2 (the
    JAX test's bounds)."""
    mjbf, _, mt, lt = _models(12, (4, 4, 4), jdt="bf16")
    bits = pt.domain_wall_bitstring(mt)
    Eb = _bounds(mt)
    _, obs_j, _ = sd.evolve_trajectory_kron(
        mjbf, bits, 0.1, 2, cheb_n=16, state_dtype=jnp.bfloat16,
        mesh=_jmesh(_JD), Ebounds=Eb)
    mesh = pt.LocalMesh(_TD, "cpu")
    pair, obs, info = pt.evolve_trajectory_kron(
        mt, bits, 0.1, 2, cheb_n=16, state_dtype=torch.bfloat16, mesh=mesh,
        Ebounds=Eb)
    _, obs32, _ = pt.evolve_trajectory_kron(mt, bits, 0.1, 2, cheb_n=16,
                                            Ebounds=Eb, device="cpu")
    assert pair[0].dtype == torch.bfloat16 and pair[0].mesh is mesh
    assert np.abs(obs - np.asarray(obs_j, np.float32)).max() <= 2e-2
    assert np.abs(obs - obs32).max() <= 2e-2
    assert info["norm_drift"] < 5e-2


def test_typicality_correlation_kron_on_mesh():
    """typicality_correlation_kron(mesh=) at L=12 from a numpy-made r0 and
    given bounds: within 2e-5 of the JAX mesh run (the JAX test's bound)
    and of the port's unsharded run."""
    mj, lj, mt, lt = _models(12, (4, 4, 4))
    r0 = (_leaves(lt, 12), _leaves(lt, 13))
    ts = np.array([0.0, 0.5])
    Eb = _bounds(mt)
    ref = sd.solvers.kron_evolve.typicality_correlation_kron(
        mj, 0.6, 2, 5, ts, cheb_n=20, Ebounds=Eb, fused=False,
        r0=tuple(JBlockVec([jnp.asarray(l) for l in p]) for p in r0),
        mesh=_jmesh(_JD))
    mesh = pt.LocalMesh(_TD, "cpu")
    got = pt.typicality_correlation_kron(
        mt, 0.6, 2, 5, ts, cheb_n=20, Ebounds=Eb, mesh=mesh,
        r0=tuple(blockvec_from_numpy(p, "cpu") for p in r0))
    unsharded = pt.typicality_correlation_kron(
        mt, 0.6, 2, 5, ts, cheb_n=20, Ebounds=Eb,
        r0=tuple(blockvec_from_numpy(p, "cpu") for p in r0))
    assert np.abs(got - ref).max() <= 2e-5
    assert np.abs(got - unsharded).max() <= 2e-5
    assert mesh.counters()["n_all_reduce"] > 0


@pytest.mark.parametrize("kind", ["flat", "leaves", "pair"])
def test_sharded_observables_match_jax_and_unsharded(kind):
    """szsz_matrix_kron_sharded and magnetization_per_site_kron_sharded on
    a flat sharded vector, a sharded BlockVec and an (re, im) pair: 1e-6
    against the JAX sharded observables on 4 virtual devices and the port's
    unsharded ones (float32 marginal sums)."""
    mj, lj, mt, lt = _models(14, (6, 4, 4))
    a, b = _leaves(lt, 14), _leaves(lt, 15)
    nrm = np.sqrt(sum(float((l * l).sum()) for l in a + b))
    a, b = [l / nrm for l in a], [l / nrm for l in b]
    if kind != "pair":  # a real state: normalize it alone
        n1 = np.sqrt(sum(float((l * l).sum()) for l in a))
        a = [l / n1 for l in a]
    jmesh, sj = _jmesh(4), jss.kron_shard_spec(lj, 4)
    mesh, spec = pt.LocalMesh(4, "cpu"), pt.kron_shard_spec(lt, 4)
    xa = blockvec_from_numpy(a, "cpu", spec=spec, mesh=mesh)
    ua = blockvec_from_numpy(a, "cpu")
    if kind == "flat":
        flat = np.concatenate([l.reshape(-1) for l in a])
        xj = jax.device_put(jss.shard_kron_state(jnp.asarray(flat), sj),
                            NamedSharding(jmesh, P("rows")))
        xt = tss.shard_kron_state(torch.as_tensor(flat), spec)
        xu = ua
    elif kind == "leaves":
        xj, xt, xu = _jsharded(a, sj, jmesh), pt.BlockVec(xa.leaves), ua
    else:
        xj = (_jsharded(a, sj, jmesh), _jsharded(b, sj, jmesh))
        xt = (xa, blockvec_from_numpy(b, "cpu", spec=spec, mesh=mesh))
        xu = (ua, blockvec_from_numpy(b, "cpu"))
    szsz_j, si_j = sd.observables_kron.szsz_matrix_kron_sharded(xj, sj, jmesh)
    mesh.reset_counters()
    szsz, si = pt.szsz_matrix_kron_sharded(xt, spec, mesh)
    assert mesh.counters()["n_all_reduce"] == 1  # one (L + 1, L) reduce
    szsz_u, si_u = pt.szsz_matrix_kron(xu, lt)
    assert np.abs(szsz.numpy() - np.asarray(szsz_j)).max() <= 1e-6
    assert np.abs(si.numpy() - np.asarray(si_j)).max() <= 1e-6
    assert np.abs(szsz.numpy() - szsz_u.numpy()).max() <= 1e-6
    assert np.abs(si.numpy() - si_u.numpy()).max() <= 1e-6
    mag = pt.magnetization_per_site_kron_sharded(xt, spec, mesh)
    assert np.abs(mag.numpy() - np.asarray(si_j)).max() <= 1e-6
    assert np.allclose(np.diag(szsz.numpy()), 0.25, atol=1e-6)


# ---- guards -----------------------------------------------------------------


def test_sharded_entry_points_default_to_the_card():
    """The new entry points resolve device=None to the mesh's device, else
    the card, and raise without CUDA; none has a "cpu" default; every kron
    entry point takes mesh= and none raises NotImplementedError for it."""
    from spindynamics_tpu_torch.solvers import kron_evolve, runners

    for f in (pt.ShardedKronHamiltonian.__init__, pt.LocalMesh.__init__,
              pt.sharded_kron_scaling_bv_matvec_fn,
              tss.sharded_kron_scaling_matvec_fn, pt.mesh_from_topology):
        assert inspect.signature(f).parameters["device"].default is None, f
    for f in (pt.groundstate_kron, pt.kpm_sqw_kron, pt.lanczos_sqw_kron,
              pt.kpm_correlation_matrix_kron, pt.evolve_trajectory_kron,
              pt.typicality_correlation_kron):
        sig = inspect.signature(f).parameters
        assert sig["mesh"].default is None and sig["device"].default is None
    assert not hasattr(kron_evolve, "_no_mesh")
    for mod in (kron_evolve, runners):
        assert "NotImplementedError" not in "".join(
            ln for ln in inspect.getsource(mod).splitlines()
            if "mesh" in ln)
    mj, lj, mt, lt = _models(12)
    mesh = pt.LocalMesh(2)  # no device: the card
    for call in (
            lambda: pt.ShardedKronHamiltonian(lt, mesh),
            lambda: pt.sharded_kron_scaling_bv_matvec_fn(mt, mesh),
            lambda: pt.groundstate_kron(mt, mesh=mesh),
            lambda: pt.evolve_trajectory_kron(mt, 63, 0.1, 1, mesh=mesh),
            lambda: pt.typicality_correlation_kron(mt, 1.0, 1, 1, [0.0],
                                                   mesh=mesh)):
        if not torch.cuda.is_available():  # (with a card they would run)
            with pytest.raises(RuntimeError, match='device="cpu"'):
                call()
    # a mesh with a device, or a state, decides it
    H = pt.ShardedKronHamiltonian(lt, pt.LocalMesh(2, "cpu"))
    assert H.device == torch.device("cpu") and not H.supports_axpy
    with pytest.raises(ValueError, match="sharded-form"):
        pt.ShardedKronHamiltonian(lt, pt.LocalMesh(8, "cpu"))(
            blockvec_from_numpy(_leaves(lt, 1), "cpu"))
    assert kg.kernel_launch_count(crossw=True) == 0  # no card, no launch
