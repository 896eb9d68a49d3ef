"""The port's package namespace against the JAX package's (names and
signatures), the XY chain functions against the JAX models, and the kron
rank helpers (kron_rank, kron_order_states) with the one-hot BlockVec built
on them."""

import inspect
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu.ops import sector_kron as jsk
from spindynamics_tpu_torch.ops import sector_kron as tsk


def test_namespace_covers_the_jax_package():
    """Every public name of the JAX package is exported by the port or
    listed in NOT_PORTED with the ROADMAP item or the reason, and every
    exported name exists."""
    jax_names = {n for n, v in vars(sd).items()
                 if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert jax_names <= set(pt.__all__) | set(pt.NOT_PORTED)
    assert not set(pt.NOT_PORTED) & set(pt.__all__)
    assert all(hasattr(pt, n) for n in pt.__all__)
    assert len(pt.__all__) == len(set(pt.__all__))
    assert all(v.startswith(("ROADMAP", "not ported"))
               for v in pt.NOT_PORTED.values())
    # evolve_trajectory_planes was the last: every name is ported
    assert pt.NOT_PORTED == {}


# The deliberate differences between the two packages' signatures, each
# with its reason. A JAX keyword the port renames:
RENAMED = {
    "key": ("generator", "a torch.Generator replaces a JAX PRNG key"),
    "pmv": ("planes", "the planes module (KronPlanes) replaces the JAX "
            "closure pmv"),
    "pmv_or_mv": ("planes_or_mv", "the same, where a matvec is taken too"),
    "sharding": ("mesh", "a LocalMesh or ProcessMesh replaces a "
                 "jax.sharding object"),
}
# JAX keywords the port does not take:
JAX_ONLY = {
    "axis_name": "the port's meshes have one axis (the kron entry points; "
                 "the flat parallel/ functions keep it for their callers)",
    # SpinModel fields
    "states": "the port's SpinModel stores no N-sized array: the states, "
              "diagonal and ELL table are built on the asking device",
    "diag": "as for states",
    "nbr": "as for states",
    "binom": "as for states",
}
# Keywords the port adds:
PORT_ONLY = {
    "device": "entry points run on the card unless asked for the CPU",
    "generator": "the renamed key",
    "planes": "the renamed pmv",
    "planes_or_mv": "the renamed pmv_or_mv",
    "mesh": "the renamed sharding, and the port's mesh= of the sharded "
            "paths (a BlockVec's mesh, the flat trajectories)",
    "shard": "BlockVec constructors' sharded form",
    "v0": "a given start vector where the JAX function draws one",
    "matvec": "a prebuilt FlatHamiltonian, so a caller's tables are kept",
    "dtype": "the state dtype where the JAX function takes the model's",
    "cheb_fused": "K2's routing, a field (the JAX package reads the "
                  "environment)",
    "cheb_top_k": "as cheb_fused",
    "checkpoint_dir": "evolve_trajectory checkpoints (the JAX package "
                      "keeps them on evolve_trajectory_planes)",
    "checkpoint_every": "as checkpoint_dir",
    "resume": "as checkpoint_dir",
    "kw": "run_kpm_dynamical forwards kpm_correlation_matrix's keywords",
    "nbr": "apply_H_ell's and apply_H_tensor's prebuilt tables",
    "diag": "as nbr",
    "chunk": "apply_H_ell's row chunk (the JAX package gathers every row)",
    "neighbor_table": "SpinModel records build_neighbor_table (the port's "
                      "model holds no table)",
}


def _params(f):
    return list(inspect.signature(f).parameters)


def test_signatures_match_the_jax_package():
    """For every exported name of both packages, every JAX keyword is
    accepted by the port (under its RENAMED name), unless JAX_ONLY lists
    it; every keyword the port adds is listed in PORT_ONLY."""
    checked = 0
    for name in pt.__all__:
        fj, ft = getattr(sd, name, None), getattr(pt, name)
        if fj is None or not callable(fj):
            continue
        try:
            pj, ptt = _params(fj), _params(ft)
        except (TypeError, ValueError):
            continue
        checked += 1
        for p in pj:
            want = RENAMED.get(p, (p,))[0]
            assert want in ptt or p in JAX_ONLY, \
                f"{name}: the JAX keyword {p!r} is not accepted"
        renamed_to = {RENAMED[p][0] for p in pj if p in RENAMED}
        for p in ptt:
            assert p in pj or p in renamed_to or p in PORT_ONLY, \
                f"{name}: the port's keyword {p!r} is not listed"
    assert checked > 80


def test_parity_keywords_run():
    """The JAX keywords the port once refused: each runs, with the JAX
    meaning where it has one (masked=False keeps the pad draws)."""
    m = pt.xxz_chain(8, Jxy=1.0, Jz=0.5, nup=4, dtype=torch.float64)
    mc = pt.build_model(8, nup=4, hopping=pt.nn_hopping(8, 1.0),
                        layout="compact", lean=True, device_build=False,
                        dtype=torch.float64)
    psi = torch.ones(mc.n_states, dtype=torch.float64)
    assert torch.equal(pt.apply_H(psi, mc, exact_J=True),
                       pt.apply_H(psi, mc))
    lay = tsk.make_sector_kron_layout(m, m.kron_splits)
    g = torch.Generator().manual_seed(0)
    bv = pt.bv_random(lay, g, torch.float64, "cpu", masked=False)
    assert any(float(l[:, cm:].abs().sum() + l[:, :, cl:].abs().sum()) > 0
               for l, (*_, cm, cl, cmp, clp) in zip(bv.leaves, lay.groups)
               if cmp != cm or clp != cl)
    planes = pt.kron_planes_matvec_fn(lay, pt.KronHamiltonian(
        lay, dtype=torch.float64, device="cpu", fused=False).tables,
        fused=False, dtype=torch.float64, device="cpu")
    x = pt.bv_random(lay, g, torch.float64, "cpu")
    want = pt.kron_planes_matvec_fn(lay, fused=False, dtype=torch.float64,
                                    device="cpu")((x, x))[0]
    assert all(torch.equal(a, b) for a, b in zip(planes((x, x))[0].leaves,
                                                 want.leaves))
    psi0 = pt.domain_wall_state(mc, dtype=torch.complex128, device="cpu")
    C1 = pt.kpm_correlation_matrix(psi0, np.linspace(-2, 4, 9), mc, n=20,
                                   a=8.0, b=0.0)
    C3 = pt.kpm_correlation_matrix(psi0, np.linspace(-2, 4, 9), mc, n=20,
                                   a=8.0, b=0.0, chunk_B=3)
    assert torch.equal(C1, C3)
    S, info = pt.lanczos_sqw_kron(m, [np.pi], [0.0, 1.0], lanc_m=10,
                                  gs_lanc_m=20, cycles=2, plane_mode=None,
                                  fused=False, device="cpu")
    assert info["plane_mode"] == "pair" and np.all(np.isfinite(S))


def _lr(i, j):
    return 0.7 / (j - i) ** 1.5


@pytest.mark.parametrize("kind", ["xy", "long_range"])
def test_xy_chain_models_match_jax(kind):
    L = 10
    if kind == "xy":
        mj = sd.xy_chain(L, Jxy=0.8, nup=5, dtype=jnp.float64,
                        layout="sector_kron")
        mt = pt.xy_chain(L, Jxy=0.8, nup=5, dtype=torch.float64)
    else:
        mj = sd.long_range_xy_chain(L, _lr, nup=5, dtype=jnp.float64,
                                    layout="sector_kron")
        mt = pt.long_range_xy_chain(L, _lr, nup=5, dtype=torch.float64)
    assert tuple(map(tuple, mt.hop_sites)) == tuple(map(tuple, mj.hop_sites))
    np.testing.assert_array_equal(np.asarray(mt.hop_J), np.asarray(mj.hop_J))
    assert tuple(map(tuple, mt.zz_sites)) == tuple(map(tuple, mj.zz_sites))
    np.testing.assert_array_equal(np.asarray(mt.zz_J, np.float64),
                                  np.asarray(mj.zz_J, np.float64))
    np.testing.assert_array_equal(np.asarray(mt.field, np.float64),
                                  np.asarray(mj.field, np.float64))
    assert mt.nup == mj.nup and mt.kron_splits == mj.kron_splits


@pytest.mark.parametrize("L,nup,splits", [(10, 5, (4, 3, 3)),
                                          (12, 5, (5, 4, 3))])
def test_kron_rank_round_trip_matches_jax(L, nup, splits):
    pads = (8, 128)
    states = tsk.kron_order_states(L, nup, splits, pads)
    np.testing.assert_array_equal(states,
                                  jsk.kron_order_states(L, nup, splits, pads))
    real = np.nonzero(states != tsk.PAD_SENTINEL)[0]
    assert len(real) == sd.sector_dimension(L, nup)
    for i in real[::7]:
        assert tsk.kron_rank(int(states[i]), L, nup, splits, pads) == i
        assert tsk.kron_rank(int(states[i]), L, nup, splits, pads) == \
            jsk.kron_rank(int(states[i]), L, nup, splits, pads)
    with pytest.raises(ValueError):
        tsk.kron_rank(0b111, L, nup, splits, pads)


def test_basis_state_is_one_at_its_kron_rank():
    """bv_basis_state puts its one at kron_rank's slot, also in sharded
    form, and refuses a state outside the sector."""
    m = pt.xxz_chain(12, nup=6, kron_splits=(5, 4, 3))
    lay = tsk.make_sector_kron_layout(m, m.kron_splits)
    bits = 0b101100110100
    bv = pt.bv_basis_state(lay, bits, device="cpu")
    flat = tsk.blocks_to_flat(bv.leaves, lay)
    r = tsk.kron_rank(bits, 12, 6, lay.splits, lay.pads)
    assert float(flat.sum()) == 1.0 and float(flat[r]) == 1.0
    mesh = pt.LocalMesh(2, "cpu")
    spec = pt.kron_shard_spec(lay, 2)
    sh = pt.bv_basis_state(lay, bits, device="cpu", shard=(spec, mesh))
    back = pt.unshard_kron_blockvec(sh, spec)
    assert all(torch.equal(a, b) for a, b in zip(back.leaves, bv.leaves))
    with pytest.raises(ValueError, match="magnetization"):
        pt.bv_basis_state(lay, 0b111, device="cpu")


@pytest.mark.parametrize("L,nup", [(8, 4), (16, 8), (28, 14), (32, 15)])
def test_kron_split_argmin_matches_jax(L, nup):
    """The split study ported verbatim: the same argmin (float32 and
    bfloat16 amplitude widths) and the same cost of the default split."""
    for itemsize in (4, 2):
        assert tsk.kron_split_argmin(L, nup, itemsize) == \
            jsk.kron_split_argmin(L, nup, itemsize)
    splits = tsk.default_kron_splits(L)
    assert tsk._kron_split_cost(L, nup, splits) == \
        jsk._kron_split_cost(L, nup, splits)
    with pytest.raises(ValueError):
        tsk.kron_split_argmin(3)


def test_profiling_trace_and_annotate(tmp_path):
    """utils.profiling: trace writes a Chrome trace and yields the
    profiler; annotate names a range in its table."""
    from spindynamics_tpu_torch.utils.profiling import annotate, trace

    with trace(str(tmp_path / "t")) as prof:
        with annotate("apply_phase"):
            pt.apply_H(torch.ones(1 << 6, dtype=torch.float64),
                       pt.xxz_chain(6, dtype=torch.float64))
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    assert "apply_phase" in {e.key for e in prof.key_averages()}
