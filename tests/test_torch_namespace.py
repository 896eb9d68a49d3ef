"""The port's package namespace against the JAX package's, the XY chain
functions against the JAX models, and the kron rank helpers (kron_rank,
kron_order_states) with the one-hot BlockVec built on them."""

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
    # the tensor backend is ported: what is left is not to be ported
    assert set(pt.NOT_PORTED) == {"evolve_trajectory_planes"}


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
