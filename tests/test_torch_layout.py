"""The port's sector_kron layout and fusion plans equal the JAX package's,
array by array and exactly (both are host numpy built from the same
couplings), and the port imports no jax."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu.ops import sector_kron as jsk
from spindynamics_tpu.ops.pallas_kron import fused_group_plans as j_plans
from spindynamics_tpu_torch.ops import sector_kron as tsk
from spindynamics_tpu_torch.ops.kron_group import fused_group_plans as t_plans

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import spindynamics_tpu_torch\n"
        "import spindynamics_tpu_torch.observables_kron\n"
        "import spindynamics_tpu_torch.models.initial_states\n"
        "import spindynamics_tpu_torch.ops.cheb_term\n"
        "import spindynamics_tpu_torch.ops.cuda_build\n"
        "import spindynamics_tpu_torch.ops.kron_group\n"
        "import spindynamics_tpu_torch.solvers.chebyshev\n"
        "import spindynamics_tpu_torch.solvers.kron_evolve\n"
        "import spindynamics_tpu_torch.utils.convert\n"
        "import spindynamics_tpu_torch.utils.device\n"
        "import spindynamics_tpu_torch.observables\n"
        "import spindynamics_tpu_torch.ops.apply\n"
        "import spindynamics_tpu_torch.ops.blocked\n"
        "import spindynamics_tpu_torch.ops.fused_matvec\n"
        "import spindynamics_tpu_torch.ops.spin_ops\n"
        "import spindynamics_tpu_torch.solvers.kpm\n"
        "import spindynamics_tpu_torch.solvers.krylov\n"
        "import spindynamics_tpu_torch.solvers.lanczos_sqw\n"
        "import spindynamics_tpu_torch.solvers.typicality\n"
        "import spindynamics_tpu_torch.utils.checkpoint\n"
        "import spindynamics_tpu_torch.parallel.mesh\n"
        "import spindynamics_tpu_torch.parallel.distributed\n"
        "import spindynamics_tpu_torch.parallel.sharded_kron_scaling\n"
        "sys.path.insert(0, 'tests')\n"
        "import _torch_dist_worker\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'spindynamics_tpu'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_reads_no_environment():
    """Routing (K1, K2, top_k, fuse_crossh) is a field of the modules, never
    an environment read: no source of the port touches the environment,
    but for parallel/distributed.py, which reads the launcher's four
    process-group variables (they name the cluster, not a route)."""
    import re

    pkg = os.path.join(REPO, "spindynamics_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    src = fh.read()
                if f == "distributed.py":
                    names = set(re.findall(
                        r"""environ(?:\.get\(|\[)['"](\w+)['"]""", src))
                    assert names == {"MASTER_ADDR", "MASTER_PORT",
                                     "WORLD_SIZE", "RANK"}, names
                    continue
                assert "os.environ" not in src and "getenv(" not in src, f


def _pair(case):
    """The same model built by both packages (f64)."""
    if case == "longrange":
        L, nup = 9, 4
        hop = [(i, j, 0.3 + 0.1 * (i + j)) for i in range(L)
               for j in range(i + 1, L)]
        zz = [(i, j, 0.2 + 0.05 * i) for i in range(L) for j in range(i + 1, L)
              if j - i <= 3]
        fld = np.linspace(-0.3, 0.2, L)
        kw = dict(nup=nup, hopping=hop, zz=zz, onsite_field=fld,
                  kron_splits=(3, 3, 3))
        return (sd.build_model(L, dtype=jnp.float64, layout="sector_kron",
                               **kw),
                pt.build_model(L, dtype=torch.float64, **kw))
    L, splits, field = case
    fld = np.linspace(-0.2, 0.3, L) if field else None
    kw = dict(Jxy=1.0, Jz=0.7, h=fld, nup=L // 2, kron_splits=splits)
    return (sd.xxz_chain(L, dtype=jnp.float64, layout="sector_kron", **kw),
            pt.xxz_chain(L, dtype=torch.float64, **kw))


CASES = [(8, None, False), (12, None, True), (12, (5, 4, 3), True),
         (16, None, False), (16, None, True), "longrange"]


def _eq(a, b):
    """Exact structural equality of nested layout data."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_eq(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_eq(x, y) for x, y in zip(a, b)))
    return a == b


@pytest.mark.parametrize("case", CASES, ids=str)
def test_layout_matches_jax(case):
    mj, mt = _pair(case)
    assert (mt.L, mt.nup, mt.kron_splits, mt.kron_pads) == (
        mj.L, mj.nup, mj.kron_splits, mj.kron_pads)
    assert mt.n_states == mj.n_states and mt.dim == mj.dim
    lj = jsk.make_sector_kron_layout(mj, mj.kron_splits)
    lt = tsk.make_sector_kron_layout(mt, mt.kron_splits)
    for name in ("L", "nup", "splits", "pads", "groups", "offsets",
                 "n_states", "n_basis"):
        assert getattr(lt, name) == getattr(lj, name), name
    for name in ("W", "cross_meta", "cross_pool", "cross_runs",
                 "cross_shapes", "diag_vecs", "diag_cross"):
        assert _eq(getattr(lt, name), getattr(lj, name)), name
    assert tsk.kron_apply_flops(lt) == jsk.kron_apply_flops(lj)
    assert tsk.default_fused_topk(lt) == jsk.default_fused_topk(lj)
    assert tsk.default_kron_splits(mt.L) == jsk.default_kron_splits(mj.L)

    pj, ptp = j_plans(lj), t_plans(lt)
    assert len(pj) == len(ptp)
    for a, b in zip(pj, ptp):
        for name in ("gi", "D1", "D2", "D3", "W_lo", "W_mid_T", "cross",
                     "unsupported", "crossh", "crossh_fusable"):
            assert _eq(getattr(b, name), getattr(a, name)), (a.gi, name)


@pytest.mark.parametrize("L", [20, 28, 32])
def test_default_splits_at_scale(L):
    # the split rule only (no layout build): the sizes the card runs
    assert tsk.default_kron_splits(L) == jsk.default_kron_splits(L)


def test_blocks_roundtrip():
    _, mt = _pair((12, None, True))
    lt = tsk.make_sector_kron_layout(mt, mt.kron_splits)
    x = torch.arange(lt.n_states, dtype=torch.float64)
    blocks = tsk.flat_to_blocks(x, lt)
    assert [tuple(b.shape) for b in blocks] == [
        (ch, cmp, clp) for (_, _, _, ch, _, _, cmp, clp) in lt.groups]
    assert torch.equal(tsk.blocks_to_flat(blocks, lt), x)


def test_other_layouts_not_ported():
    # compact is ported (tests/test_torch_compact.py); sector_blocked is not
    assert pt.build_model(8, nup=4, layout="compact").mode == "compact"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.build_model(8, nup=4, layout="sector_blocked")


@pytest.mark.parametrize("L,nup", [(8, 3), (12, 6), (16, 8)])
def test_basis_matches_jax(L, nup):
    from spindynamics_tpu import basis as jb
    from spindynamics_tpu_torch import basis as tb

    assert np.array_equal(tb.binomial_table(L, nup), jb.binomial_table(L, nup))
    assert tb.sector_dimension(L, nup) == jb.sector_dimension(L, nup)
    states = tb.build_sector_basis(L, nup)
    assert np.array_equal(states, jb.build_sector_basis(L, nup))
    for idx in (0, 1, len(states) // 2, len(states) - 1):
        s = int(states[idx])
        assert tb.rank_state(s, L, nup) == jb.rank_state(s, L, nup) == idx
