"""The sharded kron apply on the card: K1's crossw variant (float32 and
bfloat16 states) on the local blocks of a LocalMesh against the same apply
on the CPU (the plain version). Marked `gpu`: the tests need a CUDA device
and skip elsewhere. Imports no jax:
python -m pytest --noconftest tests/test_torch_cuda_parallel.py"""

import numpy as np
import pytest
import torch

import spindynamics_tpu_torch as pt
from spindynamics_tpu_torch.ops import kron_group as kg
from spindynamics_tpu_torch.ops.sector_kron import make_sector_kron_layout
from spindynamics_tpu_torch.solvers.blockvec import bv_random


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K1's crossw variant runs only on a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("L,splits,D", [(16, (6, 4, 6), 4), (14, (6, 4, 4), 2),
                                        (20, None, 8)])
def test_sharded_apply_on_card_matches_cpu(cuda_device, L, splits, D, sdt):
    """float32: 1e-5 of max|y| (summation order). bfloat16: both round a
    float32 sum once, so they differ by at most one bfloat16 unit where the
    sums straddle a rounding boundary (2^-7 |y| + 1e-5 max|y|)."""
    m = pt.xxz_chain(L, Jxy=1.0, Jz=0.7, h=np.linspace(-0.2, 0.3, L),
                     nup=L // 2, kron_splits=splits)
    lay = make_sector_kron_layout(m, m.kron_splits)
    mesh = pt.LocalMesh(D, cuda_device)
    H = pt.ShardedKronHamiltonian(lay, mesh)
    Hc = pt.ShardedKronHamiltonian(lay, pt.LocalMesh(D, "cpu"))
    g = torch.Generator(device=cuda_device).manual_seed(L)
    x = bv_random(lay, g, sdt, cuda_device, shard=(H.spec, mesh))
    kg.reset_kernel_launch_count()
    y = H(x)
    torch.cuda.synchronize()
    assert y.dtype == sdt and y.mesh is mesh
    assert kg.kernel_launch_count(sdt) == D * len(H.cfg.fused_set)
    assert 0 < kg.kernel_launch_count(sdt, crossw=True) <= D * len(
        H.cfg.fused_set)
    want = Hc(pt.BlockVec([l.cpu() for l in x.leaves], Hc.mesh))
    scale = max(float(w.float().abs().max()) for w in want.leaves)
    for a, b, (_, _, _, ch, cm, cl, _, _) in zip(y.leaves, want.leaves,
                                                 lay.groups):
        a, b = a.cpu().float(), b.float()
        if sdt == torch.float32:
            assert float((a - b).abs().max()) < 1e-5 * scale
        else:
            assert bool(((a - b).abs()
                         <= 2.0 ** -7 * b.abs() + 1e-5 * scale).all())
        assert not a[ch:].any()
        assert not a[:, cm:].any() and not a[:, :, cl:].any()
    # each element is written once in a fixed order: repeats are identical
    assert all(torch.equal(p, q) for p, q in zip(y.leaves, H(x).leaves))


@pytest.mark.gpu
def test_crossw_refuses_wrong_windows(cuda_device):
    m = pt.xxz_chain(16, nup=8, kron_splits=(6, 4, 6))
    lay = make_sector_kron_layout(m, m.kron_splits)
    mesh = pt.LocalMesh(2, cuda_device)
    H = pt.ShardedKronHamiltonian(lay, mesh)
    calls = H._state()[1][0]["calls"]
    call = next(c for c in calls if c is not None and c.crossw)
    T = torch.zeros(call.shape, device=cuda_device)
    srcs = [torch.zeros(s, device=cuda_device) for s in call.cross_shapes]
    with pytest.raises(ValueError, match="windows"):
        kg.kron_group_apply(T, None, srcs, [], call, [])
    bad = [torch.zeros(s, device=cuda_device, dtype=torch.bfloat16)
           for s in call.crossw_shapes]
    with pytest.raises(TypeError, match="window"):
        kg.kron_group_apply(T, None, srcs, [], call, bad)
