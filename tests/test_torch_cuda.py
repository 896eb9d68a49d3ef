"""K1 on the card against its plain version (marked `gpu`: they need a CUDA
device and skip elsewhere), and the refusal of fused float64 solves on CUDA.
Imports no jax, so it also runs where JAX is not installed:
python -m pytest --noconftest tests/test_torch_cuda.py"""

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
        pytest.skip("K1 runs only on a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("L,splits", [(16, None), (12, (5, 4, 3)),
                                      (20, None)])
def test_k1_matches_plain(cuda_device, L, splits):
    m = pt.xxz_chain(L, Jxy=1.0, Jz=0.7, h=np.linspace(-0.2, 0.3, L),
                     nup=L // 2, kron_splits=splits)
    lay = make_sector_kron_layout(m, m.kron_splits)
    g = torch.Generator(device=cuda_device).manual_seed(L)
    bv = bv_random(lay, g, torch.float32, cuda_device)
    b0 = bv_random(lay, g, torch.float32, cuda_device)
    H = pt.KronHamiltonian(lay, dtype=torch.float32, device=cuda_device)
    # K1's plain version
    Hc = pt.KronHamiltonian(lay, device="cpu", dtype=torch.float32)
    s = torch.tensor(-0.37, device=cuda_device)
    for axpy in (False, True):
        n0 = kg.kernel_launch_count()
        got = (H(bv, s, b0) if axpy else H(bv)).leaves
        torch.cuda.synchronize()
        assert kg.kernel_launch_count() - n0 == min(H.top_k, len(lay.groups))
        bc, b0c = (pt.BlockVec([b.cpu() for b in v.leaves]) for v in (bv, b0))
        want = (Hc(bc, s.cpu(), b0c) if axpy else Hc(bc)).leaves
        scale = max(float(w.abs().max()) for w in want)
        for a, b, (_, _, _, ch, cm, cl, cmp, clp) in zip(got, want,
                                                          lay.groups):
            a = a.cpu()
            assert float((a - b).abs().max()) < 1e-5 * scale
            assert not a[:, cm:, :].any() and not a[:, :, cl:].any()


@pytest.mark.gpu
def test_k1_refuses_float64(cuda_device):
    m = pt.xxz_chain(12, nup=6)
    lay = make_sector_kron_layout(m, m.kron_splits)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    bv = bv_random(lay, g, torch.float64, cuda_device)
    H = pt.KronHamiltonian(lay, dtype=torch.float64, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        H(bv)


@pytest.mark.parametrize("entry", ["groundstate_kron", "kpm_sqw_kron"])
def test_fused_float64_on_cuda_is_refused(entry):
    """A fused float64 solve on CUDA raises instead of running the plain
    apply there. The check comes before any tensor is made, so this runs
    with or without a card."""
    m = pt.xxz_chain(12, nup=6, dtype=torch.float64)
    args = (m,) if entry == "groundstate_kron" else (m, [np.pi], [0.0, 1.0])
    with pytest.raises(ValueError, match="fused=False"):
        getattr(pt, entry)(*args, device="cuda")


@pytest.mark.gpu
def test_k1_is_deterministic(cuda_device):
    """Each output element is written once in a fixed order: repeated
    applies are bit-identical (the two-pass Lanczos relies on it)."""
    m = pt.heisenberg_chain(20, nup=10)
    lay = make_sector_kron_layout(m, m.kron_splits)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    bv = bv_random(lay, g, torch.float32, cuda_device)
    H = pt.KronHamiltonian(lay, dtype=torch.float32, device=cuda_device)
    first = H(bv).leaves
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(first, H(bv).leaves))
