"""The sector_blocked layout on the card (marked `gpu`: they need a CUDA
device and skip elsewhere). Imports no jax, so it also runs where JAX is
not installed:
python -m pytest --noconftest tests/test_torch_cuda_sector_blocked.py"""

import numpy as np
import pytest
import torch

import spindynamics_tpu_torch as pt
from spindynamics_tpu_torch.model import sector_setup


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the card's torch build runs only on a CUDA device")
    return torch.device("cuda")


def _model(L, dtype):
    zz = [(i, j, 0.7 / (j - i) ** 2) for i in range(L) for j in range(i + 1, L)]
    return pt.build_model(L, nup=L // 2, hopping=pt.nn_hopping(L, 1.0),
                          zz=zz, onsite_field=np.linspace(-0.2, 0.3, L),
                          dtype=dtype, layout="sector_blocked")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("L", [12, 17])
def test_card_build_equals_host_build(cuda_device, L, dtype):
    """States and diagonal of the torch build on the card equal the host
    numpy build bit for bit (the diagonal is summed in float64 in the same
    order by both)."""
    m = _model(L, dtype)
    s_d, d_d, _ = sector_setup(m, cuda_device)
    s_h, d_h, _ = sector_setup(m, "cpu")
    assert s_d.device.type == "cuda" and d_d.dtype == dtype
    assert torch.equal(s_d.cpu(), s_h) and torch.equal(d_d.cpu(), d_h)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_apply_on_card_matches_cpu(cuda_device, dtype, tol):
    """The sector_blocked apply on the card (float64 included: no kernel),
    complex, against the CPU apply of the same vector, tol of max|y|."""
    m = _model(16, dtype)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.complex(*(torch.randn(m.n_states, generator=g,
                                    device=cuda_device, dtype=dtype)
                        for _ in range(2)))
    mv = pt.matvec_fn(m)  # the card by default
    assert mv.backend == "sector_blocked" and mv.diag.device.type == "cuda"
    want = pt.matvec_fn(m, device="cpu")(x.cpu())
    assert (mv(x).cpu() - want).abs().max() <= tol * want.abs().max()
