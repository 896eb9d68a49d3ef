"""The ell kernel on the card (marked `gpu`: they need a CUDA device and
skip elsewhere): against its plain version in float32, complex64, float64
and complex128 for compact, padded and full-with-table models; equal bits
on a repeat; one launch per FlatHamiltonian apply in a ground state and in
a kpm_sqw row; no host-to-device copy inside an apply. Imports no jax, so
it also runs where JAX is not installed:
python -m pytest --noconftest tests/test_torch_cuda_ell.py"""

import numpy as np
import pytest
import torch

import spindynamics_tpu_torch as pt
from spindynamics_tpu_torch.ops import ell_apply as ea
from spindynamics_tpu_torch.parallel.sharded_apply import pad_model
from spindynamics_tpu_torch.utils.profiling import counters

# float32 sums of up to 19 bonds in two orders (the plain version's gemv,
# the kernel's FMAs); float64 the same at its epsilon
TOL = {torch.float32: 1e-6, torch.complex64: 1e-6, torch.float64: 1e-13,
       torch.complex128: 1e-13}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the ell kernel runs only on a CUDA device")
    return torch.device("cuda")


def _model(kind, L, dtype):
    rdt = torch.float64 if dtype in (torch.float64, torch.complex128) \
        else torch.float32
    fld = np.linspace(-0.2, 0.3, L)
    if kind == "full":
        return pt.build_model(L, hopping=pt.nn_hopping(L, 0.8),
                              onsite_field=fld, zz=[(0, 3, 0.4), (2, 5, -0.3)],
                              dtype=rdt, build_neighbor_table=True)
    m = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, h=fld, nup=L // 2,
                     layout="compact", dtype=rdt)
    return pad_model(m, 7) if kind == "padded" else m


def _state(n, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rdt = torch.float64 if dtype in (torch.float64, torch.complex128) \
        else torch.float32
    x = torch.randn(n, generator=g, device=dev, dtype=rdt)
    if dtype.is_complex:
        x = torch.complex(x, torch.randn(n, generator=g, device=dev,
                                         dtype=rdt))
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64,
                                   torch.float64, torch.complex128])
@pytest.mark.parametrize("kind,L", [("compact", 12), ("compact", 20),
                                    ("padded", 16), ("full", 14)])
def test_kernel_matches_plain(cuda_device, kind, L, dtype):
    """The kernel (a FlatHamiltonian on the card and the functional apply)
    against the plain version on the card, TOL of max|y|; pad rows exact
    zeros; a repeat equal in every bit; one launch an apply."""
    m = _model(kind, L, dtype)
    mv = pt.matvec_fn(m, device=cuda_device)
    x = _state(m.n_states, dtype, cuda_device, L)
    want = ea.ell_apply_plain(x, mv.nbr, mv.diag, mv.hop_J)
    n0 = ea.ell_launch_count()
    y = mv(x)
    assert ea.ell_launch_count() - n0 == 1
    assert y.dtype == dtype and y.device == x.device
    assert (y - want).abs().max() <= TOL[dtype] * want.abs().max()
    assert torch.equal(y, mv(x))
    assert torch.equal(pt.apply_H_ell(x, m), y)
    if kind == "padded":
        assert torch.all(y[m.dim:] == 0)


@pytest.mark.gpu
def test_misaligned_table_and_no_bonds(cuda_device):
    """A table whose base is not 16-byte aligned takes the word copies; a
    model without bonds gives diag psi; both in one launch."""
    m = _model("compact", 14, torch.float32)
    mv = pt.matvec_fn(m, device=cuda_device)
    x = _state(m.n_states, torch.float32, cuda_device, 3)
    buf = torch.empty(mv.nbr.numel() + 1, dtype=torch.int32,
                      device=cuda_device)
    nbr = buf[1:].view(mv.nbr.shape)
    nbr.copy_(mv.nbr)
    assert nbr.data_ptr() % 16 != 0
    y = ea.ell_apply(x, nbr, mv.diag, mv.hop_J)
    assert torch.equal(y, mv(x))
    empty = torch.empty((m.n_states, 0), dtype=torch.int32,
                        device=cuda_device)
    z = ea.ell_apply(x, empty, mv.diag, mv.hop_J[:0])
    assert torch.equal(z, x * mv.diag)


def _launches(dtype):
    return counters().get("launches.ell." + str(dtype)[6:], 0)


@pytest.mark.gpu
def test_one_launch_per_apply_in_solves(cuda_device):
    """In a restarted ground state and a kpm_sqw row, every FlatHamiltonian
    apply is one ell launch: float32 applies in the ground state, complex64
    in the row, counted by `launches.ell.<dtype>` and by
    ell_launch_count()."""
    m = _model("compact", 16, torch.float32)
    mv = pt.matvec_fn(m, device=cuda_device)
    applies = [0]

    def hook(mod, args, out):
        if mod is mv:
            applies[0] += 1

    h = mv.register_forward_hook(hook)
    try:
        n0, f0 = ea.ell_launch_count(), _launches(torch.float32)
        E0, psi, _ = pt.lanczos_groundstate_restarted(
            mv, N=m.n_states, lanc_m=30, cycles=2,
            generator=torch.Generator(device=cuda_device).manual_seed(0),
            device=cuda_device)
        assert applies[0] > 0
        assert _launches(torch.float32) - f0 == applies[0]
        assert ea.ell_launch_count() - n0 == applies[0]
        applies[0], n0 = 0, ea.ell_launch_count()
        c0 = _launches(torch.complex64)
        S = pt.kpm_sqw(psi, m, [np.pi / 2], np.linspace(0, 4, 50), a=8.0,
                       b=0.0, kpm_m=20, E0=float(E0), matvec=mv)
        assert np.all(np.isfinite(S.cpu().numpy()))
        assert applies[0] > 0
        assert _launches(torch.complex64) - c0 == applies[0]
        assert ea.ell_launch_count() - n0 == applies[0]
    finally:
        h.remove()


@pytest.mark.gpu
def test_no_host_to_device_copy_in_an_apply(cuda_device):
    """Under torch.profiler an apply of an ell FlatHamiltonian shows the
    ell kernel once and no host-to-device copy (the couplings are a
    buffer)."""
    from torch.profiler import ProfilerActivity, profile

    m = _model("compact", 16, torch.float32)
    mv = pt.matvec_fn(m, device=cuda_device)
    x = _state(m.n_states, torch.float32, cuda_device, 5)
    mv(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mv(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert sum("ell_kernel" in n for n in names) == 1, names
    assert not [n for n in names if "HtoD" in n or "cudaMemcpy" in n], names
