"""K3 on the card against its plain version (marked `gpu`: they need a CUDA
device and skip elsewhere), its routing through ops/apply, and the default
device. Imports no jax, so it also runs where JAX is not installed:
python -m pytest --noconftest tests/test_torch_cuda_flat.py"""

import numpy as np
import pytest
import torch

import spindynamics_tpu_torch as pt
from spindynamics_tpu_torch.ops import fused_matvec as fm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K3 runs only on a CUDA device")
    return torch.device("cuda")


def _model(L, kind):
    if kind == "longrange":
        hop = pt.long_range_hopping(L, lambda i, j: 1.0 / (j - i))
        zz = pt.long_range_hopping(L, lambda i, j: 0.3 / (j - i) ** 2)
        return pt.build_model(L, nup=L // 2, hopping=hop, zz=zz,
                              onsite_field=np.linspace(-0.2, 0.3, L),
                              layout="embedded")
    if kind == "full":
        return pt.xxz_chain(L, Jxy=1.0, Jz=0.5, h=np.linspace(-0.2, 0.3, L))
    return pt.xxz_chain(L, Jxy=1.0, Jz=0.5, h=np.linspace(-0.2, 0.3, L),
                        nup=L // 2, layout="embedded")


def _state(m, dev, cplx, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m.n_states, generator=g, device=dev)
    if cplx:
        x = torch.complex(x, torch.randn(m.n_states, generator=g, device=dev))
    mask = m.valid_mask(dev)
    return x if mask is None else torch.where(mask, x, torch.zeros_like(x))


@pytest.mark.gpu
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("L,kind", [(16, "chain"), (16, "longrange"),
                                    (13, "full"), (8, "chain"),
                                    (22, "chain")])
def test_k3_matches_plain(cuda_device, L, kind, cplx):
    """float32 FMAs in another order than the plain version's products:
    1e-6 of max |y|. In-sector input gives exact zeros outside the sector;
    the input is not modified; one launch per apply."""
    m = _model(L, kind)
    x = _state(m, cuda_device, cplx, seed=L)
    x0 = x.clone()
    n0 = fm.kernel_launch_count()
    y = pt.apply_H(x, m)  # backend=None: K3
    torch.cuda.synchronize()
    assert fm.kernel_launch_count() == n0 + 1
    want = fm.fused_matvec_apply_reference(x, m)
    assert y.dtype == x.dtype and y.data_ptr() != x.data_ptr()
    assert float((y - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert torch.equal(x, x0)
    mask = m.valid_mask(cuda_device)
    if mask is not None:
        assert not y[~mask].any()
    H = pt.matvec_fn(m)  # default device: the card
    assert H.backend == "fused" and H.device.type == "cuda"
    assert torch.equal(H(x), y)


@pytest.mark.gpu
def test_k3_is_deterministic(cuda_device):
    """Each output element is written once by one thread: repeated applies
    are bit-identical (the two-pass Lanczos relies on it)."""
    m = _model(20, "chain")
    for cplx in (False, True):
        x = _state(m, cuda_device, cplx, seed=1)
        first = fm.fused_matvec_apply(x, m)
        for _ in range(3):
            assert torch.equal(first, fm.fused_matvec_apply(x, m))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["chain", "longrange"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_k3_every_tile_matches_plain(cuda_device, cplx, kind):
    """Every tile from 2^8 to the largest that fits (2^15 float32, 2^14
    complex64 amplitudes: 128 KB of shared memory) at L=16: the plain
    version to 1e-6 of max |y|, exact zeros outside the sector, repeats
    bit-identical, one launch per apply."""
    m = _model(16, kind)
    x = _state(m, cuda_device, cplx, seed=3)
    want = fm.fused_matvec_apply_reference(x, m)
    scale = float(want.abs().max())
    mask = m.valid_mask(cuda_device)
    lo, hi = fm.tile_bits_range(cplx)
    assert (lo, hi) == ((1, 14) if cplx else (2, 15))
    for k in range(8, hi + 1):
        call = fm.FusedCall(fm.make_fused_plan(m, k, is_complex=cplx),
                            device=cuda_device)
        n0 = fm.kernel_launch_count()
        y = fm.fused_matvec_apply(x, m, call)
        torch.cuda.synchronize()
        assert fm.kernel_launch_count() == n0 + 1
        assert float((y - want).abs().max()) <= 1e-6 * scale, k
        assert not y[~mask].any(), k
        assert torch.equal(y, fm.fused_matvec_apply(x, m, call)), k


@pytest.mark.gpu
def test_k3_refuses_what_it_does_not_take(cuda_device):
    """A plan for the other element type and a state that is not 16-byte
    aligned (the bulk copies and vectors need it) raise; nothing runs."""
    m = _model(12, "chain")
    x = _state(m, cuda_device, False)
    real_call = fm.FusedCall(fm.make_fused_plan(m), device=cuda_device)
    n0 = fm.kernel_launch_count()
    with pytest.raises(ValueError, match="complex64"):
        fm.fused_matvec_apply(x.to(torch.complex64), m, real_call)
    buf = torch.zeros((1 << 12) + 1, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fm.fused_matvec_apply(buf[1:], m)
    assert fm.kernel_launch_count() == n0


@pytest.mark.gpu
def test_float64_on_cuda_has_no_default_backend(cuda_device):
    m = _model(12, "chain")
    x = _state(m, cuda_device, False).double()
    with pytest.raises(TypeError, match='backend="blocked"'):
        pt.apply_H(x, m)
    with pytest.raises(TypeError, match='backend="blocked"'):
        pt.matvec_fn(m)(x)
    with pytest.raises(TypeError, match='backend="blocked"'):
        fm.fused_matvec_apply(x.to(torch.complex128), m)
    y = pt.apply_H(x, m, backend="blocked")
    y32 = pt.apply_H(x.float(), m)
    assert float((y - y32.double()).abs().max()) <= 1e-5 * float(y.abs().max())
    with pytest.raises(ValueError, match="contiguous"):
        fm.fused_matvec_apply(torch.zeros(2 << 12, device=cuda_device)[::2], m)


@pytest.mark.gpu
def test_flat_groundstate_and_trajectory_on_the_card(cuda_device):
    """The L=12 ground state and a domain-wall trajectory through K3
    against the float64 dense oracle."""
    L = 12
    m = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2, layout="embedded")
    mask = m.valid_mask().numpy()
    ev, U = np.linalg.eigh(pt.build_dense_H(m)[np.ix_(mask, mask)])
    mv = pt.matvec_fn(m)
    n0 = fm.kernel_launch_count()
    E0, psi, info = pt.lanczos_groundstate_restarted(
        mv, N=m.n_states, lanc_m=40, cycles=6, target_residual=1e-4,
        mask=m.valid_mask(cuda_device),
        generator=torch.Generator(device=cuda_device).manual_seed(0))
    assert psi.device.type == "cuda" and abs(E0 - ev[0]) <= 1e-5
    assert fm.kernel_launch_count() > n0
    psi0 = pt.domain_wall_state(m)  # default device: the card
    assert psi0.device.type == "cuda"
    _, obs = pt.evolve_trajectory(
        m, psi0, 0.1, 5, cheb_n=40,
        generator=torch.Generator(device=cuda_device).manual_seed(7))
    idx = np.nonzero(mask)[0]
    c = U[np.searchsorted(idx, (1 << 6) - 1)]
    sz = ((idx[:, None] >> np.arange(L)) & 1) - 0.5
    exact = np.abs(U @ (np.exp(-0.5j * ev) * c)) ** 2 @ sz
    assert np.abs(obs[-1] - exact).max() <= 1e-4


@pytest.mark.gpu
def test_capacity_raises_on_the_card_and_below_the_floor_routes(cuda_device):
    """A CUDA state never gives way to the plain version quietly: above
    K3's list capacity (300 bonds local to the default 2^15 and 2^14
    tiles, against 256) apply_H and matvec_fn raise and name
    backend="blocked", for a float32 and a complex64 state. The one rule
    that routes a CUDA state to the blocked apply is the floor, L < 6."""
    hop = pt.nn_hopping(16, 1.0) + [(11, 12, 0.01)] * 300
    m = pt.build_model(16, nup=8, hopping=hop, layout="embedded")
    x = _state(m, cuda_device, False)
    n0 = fm.kernel_launch_count()
    for xs in (x, x.to(torch.complex64)):
        with pytest.raises(ValueError, match='backend="blocked"'):
            pt.apply_H(xs, m)
    with pytest.raises(ValueError, match='backend="blocked"'):
        pt.matvec_fn(m)
    H = pt.matvec_fn(m, backend="blocked")
    assert torch.equal(H(x), pt.apply_H(x, m, backend="blocked"))
    small = pt.xxz_chain(5, nup=2, layout="embedded")
    assert pt.matvec_fn(small).backend == "blocked"
    pt.apply_H(_state(small, cuda_device, False), small)
    assert fm.kernel_launch_count() == n0


def test_no_cuda_and_no_device_raises(monkeypatch):
    """Runs anywhere: with CUDA absent, an entry point called without
    `device` raises and names device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pt.groundstate_kron(pt.xxz_chain(8, nup=4))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pt.matvec_fn(pt.xxz_chain(8, nup=4, layout="embedded"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pt.domain_wall_state(pt.xxz_chain(8, nup=4, layout="embedded"))
