"""The dot2 kernel on the card (marked `gpu`: they need a CUDA device and
skip elsewhere): bit for bit its host emulation, within one float32 ulp
of the float64 reference and no farther from the plain Dot2 than Dot2's
own error, equal bits on a repeat, complex vdot2 and float64 leaves, and
an L=16 restarted kron ground state through it. Imports no jax, so it also
runs where JAX is not installed:
python -m pytest --noconftest tests/test_torch_cuda_dot2.py"""

import math

import numpy as np
import pytest
import torch

import spindynamics_tpu_torch as pt
from _dot2_emulation import _emulate_dot2
from spindynamics_tpu_torch.ops import dot2 as d2
from spindynamics_tpu_torch.utils import compensated as comp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the dot2 kernel runs only on a CUDA device")
    return torch.device("cuda")


def _rand(n, seed, dev, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(n, generator=g, device=dev).to(dtype)


def _cases(dev):
    lens = [0, 1, 3, 7, 1001, 4099, (1 << 20) + 3, 5]
    c = {"odd_lengths": ([_rand(n, i, dev) for i, n in enumerate(lens)],
                         [_rand(n, 50 + i, dev) for i, n in enumerate(lens)])}
    n_many = d2.MAX_LEAVES + 9
    c["chunked"] = ([_rand(1000 + 37 * i, i, dev) for i in range(n_many)],
                    [_rand(1000 + 37 * i, 500 + i, dev)
                     for i in range(n_many)])
    z = torch.complex(_rand(300_007, 1, dev), _rand(300_007, 2, dev))
    w = torch.complex(_rand(300_007, 3, dev), _rand(300_007, 4, dev))
    c["complex_planes"] = ([z.real, z.imag], [w.real, w.imag])
    x = _rand((1 << 21) + 1, 5, dev)
    c["norm"] = ([x, z.real, z.imag], [x, z.real, z.imag])
    b = _rand(500_003, 6, dev, torch.bfloat16)
    c["bfloat16"] = ([b, b, _rand(500_008, 7, dev, torch.bfloat16)],
                     [b, _rand(500_003, 8, dev),
                      _rand(500_008, 9, dev, torch.bfloat16)])
    buf = _rand(600_000, 10, dev)
    c["misaligned"] = ([buf[1:], buf[4:]], [_rand(599_999, 11, dev),
                                            _rand(599_996, 12, dev)])
    return c


def _reader(call):
    """_emulate_dot2's reader for card tensors: each 1-D view of the call
    by its address, copied to the host."""
    host = {}
    for fa, _, fb, _, _ in call.leaves:
        for f in (fa, fb):
            host[f.data_ptr()] = f.cpu().double().numpy().reshape(-1)

    def read(ptr, n, stride, kind):
        a = host[ptr]
        assert a.size == n
        return a
    return read


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["odd_lengths", "chunked", "complex_planes",
                                  "norm", "bfloat16", "misaligned"])
def test_kernel_matches_emulation_and_reference(cuda_device, case):
    xs, ys = _cases(cuda_device)[case]
    n0 = d2.dot2_launch_count()
    k = comp.dot2_leaves(xs, ys)
    k2 = comp.dot2_leaves(xs, ys)
    torch.cuda.synchronize()
    n_desc = -(-len(xs) // d2.MAX_LEAVES)
    assert d2.dot2_launch_count() - n0 == 2 * n_desc
    assert k.dtype == torch.float32 and k.device.type == "cuda"
    assert torch.equal(k, k2)  # deterministic
    call = d2.describe(xs, ys,
                       torch.cuda.get_device_properties(cuda_device)
                       .multi_processor_count)
    assert float(k) == float(_emulate_dot2(call, _reader(call)))
    ref = float(sum(torch.dot(a.reshape(-1).double(), b.reshape(-1).double())
                    for a, b in zip(xs, ys)))
    ulp = float(np.spacing(np.float32(abs(ref))))
    assert abs(float(k) - ref) <= ulp
    plain = float(comp.dot2_leaves_plain(xs, ys))
    assert abs(float(k) - plain) <= abs(plain - ref) + ulp


@pytest.mark.gpu
def test_complex_vdot2_and_norm2(cuda_device):
    """vdot2 of complex64 vectors (re: one launch over both planes, im:
    two) within one ulp per part of the complex128 vdot; norm2 in one
    launch; a BlockVec of complex leaves through _inner_c likewise."""
    z = torch.complex(_rand(1 << 20, 1, cuda_device),
                      _rand(1 << 20, 2, cuda_device))
    w = torch.complex(_rand(1 << 20, 3, cuda_device),
                      _rand(1 << 20, 4, cuda_device))
    n0 = d2.dot2_launch_count()
    got = comp.vdot2(z, w)
    assert d2.dot2_launch_count() - n0 == 3
    want = complex(torch.vdot(z.cdouble(), w.cdouble()))
    for g, r in ((got.real, want.real), (got.imag, want.imag)):
        assert abs(float(g) - r) <= float(np.spacing(np.float32(abs(r))))
    n0 = d2.dot2_launch_count()
    nrm = comp.norm2(z)
    assert d2.dot2_launch_count() - n0 == 1
    r = math.sqrt(float(torch.vdot(z.cdouble(), z.cdouble()).real))
    assert abs(float(nrm) - r) <= 2 * float(np.spacing(np.float32(r)))
    from spindynamics_tpu_torch.solvers import lanczos as tla

    zs = pt.BlockVec([z[:1000].reshape(10, 100), z[1000:]])
    ws = pt.BlockVec([w[:1000].reshape(10, 100), w[1000:]])
    n0 = d2.dot2_launch_count()
    got = tla._inner_c(zs, ws, True)
    assert d2.dot2_launch_count() - n0 == 3
    for g, r in ((got.real, want.real), (got.imag, want.imag)):
        assert abs(float(g) - r) <= float(np.spacing(np.float32(abs(r))))


@pytest.mark.gpu
def test_float64_leaves(cuda_device):
    """A float64 call keeps float64 (FMA-rounded products): within 1e-13
    of sum |x y| of math.fsum; float32 leaves beside float64 are read as
    float64; repeats equal."""
    xs = [_rand(n, i, cuda_device, torch.float64) for i, n in
          enumerate((100_003, 7, 65_536))]
    ys = [_rand(n, 9 + i, cuda_device, torch.float64) for i, n in
          enumerate((100_003, 7, 65_536))]
    ys[1] = ys[1].float()
    k = comp.dot2_leaves(xs, ys)
    assert k.dtype == torch.float64 and torch.equal(k, comp.dot2_leaves(xs,
                                                                        ys))
    prods = [float(v) for a, b in zip(xs, ys)
             for v in (a.cpu().double() * b.cpu().double()).numpy()]
    exact = math.fsum(prods)
    assert abs(float(k) - exact) <= 1e-13 * math.fsum(abs(p) for p in prods)


@pytest.mark.gpu
def test_kron_groundstate_through_dot2(cuda_device, monkeypatch):
    """An L=16 restarted kron ground state on the card (K1 and the dot2
    kernel): E0 within 1e-5 of the CPU run (plain apply, plain Dot2),
    residual <= 1e-3, and at most 2 launches per compensated dot (one at
    L=16: fewer leaves than one table holds)."""
    m = pt.heisenberg_chain(16, nup=8)
    calls = []
    launch = d2.dot2_launch

    def counted(xs, ys):
        calls.append(len(xs))
        return launch(xs, ys)

    monkeypatch.setattr(d2, "dot2_launch", counted)
    n0 = d2.dot2_launch_count()
    E0, psi, info, _ = pt.groundstate_kron(m, lanc_m=40, cycles=6,
                                           target_residual=1e-3,
                                           device=cuda_device)
    n = d2.dot2_launch_count() - n0
    monkeypatch.undo()
    E0c, _, infoc, _ = pt.groundstate_kron(m, lanc_m=40, cycles=6,
                                           target_residual=1e-3,
                                           device="cpu")
    assert calls and n <= 2 * len(calls) and n == len(calls)
    assert info["residual"] <= 1e-3
    assert abs(E0 - E0c) <= 1e-5, (E0, E0c)
