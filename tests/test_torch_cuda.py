"""K1 on the card against its plain version (marked `gpu`: they need a CUDA
device and skip elsewhere), on both routes of its K segments (bf16 tensor
cores where the tables are exactly bf16, float32 FMAs where they are not),
for float32 and bfloat16 states, unsharded and in the crossw variant; and
the refusal of fused float64 solves on CUDA. Imports no jax, so it also
runs where JAX is not installed:
python -m pytest --noconftest tests/test_torch_cuda.py"""

import numpy as np
import pytest
import torch

import spindynamics_tpu_torch as pt
from spindynamics_tpu_torch.ops import kron_group as kg
from spindynamics_tpu_torch.ops.sector_kron import (
    apply_H_sector_kron, make_sector_kron_layout)
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


# the route of every table: Jxy = 1 gives exactly-bf16 W_lo, W_mid and lo|mid
# factors (the tensor cores), Jxy = 0.3 tables that are not (the FMAs)
ROUTES = {"tc": 1.0, "fma": 0.3}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _route_model(route, L=16, splits=None):
    return pt.xxz_chain(L, Jxy=ROUTES[route], Jz=0.7,
                        h=np.linspace(-0.2, 0.3, L), nup=L // 2,
                        kron_splits=splits)


def _check_close(got, want, sdt, what):
    """float32: max|d| <= 1e-5 max|y| (the float32 sums' order and the
    hi/lo split's 2^-16 per product). bfloat16: one rounding of the plain
    float32 value, |d| <= 2^-8 |y| + 1e-5 max|y|."""
    y = want.float()
    d = (got.float() - y).abs()
    if sdt == torch.float32:
        assert float(d.max()) <= 1e-5 * float(y.abs().max()), what
    else:
        assert got.dtype == torch.bfloat16
        assert bool((d <= 2.0 ** -8 * y.abs()
                     + 1e-5 * y.abs().max()).all()), what


@pytest.mark.gpu
@pytest.mark.parametrize("sdt", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("route", ROUTES)
def test_k1_routes_match_plain(cuda_device, route, sdt):
    """Every fused group, with the main path's seed: the kernel against its
    plain version on the lifted inputs; pad slots exactly 0; a second launch
    on the same inputs bit-identical. The calls' flags say which route each
    segment takes."""
    m = _route_model(route)
    lay = make_sector_kron_layout(m, m.kron_splits)
    H = pt.KronHamiltonian(lay, dtype=torch.float32, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    bv = bv_random(lay, g, sdt, cuda_device)
    n_tc = n_fma = 0
    for gi in sorted(kg.fused_group_set(lay, H.top_k)):
        c = H.calls[gi]
        e_lo, e_mid, e_cross = c.exact
        assert all(e == (route == "tc") for e in e_cross)
        for e, t in ((e_lo, c.W_lo), (e_mid, c.W_mid_T)):
            if t is not None:
                assert e == (route == "tc")
                n_tc, n_fma = n_tc + e, n_fma + (not e)
        seed = (apply_H_sector_kron(bv.leaves, None, lay, H.tables,
                                    terms=c.seed_terms, group_filter=(gi,))[gi]
                if c.has_seed else None)
        args = (bv.leaves[gi], None if seed is None else seed.to(sdt),
                [bv.leaves[x[0]] for x in c.cross],
                [bv.leaves[x[0]] for x in c.crossh], c)
        got = kg.kron_group_apply(*args)
        again = kg.kron_group_apply(*args)
        want = kg.kron_group_apply_reference(
            *[a.float() if isinstance(a, torch.Tensor) else
              [x.float() for x in a] if isinstance(a, list) else a
              for a in args])
        torch.cuda.synchronize()
        _check_close(got, want, sdt, f"group {gi}")
        assert torch.equal(got, again)
        (_, _, _, ch, cm, cl, cmp, clp) = lay.groups[gi]
        assert not got[:, cm:].any() and not got[:, :, cl:].any()
    assert (n_tc > 0) == (route == "tc") and (n_fma > 0) == (route == "fma")


@pytest.mark.gpu
@pytest.mark.parametrize("sdt", DTYPES.values(), ids=DTYPES.keys())
@pytest.mark.parametrize("route", ROUTES)
def test_k1_crossw_routes_match_cpu(cuda_device, route, sdt):
    """The sharded apply on LocalMesh(2) of the card (K1's crossw variant on
    every fused local block) against the same apply on the CPU (the plain
    version), on both routes: float32 1e-5 of max|y|, bfloat16 one unit of
    2^-7 |y| (both round a float32 sum once); pads 0; repeats identical."""
    m = _route_model(route, 16, (6, 4, 6))
    lay = make_sector_kron_layout(m, m.kron_splits)
    mesh = pt.LocalMesh(2, cuda_device)
    H = pt.ShardedKronHamiltonian(lay, mesh)
    Hc = pt.ShardedKronHamiltonian(lay, pt.LocalMesh(2, "cpu"))
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = bv_random(lay, g, sdt, cuda_device, shard=(H.spec, mesh))
    kg.reset_kernel_launch_count()
    y = H(x)
    torch.cuda.synchronize()
    assert kg.kernel_launch_count(sdt, crossw=True) > 0
    want = Hc(pt.BlockVec([l.cpu() for l in x.leaves], Hc.mesh))
    scale = max(float(w.float().abs().max()) for w in want.leaves)
    for a, b, (_, _, _, ch, cm, cl, _, _) in zip(y.leaves, want.leaves,
                                                 lay.groups):
        a, b = a.cpu().float(), b.float()
        if sdt == torch.float32:
            assert float((a - b).abs().max()) <= 1e-5 * scale
        else:
            assert bool(((a - b).abs()
                         <= 2.0 ** -7 * b.abs() + 1e-5 * scale).all())
        assert not a[ch:].any()
        assert not a[:, cm:].any() and not a[:, :, cl:].any()
    assert all(torch.equal(p, q) for p, q in zip(y.leaves, H(x).leaves))
