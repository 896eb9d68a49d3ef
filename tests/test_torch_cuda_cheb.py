"""K2 on the card against its plain version (marked `gpu`: they need a CUDA
device and skip elsewhere), on both routes of its K segments (bf16 tensor
cores where the tables are exactly bf16, float32 FMAs where they are not)
for float32 and bfloat16 states, and the refusal of a fused float64
trajectory on CUDA. Imports no jax, so it also runs where JAX is not installed:
python -m pytest --noconftest tests/test_torch_cuda_cheb.py"""

import numpy as np
import pytest
import torch

import spindynamics_tpu_torch as pt
from spindynamics_tpu_torch.ops import cheb_term as ct
from spindynamics_tpu_torch.ops import kron_group as kg
from spindynamics_tpu_torch.ops.sector_kron import make_sector_kron_layout
from spindynamics_tpu_torch.solvers.blockvec import bv_random


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K2 runs only on a CUDA device")
    return torch.device("cuda")


def _term_inputs(L, splits, dev, dtype=torch.float32, Jxy=1.0,
                 sdt=None):
    """Main-path launch arguments of one term for every K2-fused group
    (cheb_term.term_launches), from random curr, prev and acc pairs: the
    states in `sdt` (default: the tables' dtype), acc in the tables'."""
    m = pt.xxz_chain(L, Jxy=Jxy, Jz=0.7, h=np.linspace(-0.2, 0.3, L),
                     nup=L // 2, kron_splits=splits)
    lay = make_sector_kron_layout(m, m.kron_splits)
    planes = pt.KronPlanes(pt.KronHamiltonian(lay, dtype=dtype, device=dev))
    g = torch.Generator(device=dev).manual_seed(L)
    sdt = dtype if sdt is None else sdt
    curr, prev, acc = ((bv_random(lay, g, dt, dev), bv_random(lay, g, dt, dev))
                       for dt in (sdt, sdt, dtype))
    fused = kg.fused_group_set(lay, planes.cheb_top_k)
    return [(args, lay.groups[gi]) for gi, args in ct.term_launches(
        lay, planes.H.tables, planes.H.calls, fused, prev, curr, acc)]


SCAL = (0.083, -0.41, 0.37, -0.62)  # 1/a, b, c_r, c_i


@pytest.mark.gpu
@pytest.mark.parametrize("L,splits", [(12, (5, 4, 3)), (16, None),
                                      (20, None)])
def test_k2_matches_plain(cuda_device, L, splits):
    """next and acc within max|d|/max|y| <= 1e-5 (float32 reassociation
    inside the tile sums, the bound K1 meets); pad slots exactly 0."""
    groups = _term_inputs(L, splits, cuda_device)
    n0 = ct.kernel_launch_count()
    for (T, prev, acc, seed, srcs, srcsh, call), grp in groups:
        acc_k = tuple(x.clone() for x in acc)
        acc_p = tuple(x.clone() for x in acc)
        got = ct.cheb_term_apply(T, prev, acc_k, seed, srcs, srcsh, call,
                                 SCAL)
        want = ct.cheb_term_apply_reference(T, prev, acc_p, seed, srcs,
                                            srcsh, call, SCAL)
        torch.cuda.synchronize()
        (_, _, _, ch, cm, cl, cmp, clp) = grp
        for x, y in zip((*got, *acc_k), (*want, *acc_p)):
            assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())
        for x in got:
            assert not x[:, cm:, :].any() and not x[:, :, cl:].any()
    assert ct.kernel_launch_count() - n0 == len(groups)


@pytest.mark.gpu
def test_k2_refuses_float64(cuda_device):
    args, _ = _term_inputs(12, (5, 4, 3), cuda_device, torch.float64)[0]
    with pytest.raises(TypeError, match="float32"):
        ct.cheb_term_apply(*args, SCAL)


@pytest.mark.gpu
def test_k2_is_deterministic(cuda_device):
    """Each element is computed by one thread in a fixed order: repeated
    terms from the same inputs are bit-identical."""
    for (T, prev, acc0, seed, srcs, srcsh, call), _ in _term_inputs(
            20, None, cuda_device):
        runs = []
        for _ in range(3):
            acc = tuple(x.clone() for x in acc0)
            nxt = ct.cheb_term_apply(T, prev, acc, seed, srcs, srcsh, call,
                                     SCAL)
            runs.append((*nxt, *acc))
        for r in runs[1:]:
            assert all(torch.equal(x, y) for x, y in zip(runs[0], r))


@pytest.mark.gpu
def test_k2_writes_next_over_prev(cuda_device):
    """With out=prev (the scan's storage reuse) K2 gives the same next and
    acc bit for bit as with fresh outputs."""
    for (T, prev, acc0, seed, srcs, srcsh, call), _ in _term_inputs(
            16, None, cuda_device):
        acc1 = tuple(x.clone() for x in acc0)
        acc2 = tuple(x.clone() for x in acc0)
        fresh = ct.cheb_term_apply(T, prev, acc1, seed, srcs, srcsh, call,
                                   SCAL)
        own = tuple(x.clone() for x in prev)
        got = ct.cheb_term_apply(T, own, acc2, seed, srcs, srcsh, call,
                                 SCAL, out=own)
        assert got is own
        assert all(torch.equal(x, y) for x, y in zip((*fresh, *acc1),
                                                     (*own, *acc2)))


@pytest.mark.gpu
@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("route,Jxy", [("tc", 1.0), ("fma", 0.3)],
                         ids=["tc", "fma"])
def test_k2_routes_match_plain(cuda_device, route, Jxy, sdt):
    """Both routes (Jxy = 1: exactly-bf16 W_lo and W_mid on the tensor
    cores; Jxy = 0.3: on the FMAs) and both state types against the plain
    version on the lifted inputs: float32 next and acc within 1e-5 of
    max|y|; bfloat16 next one rounding of the float32 x (2^-8 |x| + 1e-5
    max|x|), acc (float32, from the unrounded x) within 1e-5; pads 0; a
    repeat bit-identical."""
    groups = _term_inputs(16, None, cuda_device, Jxy=Jxy, sdt=sdt)
    for (T, prev, acc, seed, srcs, srcsh, call), grp in groups:
        if call.W_lo is not None:
            assert call.exact[0] == (route == "tc")
        lift = (lambda p: None if p is None else tuple(x.float() for x in p))
        acc_k = tuple(x.clone() for x in acc)
        acc_p = tuple(x.clone() for x in acc)
        got = ct.cheb_term_apply(T, prev, acc_k, seed, srcs, srcsh, call,
                                 SCAL)
        acc_r = tuple(x.clone() for x in acc)
        again = ct.cheb_term_apply(T, prev, acc_r, seed, srcs, srcsh, call,
                                   SCAL)
        want = ct.cheb_term_apply_reference(
            lift(T), lift(prev), acc_p, lift(seed),
            [lift(s) for s in srcs], [lift(s) for s in srcsh], call, SCAL)
        torch.cuda.synchronize()
        (_, _, _, ch, cm, cl, cmp, clp) = grp
        for x, y in zip(got, want):
            d = (x.float() - y).abs()
            if sdt == torch.float32:
                assert float(d.max()) <= 1e-5 * float(y.abs().max())
            else:
                assert x.dtype == torch.bfloat16
                assert bool((d <= 2.0 ** -8 * y.abs()
                             + 1e-5 * y.abs().max()).all())
            assert not x[:, cm:, :].any() and not x[:, :, cl:].any()
        for x, y in zip(acc_k, acc_p):
            assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())
        assert all(torch.equal(a, b) for a, b in zip((*got, *acc_k),
                                                     (*again, *acc_r)))


def test_fused_float64_trajectory_on_cuda_is_refused():
    """A fused float64 trajectory on CUDA raises instead of running the
    plain apply there. The check comes before any tensor is made, so this
    runs with or without a card."""
    m = pt.xxz_chain(12, nup=6, dtype=torch.float64)
    with pytest.raises(ValueError, match="fused=False"):
        pt.evolve_trajectory_kron(m, pt.domain_wall_bitstring(m), 0.1, 1,
                                  state_dtype=torch.float64, device="cuda")
