"""The bfloat16 instances of K1 and K2 on the card against their plain
versions (marked `gpu`: they need a CUDA device and skip elsewhere). Imports
no jax, so it also runs where JAX is not installed:
python -m pytest --noconftest tests/test_torch_cuda_bf16.py

The check is tight: the kernel's bf16 output against the plain version's
float32 value BEFORE rounding, |out - y32| <= 2^-8 |y32| + 1e-6 max|y32|
element by element (one rounding of 8 significand bits, plus the float32
reassociation inside the tile sums), and K2's float32 accumulator, which is
updated from the unrounded x, at the float32 tolerance K2 has. An indexing
or ordering error moves an element by far more than one rounding."""

import numpy as np
import pytest
import torch

import spindynamics_tpu_torch as pt
from spindynamics_tpu_torch.ops import cheb_term as ct
from spindynamics_tpu_torch.ops import kron_group as kg
from spindynamics_tpu_torch.ops.sector_kron import (
    apply_H_sector_kron, make_sector_kron_layout)
from spindynamics_tpu_torch.solvers.blockvec import bv_random

BF16 = torch.bfloat16
SCAL = (0.083, -0.41, 0.37, -0.62)  # 1/a, b, c_r, c_i


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("K1 and K2 run only on a CUDA device")
    return torch.device("cuda")


def _model(kind, L, splits):
    if kind == "longrange":  # lo|mid entries the kernels do not take
        hop = [(i, j, 0.3 + 0.1 * (i + j)) for i in range(L)
               for j in range(i + 1, L)]
        zz = [(i, i + 1, 0.2) for i in range(L - 1)] + [(0, L - 1, 0.15)]
        return pt.build_model(L, nup=L // 2, hopping=hop, zz=zz,
                              onsite_field=np.linspace(-0.1, 0.2, L),
                              kron_splits=splits)
    return pt.xxz_chain(L, Jxy=1.0, Jz=0.7, h=np.linspace(-0.2, 0.3, L),
                        nup=L // 2, kron_splits=splits)


def _one_rounding(out, y32):
    assert out.dtype == BF16 and y32.dtype == torch.float32
    d = (out.float() - y32).abs()
    lim = 2.0 ** -8 * y32.abs() + 1e-6 * y32.abs().max()
    return bool((d <= lim).all())


def _lift(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.float()
    return type(x)(_lift(y) for y in x)


CASES = [("chain", 12, (5, 4, 3)), ("chain", 16, None), ("chain", 20, None),
         ("longrange", 10, (4, 3, 3))]
IDS = ["L12", "L16", "L20", "L10-longrange"]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,L,splits", CASES, ids=IDS)
def test_k1_bf16_matches_plain(cuda_device, kind, L, splits):
    """Every fused group, without a seed, with the main path's seed and
    with the axpy seed: bf16 out, one rounding from the float32 value, pad
    slots exactly 0, one launch per call."""
    m = _model(kind, L, splits)
    lay = make_sector_kron_layout(m, m.kron_splits)
    g = torch.Generator(device=cuda_device).manual_seed(L)
    bv = bv_random(lay, g, BF16, cuda_device)
    b0 = bv_random(lay, g, BF16, cuda_device)
    H = pt.KronHamiltonian(lay, dtype=torch.float32, device=cuda_device)
    n_seeded = 0
    for gi in sorted(kg.fused_group_set(lay, H.top_k)):
        c = H.calls[gi]
        seed32 = (apply_H_sector_kron(bv.leaves, None, lay, H.tables,
                                      terms=c.seed_terms,
                                      group_filter=(gi,))[gi]
                  if c.has_seed else None)
        n_seeded += seed32 is not None
        ax = -0.37 * b0.leaves[gi].float()
        seeds = (None, None if seed32 is None else seed32.to(BF16),
                 (ax if seed32 is None else seed32 + ax).to(BF16))
        srcs = [bv.leaves[x[0]] for x in c.cross]
        srcsh = [bv.leaves[x[0]] for x in c.crossh]
        (_, _, _, ch, cm, cl, cmp, clp) = lay.groups[gi]
        for seed in seeds:
            n0 = kg.kernel_launch_count()
            got = kg.kron_group_apply(bv.leaves[gi], seed, srcs, srcsh, c)
            torch.cuda.synchronize()
            assert kg.kernel_launch_count() == n0 + 1
            y32 = kg.kron_group_apply_reference(
                bv.leaves[gi].float(), _lift(seed), _lift(srcs),
                _lift(srcsh), c)
            assert _one_rounding(got, y32)
            assert not got[:, cm:, :].any() and not got[:, :, cl:].any()
    assert n_seeded > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind,L,splits", CASES[:2] + CASES[3:],
                         ids=IDS[:2] + IDS[3:])
def test_fused_apply_bf16_on_card(cuda_device, kind, L, splits):
    """The whole apply on bf16 leaves (seeds, tail, unsupported entries, the
    axpy fold) on the card against the same apply on the CPU (K1's plain
    version): bf16 out, within two roundings of the scale (seeded groups
    round the seed and the output)."""
    m = _model(kind, L, splits)
    lay = make_sector_kron_layout(m, m.kron_splits)
    g = torch.Generator(device=cuda_device).manual_seed(L)
    bv = bv_random(lay, g, BF16, cuda_device)
    b0 = bv_random(lay, g, BF16, cuda_device)
    s = torch.tensor(-0.37, device=cuda_device)
    H = pt.KronHamiltonian(lay, dtype=torch.float32, device=cuda_device,
                           top_k=3 if kind == "longrange" else None)
    Hc = pt.KronHamiltonian(lay, dtype=torch.float32, device="cpu",
                            top_k=H.top_k)
    bc, b0c = (pt.BlockVec([x.cpu() for x in v.leaves]) for v in (bv, b0))
    for axpy in (False, True):
        n0 = kg.kernel_launch_count()
        got = (H(bv, s, b0) if axpy else H(bv)).leaves
        torch.cuda.synchronize()
        assert kg.kernel_launch_count() - n0 == min(H.top_k, len(lay.groups))
        want = (Hc(bc, s.cpu(), b0c) if axpy else Hc(bc)).leaves
        scale = max(float(w.float().abs().max()) for w in want)
        for a, b in zip(got, want):
            assert a.dtype == BF16
            assert float((a.cpu().float() - b.float()).abs().max()) \
                <= 2.0 ** -7 * scale


def _term_inputs(kind, L, splits, dev):
    """Main-path launch arguments of one term for every K2-fused group
    (cheb_term.term_launches): bf16 curr and prev, float32 acc."""
    m = _model(kind, L, splits)
    lay = make_sector_kron_layout(m, m.kron_splits)
    planes = pt.KronPlanes(pt.KronHamiltonian(lay, dtype=torch.float32,
                                              device=dev))
    g = torch.Generator(device=dev).manual_seed(L)
    curr, prev, acc = ((bv_random(lay, g, dt, dev), bv_random(lay, g, dt, dev))
                       for dt in (BF16, BF16, torch.float32))
    fused = kg.fused_group_set(lay, planes.cheb_top_k)
    return [(args, lay.groups[gi]) for gi, args in ct.term_launches(
        lay, planes.H.tables, planes.H.calls, fused, prev, curr, acc)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind,L,splits", CASES, ids=IDS)
def test_k2_bf16_matches_plain(cuda_device, kind, L, splits):
    """With the main path's seed and without one: next is bf16, one
    rounding from the float32 x; acc (float32, from the unrounded x) within
    max|d| <= 1e-5 max|acc|; pads 0; with out=prev the same bit for bit."""
    groups = _term_inputs(kind, L, splits, cuda_device)
    n0 = ct.kernel_launch_count()
    n_launch = n_seeded = 0
    for (T, prev, acc, seed, srcs, srcsh, call), grp in groups:
        (_, _, _, ch, cm, cl, cmp, clp) = grp
        n_seeded += seed is not None
        for sd in ((seed, None) if seed is not None else (None,)):
            assert T[0].dtype == BF16 and acc[0].dtype == torch.float32
            acc_k = tuple(x.clone() for x in acc)
            acc_p = tuple(x.clone() for x in acc)
            got = ct.cheb_term_apply(T, prev, acc_k, sd, srcs, srcsh, call,
                                     SCAL)
            x32 = ct.cheb_term_apply_reference(
                _lift(T), _lift(prev), acc_p, _lift(sd), _lift(srcs),
                _lift(srcsh), call, SCAL)
            torch.cuda.synchronize()
            for x, y in zip(got, x32):
                assert _one_rounding(x, y)
                assert not x[:, cm:, :].any() and not x[:, :, cl:].any()
            for x, y in zip(acc_k, acc_p):
                assert float((x - y).abs().max()) <= 1e-5 * float(
                    y.abs().max())
            own = tuple(x.clone() for x in prev)
            acc_o = tuple(x.clone() for x in acc)
            out = ct.cheb_term_apply(T, own, acc_o, sd, srcs, srcsh, call,
                                     SCAL, out=own)
            assert out is own
            assert all(torch.equal(x, y) for x, y in zip((*got, *acc_k),
                                                         (*own, *acc_o)))
            n_launch += 2
    assert ct.kernel_launch_count() - n0 == n_launch
    assert n_seeded > 0


@pytest.mark.gpu
def test_bf16_kernels_are_deterministic_and_refuse_mixed_dtypes(cuda_device):
    """Repeated launches are bit-identical; a launch whose state tensors
    differ in dtype, or whose accumulator is not float32, is refused."""
    groups = _term_inputs("chain", 16, None, cuda_device)
    (T, prev, acc0, seed, srcs, srcsh, call), _ = next(
        g for g in groups if g[0][3] is not None)
    runs = []
    for _ in range(3):
        acc = tuple(x.clone() for x in acc0)
        nxt = ct.cheb_term_apply(T, prev, acc, seed, srcs, srcsh, call, SCAL)
        k1 = kg.kron_group_apply(T[0], seed[0], [s[0] for s in srcs],
                                 [s[0] for s in srcsh], call)
        runs.append((*nxt, *acc, k1))
    for r in runs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(runs[0], r))
    with pytest.raises(TypeError, match="expected torch.bfloat16"):
        kg.kron_group_apply(T[0], seed[0].float(), [s[0] for s in srcs],
                            [s[0] for s in srcsh], call)
    with pytest.raises(TypeError, match="expected torch.bfloat16"):
        ct.cheb_term_apply(T, _lift(prev), acc0, seed, srcs, srcsh, call,
                           SCAL)
    with pytest.raises(TypeError, match="expected torch.float32"):
        ct.cheb_term_apply(T, prev, tuple(x.to(BF16) for x in acc0), seed,
                           srcs, srcsh, call, SCAL)


@pytest.mark.gpu
def test_bf16_trajectory_on_card(cuda_device):
    """evolve_trajectory_kron(state_dtype=bfloat16) on the card: bf16
    leaves, the launch counts of the float32 run (K1 for terms 0 and 1, K2
    for every later term), <Sz_i> within 2e-2 of the float32 trajectory."""
    L = 16
    m = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2)
    bits = pt.domain_wall_bitstring(m)
    counts, obs = [], []
    for sdt in (torch.float32, BF16):
        n1, n2 = kg.kernel_launch_count(), ct.kernel_launch_count()
        pair, o, info = pt.evolve_trajectory_kron(
            m, bits, 0.1, 3, cheb_n=20, Ebounds=(-9.0, 9.0),
            state_dtype=sdt)
        torch.cuda.synchronize()
        counts.append((kg.kernel_launch_count() - n1,
                       ct.kernel_launch_count() - n2))
        obs.append(o)
        assert all(l.dtype == sdt and l.is_cuda for P in pair
                   for l in P.leaves)
        assert info["norm_drift"] < (5e-2 if sdt == BF16 else 1e-4)
    assert counts[0] == counts[1] and min(counts[0]) > 0
    np.testing.assert_allclose(obs[1], obs[0], rtol=0, atol=2e-2)
    np.testing.assert_allclose(obs[1].sum(axis=1), 0.0, atol=1e-2)
