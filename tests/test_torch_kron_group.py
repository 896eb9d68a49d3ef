"""The port's kron apply against the JAX package: the plain blocks-mode
apply in f64, K1's plain version (the CPU path of apply_H_sector_kron_fused)
in f32 against the JAX fused apply (Pallas interpret mode) and the x64
oracle, the axpy seed, pad slots, and an emulation of the CUDA kernel's tile
and descriptor arithmetic. The kernel itself is tested on the card in
tests/test_torch_cuda.py."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu.ops import sector_kron as jsk
from spindynamics_tpu.ops.pallas_kron import (
    apply_H_sector_kron_fused as j_fused)
from spindynamics_tpu_torch.ops import kron_group as kg
from spindynamics_tpu_torch.ops import sector_kron as tsk


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per test process, so
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(L, splits=None, Jz=0.7, field=True, longrange=False):
    if longrange:
        hop = [(i, j, 0.3 + 0.1 * (i + j)) for i in range(L)
               for j in range(i + 1, L)]
        zz = [(i, i + 1, 0.2) for i in range(L - 1)] + [(0, L - 1, 0.15)]
        kw = dict(nup=L // 2, hopping=hop, zz=zz,
                  onsite_field=np.linspace(-0.1, 0.2, L), kron_splits=splits)
        mj = sd.build_model(L, dtype=jnp.float64, layout="sector_kron", **kw)
        mt = pt.build_model(L, dtype=torch.float64, **kw)
    else:
        fld = np.linspace(-0.2, 0.3, L) if field else None
        kw = dict(Jxy=1.0, Jz=Jz, h=fld, nup=L // 2, kron_splits=splits)
        mj = sd.xxz_chain(L, dtype=jnp.float64, layout="sector_kron", **kw)
        mt = pt.xxz_chain(L, dtype=torch.float64, **kw)
    return (mj, jsk.make_sector_kron_layout(mj, mj.kron_splits),
            mt, tsk.make_sector_kron_layout(mt, mt.kron_splits))


def _state(mj, lay, seed):
    """Numpy-made random state, zero on pad slots (flat, f64)."""
    x = np.random.default_rng(seed).standard_normal(lay.n_states)
    return np.where(np.asarray(mj.valid_mask()), x, 0.0)


def _pads(lay):
    """Per-group boolean masks of the tile-pad slots."""
    out = []
    for (_, _, _, ch, cm, cl, cmp, clp) in lay.groups:
        m = np.ones((ch, cmp, clp), bool)
        m[:, :cm, :cl] = False
        out.append(m)
    return out


TERMS = ["all", "diag", "lo", "mid", "hi", "cross", "crossl", "crossh",
         "diag,lo,mid,crossl", "hi,crossh"]


@pytest.mark.parametrize("longrange", [False, True], ids=["xxz", "longrange"])
@pytest.mark.parametrize("terms", TERMS)
def test_blocks_apply_matches_jax_f64(terms, longrange):
    if longrange:
        mj, lj, mt, lt = _models(9, splits=(3, 3, 3), longrange=True)
    else:
        mj, lj, mt, lt = _models(12, splits=(5, 4, 3))
    x = _state(mj, lj, 1)
    yj = jsk.apply_H_sector_kron(list(jsk.flat_to_blocks(jnp.asarray(x), lj)),
                                 None, lj, terms=terms)
    yt = tsk.apply_H_sector_kron(tsk.flat_to_blocks(torch.as_tensor(x), lt),
                                 None, lt, terms=terms)
    scale = max(1.0, max(float(np.abs(np.asarray(a)).max()) for a in yj))
    for a, b in zip(yj, yt):
        assert b.dtype == torch.float64
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-10 * scale


def test_blocks_apply_group_filter():
    mj, lj, mt, lt = _models(12, splits=(5, 4, 3))
    x = _state(mj, lj, 2)
    keep = (0, 3, len(lj.groups) - 1)
    yj = jsk.apply_H_sector_kron(list(jsk.flat_to_blocks(jnp.asarray(x), lj)),
                                 None, lj, group_filter=keep)
    yt = tsk.apply_H_sector_kron(tsk.flat_to_blocks(torch.as_tensor(x), lt),
                                 None, lt, group_filter=keep)
    scale = max(float(np.abs(np.asarray(a)).max()) for a in yj)
    for gi, (a, b) in enumerate(zip(yj, yt)):
        if gi in keep:
            assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-10 * scale
        else:  # JAX returns zero leaves, the port None
            assert b is None and not np.any(np.asarray(a))


@pytest.mark.parametrize("fuse_crossh", [True, False])
@pytest.mark.parametrize("L", [12, 14])
def test_fused_apply_matches_jax_and_x64(L, fuse_crossh):
    mj, lj, mt, lt = _models(L)
    x = _state(mj, lj, 0)
    y64 = jsk.apply_H_sector_kron(jnp.asarray(x), None, lj)  # x64 oracle
    y64 = [np.asarray(b) for b in jsk.flat_to_blocks(y64, lj)]
    bj = jsk.flat_to_blocks(jnp.asarray(x, jnp.float32), lj)
    yj = j_fused(bj, lj, fuse_crossh=fuse_crossh)
    bt = tsk.flat_to_blocks(torch.as_tensor(x, dtype=torch.float32), lt)
    H = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32,
                           fuse_crossh=fuse_crossh)
    n0 = kg.kernel_launch_count()
    yt = kg.apply_H_sector_kron_fused(bt, lt, H.tables, H.calls)
    assert kg.kernel_launch_count() == n0  # CPU tensors: the plain version
    scale = max(float(np.abs(b).max()) for b in y64)
    for a, b, c, pad in zip(yj, yt, y64, _pads(lt)):
        assert b.dtype == torch.float32
        got = b.double().numpy()
        assert np.abs(got - np.asarray(a, np.float64)).max() < 5e-6 * scale
        assert np.abs(got - c).max() < 5e-6 * scale
        assert np.all(got[pad] == 0.0)


def test_fused_top_k_and_unsupported_terms():
    # long-range hopping gives lo|mid terms K1 does not take (multi-run mid
    # factors): they go through _unsupported_terms; top_k=3 leaves a tail
    mj, lj, mt, lt = _models(10, splits=(4, 3, 3), longrange=True)
    assert any(p.unsupported for p in kg.fused_group_plans(lt))
    x = _state(mj, lj, 4)
    y64 = jsk.apply_H_sector_kron(jnp.asarray(x), None, lj)
    y64 = [np.asarray(b) for b in jsk.flat_to_blocks(y64, lj)]
    bt = tsk.flat_to_blocks(torch.as_tensor(x, dtype=torch.float32), lt)
    H = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32, top_k=3)
    yt = H(pt.BlockVec(bt)).leaves
    scale = max(float(np.abs(b).max()) for b in y64)
    for b, c in zip(yt, y64):
        assert np.abs(b.double().numpy() - c).max() < 5e-6 * scale


def test_axpy_seed_matches_separate():
    mj, lj, mt, lt = _models(12)
    x, z = _state(mj, lj, 5), _state(mj, lj, 6)
    bx = tsk.flat_to_blocks(torch.as_tensor(x, dtype=torch.float32), lt)
    b0 = tsk.flat_to_blocks(torch.as_tensor(z, dtype=torch.float32), lt)
    s = torch.tensor(-0.37, dtype=torch.float32)
    H = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32)
    got = kg.apply_H_sector_kron_fused(bx, lt, H.tables, H.calls,
                                       axpy=(s, b0))
    want = [h + s * w for h, w in zip(
        kg.apply_H_sector_kron_fused(bx, lt, H.tables, H.calls), b0)]
    scale = max(float(w.abs().max()) for w in want)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    assert err < 2e-6 * scale


def test_kron_hamiltonian_module():
    mj, lj, mt, lt = _models(12)
    x = _state(mj, lj, 7)
    bv = pt.BlockVec(tsk.flat_to_blocks(torch.as_tensor(x, dtype=torch.float32),
                                        lt))
    H = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32)
    assert H.supports_axpy and H.fused and H.top_k == 32
    want = kg.apply_H_sector_kron_fused(bv.leaves, lt, H.tables,
                                        H.calls)
    for a, b in zip(H(bv).leaves, want):
        assert torch.equal(a, b)
    # the axpy form of forward is H bv + s bv0
    s = torch.tensor(0.25)
    for a, b, x in zip(H(bv, s, bv).leaves, want, bv.leaves):
        assert float((a - (b + s * x)).abs().max()) < 2e-6 * float(
            b.abs().max() + 1)
    # .to() moves every table: the same apply in float64
    H64 = H.to(torch.float64)
    assert H64.dtype == torch.float64
    assert all(t.dtype == torch.float64 for t in H64.buffers())
    y64 = H64(bv.astype(torch.float64))
    for a, b in zip(y64.leaves, want):
        assert a.dtype == torch.float64
        assert float((a - b.double()).abs().max()) < 5e-6 * float(
            b.abs().max() + 1)
    # the plain apply from f32-rounded tables: the fused path combines the
    # diagonal vectors into D1/D2 before rounding, so the two differ at the
    # f32 table rounding (~1e-8 here), not at f64 eps
    Hu = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32,
                            fused=False).to(torch.float64)
    assert not Hu.supports_axpy
    for a, b in zip(Hu(bv.astype(torch.float64)).leaves, y64.leaves):
        assert float((a - b).abs().max()) < 1e-6 * float(b.abs().max() + 1)


# ---- the CUDA kernel's index arithmetic, emulated on the host -------------

_BL = 128  # csrc/kron_tile.cuh tile width


def _tile_rows(d):
    """kron_tile.cuh tile_rows: the descriptor's, else 64-row tiles where
    the group is taller than 32 rows and the grid fills two blocks on each
    of 132 SMs, else 32."""
    if d.tile_rows:
        return d.tile_rows
    blocks64 = (d.clp // _BL) * (-(-d.cmp // 64)) * d.ch
    return 64 if d.cmp > 32 and blocks64 >= 2 * 132 else 32


def _round_bf16(x):
    """float64 array -> the float32 accumulator -> one rounding to
    bfloat16 (to nearest even), back as float64."""
    return torch.tensor(x, dtype=torch.float32).to(
        torch.bfloat16).double().numpy()


def _bf16_halves(v32, two):
    """kron_tile.cuh split4: the float32 values' bf16 hi halves and, when
    `two`, their bf16 lo halves bf16(v - hi) (else 0), as float64."""
    v = torch.from_numpy(np.ascontiguousarray(v32, np.float32))
    hi = v.to(torch.bfloat16).float()
    lo = (v - hi).to(torch.bfloat16).float() if two else torch.zeros_like(v)
    return hi.double().numpy(), lo.double().numpy()


def _emulate_k1(d, store=True, with_mag=False):
    """Run kron_group.cu's grid, tiles, segment routes and epilogue in
    numpy, reading every operand through the pointers, integers and flags
    of the ctypes descriptor. States are read in the descriptor's state type
    (bfloat16: 2-byte elements, each the high half of a float32); a
    segment whose flag says its table is exactly bf16 reads the bf16 copy
    and takes the tensor-core route: the state, times the segment's scale in
    float32, is split into bf16 hi and lo halves (a bfloat16 state is its
    own hi) and both halves multiply the table; every other segment, and a
    bfloat16 state's segment under a scale that is not a power of two,
    multiplies the table by the scaled state in float32 (the FMA route). Products
    of bf16 halves and bf16 tables are exact in float64, so the emulation
    differs from the kernel only by the order of the float32 sums. The sum
    is kept unrounded, and with `store` a bfloat16 launch rounds it once, as
    the kernel's single store does (K2 takes it unrounded). `with_mag` also
    returns sum |a||b| over each element's matrix products, the scale of
    the split's error (each product within 2^-16 of exact)."""
    ch, cmp, clp = d.ch, d.cmp, d.clp
    assert d.state_type in (0, 1)
    BM = _tile_rows(d)

    def raw(ptr, n, ctype):
        return np.ctypeslib.as_array((ctype * n).from_address(ptr))

    seen = {}  # each operand is read (and widened) once

    def arr(ptr, n):
        if (ptr, n, 4) not in seen:
            seen[ptr, n, 4] = raw(ptr, n, ctypes.c_float).astype(np.float64)
        return seen[ptr, n, 4]

    def bfarr(ptr, n):
        if (ptr, n, 2) not in seen:
            u = raw(ptr, n, ctypes.c_uint16)
            seen[ptr, n, 2] = (u.astype(np.uint32) << 16).view(
                np.float32).astype(np.float64)
        return seen[ptr, n, 2]

    def sarr(ptr, n):
        return arr(ptr, n) if d.state_type == 0 else bfarr(ptr, n)

    def tab(ptr, n, exact):
        return bfarr(ptr, n) if exact else arr(ptr, n)

    T = sarr(d.T, ch * cmp * clp)
    seed = sarr(d.seed, ch * cmp * clp) if d.seed else None
    out = np.full(ch * cmp * clp, np.nan)
    mag = np.zeros(ch * cmp * clp)
    for h in range(ch):
        for m0 in range(0, cmp, BM):
            for l0 in range(0, clp, _BL):
                acc = np.zeros((BM, _BL))
                amag = np.zeros((BM, _BL))

                def seg(S, lds, shift, mlo, mhi, scale, B, K, exact, sa):
                    """acc += the segment for tile rows m0..m0+BM: sa, the
                    state is A (rows m + shift, valid in [mlo, mhi)) and B
                    the table [K, clp]; else A is the table [cmp, K] and
                    the state B [K, clp]."""
                    rows = np.arange(m0, m0 + BM)
                    ok = (rows >= mlo) & (rows < mhi)
                    if sa:
                        st = np.zeros((BM, K))
                        idx = (rows[ok] + shift)[:, None] * lds + np.arange(K)
                        st[ok] = S[idx]
                        other = B.reshape(K, clp)[:, l0:l0 + _BL]
                    else:
                        st = S.reshape(K, lds)[:, l0:l0 + _BL]
                        other = np.zeros((BM, K))
                        other[ok] = B.reshape(cmp, K)[rows[ok]]
                    v32 = st.astype(np.float32) * np.float32(scale)
                    pow2 = np.frexp(np.float32(scale))[0] in (0.5, -0.5, 0.0)
                    if exact and (d.state_type == 0 or pow2):
                        halves = _bf16_halves(v32, d.state_type == 0)
                    else:  # the FMA route (float or bf16 table)
                        halves = (v32.astype(np.float64),)
                    def mm(x, y):  # float64, on torch's one thread
                        return (torch.from_numpy(np.ascontiguousarray(x))
                                @ torch.from_numpy(np.ascontiguousarray(y))
                                ).numpy()

                    for half in halves:
                        acc[:] += (mm(half, other) if sa
                                   else mm(other, half))
                    a = np.abs(v32.astype(np.float64))
                    amag[:] += (mm(a, np.abs(other)) if sa
                                else mm(np.abs(other), a))

                Th = T[h * cmp * clp:(h + 1) * cmp * clp]
                if d.W_lo:
                    seg(Th, clp, 0, 0, cmp, 1.0,
                        tab(d.W_lo, clp * clp, d.wlo_exact), clp,
                        d.wlo_exact, True)
                if d.W_mid_T:
                    seg(Th, clp, 0, 0, cmp, 1.0,
                        tab(d.W_mid_T, cmp * cmp, d.wmid_exact), cmp,
                        d.wmid_exact, False)
                for x in d.cross[:d.n_cross]:
                    if m0 + BM <= x.c0 or m0 >= x.c0 + x.ln:
                        continue
                    n = x.cmp_s * x.clp_s
                    src = sarr(x.src, ch * n)[h * n:(h + 1) * n]
                    seg(src, x.clp_s, x.r0 - x.c0, x.c0, x.c0 + x.ln, x.val,
                        tab(x.A, x.clp_s * clp, x.exact), x.clp_s, x.exact,
                        True)
                for r in range(BM):
                    m = m0 + r
                    if m >= cmp:
                        break
                    ls = slice(l0, l0 + _BL)
                    idx = h * cmp * clp + m * clp
                    t = T[idx + l0:idx + l0 + _BL]
                    dg = (arr(d.D1, cmp * clp)[m * clp:][ls] if d.D1
                          else np.zeros(_BL))
                    if d.D2:
                        dg = dg + arr(d.D2, ch * cmp)[h * cmp + m]
                    if d.D3:
                        dg = dg + arr(d.D3, ch * clp)[h * clp:][ls]
                    v = (seed[idx + l0:idx + l0 + _BL] if seed is not None
                         else 0.0) + t * dg + acc[r]
                    for x in d.crossh[:d.n_crossh]:
                        if not x.cb0 <= h < x.cb0 + x.lnb:
                            continue
                        srow = min(max(h + x.rb0 - x.cb0, 0), x.ch_s - 1)
                        S = sarr(x.src, x.ch_s * x.cmp_s * clp)
                        for mr in x.mids[:x.n_mids]:
                            if mr.ca0 <= m < mr.ca0 + mr.lna:
                                row = (srow * x.cmp_s + mr.ra0 + m - mr.ca0)
                                v = v + mr.val * S[row * clp:][ls]
                    for x in d.crossw[:d.n_crossw]:  # window_row_add
                        W = sarr(x.win, ch * x.cmp_s * clp)
                        for mr in x.mids[:x.n_mids]:
                            if mr.ca0 <= m < mr.ca0 + mr.lna:
                                row = h * x.cmp_s + mr.ra0 + m - mr.ca0
                                v = v + mr.val * W[row * clp:][ls]
                    out[idx + l0:idx + l0 + _BL] = v
                    mag[idx + l0:idx + l0 + _BL] = amag[r]
    if store and d.state_type == 1:
        out = _round_bf16(out)
    out = out.reshape(ch, cmp, clp)
    return (out, mag.reshape(ch, cmp, clp)) if with_mag else out


def _k1_descriptor(call, T, seed, srcs, srcsh, wins=()):
    """The group's descriptor as kron_group_apply fills it for a launch
    (but for `out`), over CPU tensors."""
    d = call.descriptor(torch.device("cpu"))
    d.state_type = kg._state_type(T)
    d.T = T.data_ptr()
    d.seed = None if seed is None else seed.data_ptr()
    for i, S in enumerate(srcs):
        d.cross[i].src = S.data_ptr()
    for i, S in enumerate(srcsh):
        d.crossh[i].src = S.data_ptr()
    for i, S in enumerate(wins):
        d.crossw[i].win = S.data_ptr()
    return d


@pytest.mark.parametrize("L,splits", [(16, None), (12, (5, 4, 3)),
                                      (14, (6, 4, 4))])
def test_k1_tile_emulation_matches_reference(L, splits):
    """Every fused group of the layout, with and without a seed: the
    descriptor-driven tile emulation equals K1's plain version, to its
    float32 summation order (2e-6 of the scale) and, per element, the hi/lo
    split's 2^-16 sum |a||b| (each state value is carried to 16 significand
    bits; the products themselves are exact)."""
    mj, lj, mt, lt = _models(L, splits=splits)
    x = _state(mj, lj, 8)
    bt = tsk.flat_to_blocks(torch.as_tensor(x, dtype=torch.float32), lt)
    calls = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32).calls
    n_crossh = 0
    for gi in kg.fused_group_set(lt, tsk.default_fused_topk(lt)):
        call = calls[gi]
        n_crossh += len(call.crossh)
        srcs = [bt[c[0]] for c in call.cross]
        srcsh = [bt[c[0]] for c in call.crossh]
        for seed in (None, bt[gi] * 0.5 + 1.0):
            ref = kg.kron_group_apply_reference(bt[gi], seed, srcs, srcsh,
                                                call)
            emu, mag = _emulate_k1(_k1_descriptor(call, bt[gi], seed, srcs,
                                                  srcsh), with_mag=True)
            scale = float(ref.abs().max()) + 1.0
            assert np.all(np.abs(emu - ref.double().numpy())
                          <= 2.0 ** -16 * mag + 2e-6 * scale)
            # dyadic couplings: every table takes the tensor-core route
            assert call.exact == (call.W_lo is not None,
                                  call.W_mid_T is not None,
                                  (True,) * len(call.cross))
    assert n_crossh > 0  # the mid|hi slice adds were exercised


def test_k1_descriptor_layout_and_refusals():
    # 8 pointers, 10 ints, then the three term arrays;
    # a lo|mid term is 2 pointers, 7 ints and its exactness flag (+4)
    assert ctypes.sizeof(kg._KgCrossW) == 8 + 2 * 4 + 16 * 4
    assert ctypes.sizeof(kg._KgCross) == 16 + 8 * 4
    assert kg._KgCross.exact.offset == 40
    assert ctypes.sizeof(kg._KgDesc) == 104 + 48 * 16 + 96 * 8 + 80 * 8
    # the state type sits after the five ints, the window count after it,
    # then the per-segment flags of W_lo and W_mid and the tile height
    assert kg._KgDesc.state_type.offset == 84
    assert kg._KgDesc.n_crossw.offset == 88
    assert kg._KgDesc.wlo_exact.offset == 92
    assert kg._KgDesc.wmid_exact.offset == 96
    assert kg._KgDesc.tile_rows.offset == 100
    assert kg._KgDesc.cross.offset == 104
    assert kg._KgDesc.crossh.offset == 104 + 48 * 16
    assert kg._KgDesc.crossw.offset == 104 + 48 * 16 + 96 * 8
    # passed by value as a __grid_constant__: under the 4 KB limit
    assert ctypes.sizeof(kg._KgDesc) <= 4096
    mj, lj, mt, lt = _models(12, splits=(5, 4, 3))
    calls = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32).calls
    with pytest.raises(ValueError, match="tables on"):
        calls[0].descriptor(torch.device("cpu"))
        calls[0].descriptor(torch.device("meta"))
    # K1 takes CUDA tensors; other devices are refused, never rerouted
    T = torch.zeros(calls[0].shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kg.kron_group_apply(T, None, [], [], calls[0])


# ---- the crossw variant: a shard's local block with windows ----------------


def _shard_launches(L, splits, D, sdt, seed):
    """The windowed K1 launches of one sharded apply over LocalMesh(D), as
    the apply makes them: [(T, seed, srcs, wins, call, gi, shard)], and the
    layout and spec."""
    from spindynamics_tpu_torch.parallel import sharded_kron_scaling as sk

    mj, lj, mt, lt = _models(L, splits=splits)
    mesh = pt.LocalMesh(D, "cpu")
    H = pt.ShardedKronHamiltonian(lt, mesh, device="cpu")
    spec, cfg = H.spec, H.cfg
    x = torch.as_tensor(_state(mj, lj, seed), dtype=torch.float32)
    bv = pt.shard_kron_blockvec(
        pt.BlockVec(tsk.flat_to_blocks(x, lt)), spec, mesh).astype(sdt)
    tables, shards = H._state()
    wins = sk._build_crossh_windows_leaves(bv.leaves, cfg.moves, mesh)
    out = []
    for gi in sorted(cfg.fused_set):
        b = spec.b[gi]
        for i, sh in enumerate(shards):
            call = sh["calls"][gi]
            if not call.crossw:
                continue
            G = [l[i * bg:(i + 1) * bg] for l, bg in zip(bv.leaves, spec.b)]
            sd_ = (G[gi] * 0.5 + 1.0).to(sdt) if (gi + i) % 2 else None
            w = [wins[cfg.win_pos[(gi, ei)]][i * b:(i + 1) * b]
                 for ei in range(len(call.crossw))]
            out.append((G[gi], sd_, [G[c[0]] for c in call.cross], w, call,
                        gi, i))
    return out, lt, spec


@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("L,splits,D", [(16, (6, 4, 6), 4), (14, (6, 4, 4), 2),
                                        (12, None, 8)])
def test_crossw_tile_emulation_matches_reference(L, splits, D, sdt):
    """Every windowed launch of a sharded apply: the descriptor-driven tile
    emulation (windows read through KgCrossW) equals K1's plain version;
    tile pads and the hi padding rows of the last shards are exactly 0.
    float32: 2e-6 of the scale (summation order) and, per element, the
    hi/lo split's 2^-16 sum |a||b|. bfloat16: the emulation rounds its
    float64 sum once, the plain version its float32 sum, so the two agree
    to one bfloat16 unit (2^-7 |y|)."""
    launches, lt, spec = _shard_launches(L, splits, D, sdt, 11)
    assert launches
    for (T, seed, srcs, w, call, gi, i) in launches:
        assert call.crossh == [] and len(call.crossw) == len(w) > 0
        ref = kg.kron_group_apply_reference(T, seed, srcs, [], call, w)
        assert ref.dtype == sdt
        emu, mag = _emulate_k1(_k1_descriptor(call, T, seed, srcs, [], w),
                               with_mag=True)
        r = ref.double().numpy()
        scale = float(np.abs(r).max()) + 1.0
        if sdt == torch.float32:
            assert np.all(np.abs(emu - r) <= 2.0 ** -16 * mag + 2e-6 * scale)
        else:
            assert np.all(np.abs(emu - r) <= 2.0 ** -7 * np.abs(r)
                          + 2.0 ** -16 * mag + 1e-5 * scale)
        # the wrapper on a CPU tensor is the plain version, and writes `out`
        out = torch.full_like(T, 7.0)
        got = kg.kron_group_apply(T, seed, srcs, [], call, w, out=out)
        assert got is out and torch.equal(out, ref)
        if seed is None:  # (a seed is arbitrary there; the apply's is 0)
            (_, _, _, ch, cm, cl, _, _) = lt.groups[gi]
            real = max(0, min(spec.b[gi], ch - i * spec.b[gi]))
            assert not ref[real:].any()
            assert not ref[:, cm:].any() and not ref[:, :, cl:].any()


def test_crossw_refusals_and_counts():
    """A windowed call takes its windows and nothing else; the wrapper
    refuses a wrong count on any device but the CPU's plain path, and the
    crossw launch count is K1's own, per state dtype."""
    launches, lt, spec = _shard_launches(12, None, 2, torch.float32, 3)
    (T, seed, srcs, w, call, gi, i) = launches[0]
    assert call.shape[0] == spec.b[gi]
    assert call.crossw_shapes == [(spec.b[gi], c[0], call.shape[2])
                                  for c in call.crossw]
    d = _k1_descriptor(call, T, seed, srcs, [], w)
    assert d.n_crossw == len(w) and d.n_crossh == 0
    assert d.ch == spec.b[gi]
    n0 = kg.kernel_launch_count(crossw=True)
    kg.kron_group_apply(T, seed, srcs, [], call, w)
    assert kg.kernel_launch_count(crossw=True) == n0  # CPU: plain version
    meta = [t.to("meta") for t in [T] + list(w)]
    with pytest.raises(ValueError, match="CUDA"):
        kg.kron_group_apply(meta[0], None, [], [], call, meta[1:])


@pytest.mark.parametrize("kind", ["xxz", "long_range_xy", "xxz_jxy03"])
def test_exactness_flags_match_jax(kind):
    """Each fused group's per-segment flags (the table is exactly bf16: the
    tensor-core route) equal the JAX kernel's `_bf16_exact` on the same
    tables (pallas_kron.py:530-532): every table of a dyadic XXZ chain is
    exact, no W table of the long-range chain or of Jxy = 0.3 is; the
    descriptor carries the flags and, for an exact table, its bf16 copy."""
    from spindynamics_tpu.ops.pallas_kron import (_bf16_exact,
                                                  fused_group_plans as jplans)

    L, kw = 12, dict(nup=6, kron_splits=(5, 4, 3))
    if kind == "long_range_xy":
        def J(i, j):
            return 1.0 / (j - i) ** 2
        mj = sd.long_range_xy_chain(L, J, layout="sector_kron", **kw)
        mt = pt.long_range_xy_chain(L, J, **kw)
    else:
        Jxy = 1.0 if kind == "xxz" else 0.3
        mj = sd.xxz_chain(L, Jxy=Jxy, Jz=0.5, layout="sector_kron", **kw)
        mt = pt.xxz_chain(L, Jxy=Jxy, Jz=0.5, **kw)
    lj = jsk.make_sector_kron_layout(mj, mj.kron_splits, mj.kron_pads)
    lt = tsk.make_sector_kron_layout(mt, mt.kron_splits)
    flags = []
    for pj, pt_ in zip(jplans(lj), kg.fused_group_plans(lt)):
        want = (pj.W_lo is not None and _bf16_exact(pj.W_lo),
                pj.W_mid_T is not None and _bf16_exact(pj.W_mid_T),
                tuple(_bf16_exact(c[5]) for c in pj.cross))
        assert pt_.exact == want
        flags += [want[0], want[1], *want[2]]
    w_flags = [f for p in kg.fused_group_plans(lt)
               for f, t in zip(p.exact[:2], (p.W_lo, p.W_mid_T))
               if t is not None]
    assert w_flags and all(w_flags) == (kind == "xxz")
    assert any(w_flags) == (kind == "xxz")
    calls = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32).calls
    c = next(c for c in calls if c.W_lo is not None)
    d = c.descriptor(torch.device("cpu"))
    assert d.wlo_exact == int(c.exact[0])
    if c.exact[0]:  # the kernel reads the bf16 copy, equal to the table
        u = np.ctypeslib.as_array((ctypes.c_uint16 * c.W_lo.numel())
                                  .from_address(d.W_lo))
        back = (u.astype(np.uint32) << 16).view(np.float32)
        np.testing.assert_array_equal(back, c.W_lo.numpy().reshape(-1))
    else:
        assert d.W_lo == c.W_lo.data_ptr()
