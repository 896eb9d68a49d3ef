"""The flat-state operator layer of the port against the JAX package on the
CPU: models and masks, blocked plans field by field, the blocked apply and
K3's route (its plain version here) against JAX's blocked apply, the dense
oracle and the Pallas kernel in interpret mode, a descriptor-driven numpy
emulation of the CUDA kernel, spin operators, initial states and
observables. Inputs are made with numpy from a seed and handed to both."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu.ops import blocked as jbl
from spindynamics_tpu.ops.pallas_matvec import apply_H_pallas
from spindynamics_tpu_torch import basis as tb
from spindynamics_tpu_torch.ops import blocked as tbl
from spindynamics_tpu_torch.ops import fused_matvec as fm
from spindynamics_tpu_torch.utils.convert import (
    model_from_numpy, state_from_numpy, state_to_numpy)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread per test process, so parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _couplings(L, kind, rng):
    if kind == "longrange":
        hop = [(i, j, 1.0 / (j - i)) for i in range(L)
               for j in range(i + 1, L)]
        zz = [(i, j, 0.3 / (j - i) ** 2) for i in range(L)
              for j in range(i + 1, L)]
    else:
        hop = [(i, i + 1, 1.0) for i in range(L - 1)]
        zz = [(i, i + 1, 0.4) for i in range(L - 1)]
    return hop, zz, rng.normal(size=L) * 0.1


def _pair(L, nup=None, kind="chain", f64=True, seed=0):
    """The same model in both packages: embedded for nup set, else full."""
    hop, zz, fld = _couplings(L, kind, np.random.default_rng(seed))
    kw = dict(hopping=hop, zz=zz, onsite_field=fld)
    if nup is None:
        mj = sd.build_model(L, dtype=jnp.float64 if f64 else jnp.float32,
                            build_neighbor_table=False, **kw)
    else:
        mj = sd.build_model(L, nup=nup, layout="embedded",
                            dtype=jnp.float64 if f64 else jnp.float32, **kw)
    mt = model_from_numpy(
        mj.L, mj.nup, mj.hop_sites, np.asarray(mj.hop_J),
        np.asarray(mj.field), mj.zz_sites, np.asarray(mj.zz_J),
        layout="full" if nup is None else "embedded")
    return mj, mt


def _state(mj, rng, cplx=False, in_sector=True):
    x = rng.standard_normal(mj.n_states)
    if cplx:
        x = x + 1j * rng.standard_normal(mj.n_states)
    mask = mj.valid_mask()
    if in_sector and mask is not None:
        x = np.where(np.asarray(mask), x, 0)
    return x


# ---- models --------------------------------------------------------------


@pytest.mark.parametrize("L,nup", [(8, 4), (10, 3), (9, None)])
def test_flat_model_matches_jax(L, nup):
    mj, mt = _pair(L, nup, "longrange")
    assert mt.mode == mj.mode and mt.n_states == mj.n_states == 2 ** L
    assert mt.dim == mj.dim and mt.dtype == torch.float64
    assert mt.n_bonds == mj.n_bonds
    assert np.array_equal(mt.basis_states().numpy(),
                          np.asarray(mj.basis_states()))
    if nup is None:
        assert mt.valid_mask() is None and mj.valid_mask() is None
    else:
        assert np.array_equal(mt.valid_mask().numpy(),
                              np.asarray(mj.valid_mask()))
    np.testing.assert_allclose(mt.diag().numpy(), np.asarray(mj.diag),
                               rtol=0, atol=1e-14)
    assert mt.diag() is not mt.diag()  # never stored on the model
    Hb = pt.FlatHamiltonian(mt, backend="blocked", device="cpu")
    assert "diag" in dict(Hb.named_buffers())  # the module that needs it
    assert torch.equal(Hb.diag, mt.diag())
    assert mt.diag(dtype=torch.float32).dtype == torch.float32


def test_layout_rules():
    hop = [(0, 1, 1.0)]
    assert pt.build_model(6, hopping=hop).mode == "full"
    assert pt.build_model(6, hopping=hop, layout="compact").mode == "full"
    assert pt.build_model(6, nup=3, hopping=hop).mode == "sector_kron"
    with pytest.raises(ValueError, match="2\\^30"):
        pt.build_model(30, nup=15, hopping=hop, layout="embedded")
    with pytest.raises(ValueError, match="requires nup"):
        pt.build_model(6, hopping=hop, layout="embedded")
    compact = pt.build_model(6, nup=3, hopping=hop, layout="compact")
    assert compact.mode == "compact" and compact.n_states == 20
    assert compact.neighbor_table and compact.valid_mask() is None
    blocked = pt.build_model(6, nup=3, hopping=hop, layout="sector_blocked")
    assert blocked.mode == "sector_blocked" and blocked.n_states == 20
    assert blocked.lo_bits == 4 and blocked.valid_mask() is None
    assert not blocked.neighbor_table
    with pytest.raises(ValueError, match="requires nup"):
        pt.build_model(6, hopping=hop, layout="sector_blocked")
    with pytest.raises(ValueError, match="unknown layout"):
        pt.build_model(6, nup=3, hopping=hop, layout="ell")
    kron = pt.build_model(6, nup=3, hopping=hop)
    with pytest.raises(ValueError,
                       match="full, embedded, compact or sector_blocked"):
        kron.valid_mask()


def test_basis_helpers_match_jax():
    from spindynamics_tpu import basis as jb

    assert np.array_equal(tb.build_full_basis(9), jb.build_full_basis(9))
    with pytest.raises(ValueError, match="sector basis"):
        tb.build_full_basis(28)
    s = tb.build_full_basis(7)
    for i, j in ((0, 3), (2, 6)):
        assert np.array_equal(tb.bit_at(s, i), np.asarray(jb.bit_at(s, i)))
        assert np.array_equal(tb.flip_bits(s, i, j),
                              np.asarray(jb.flip_bits(s, i, j)))
        st = torch.as_tensor(s.astype(np.int64))
        assert np.array_equal(tb.bit_at(st, i).numpy(), tb.bit_at(s, i))
        assert np.array_equal(tb.flip_bits(st, i, j).numpy(),
                              tb.flip_bits(s, i, j))
    bits = tb.bit_at(s, 2)
    assert np.array_equal(tb.sz_value(bits), np.asarray(jb.sz_value(bits)))
    assert tb.sz_value(torch.as_tensor(bits.astype(np.int64))).dtype == (
        torch.float32)


# ---- blocked plans and the blocked apply ---------------------------------


def _eq(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("L,w,t,kind", [
    (8, 2, 3, "chain"), (10, 3, 3, "chain"), (12, 4, 4, "chain"),
    (12, None, None, "chain"), (8, 3, 3, "longrange"),
    (10, None, None, "longrange"), (9, 4, 0, "longrange")], ids=str)
def test_blocked_plan_matches_jax(L, w, t, kind):
    mj, mt = _pair(L, None, kind)
    pj = jbl.make_blocked_plan(mj, w, t)
    pp = tbl.make_blocked_plan(mt, w, t)
    assert (pp.L, pp.w, pp.t, pp.W, pp.T) == (pj.L, pj.w, pj.t, pj.W, pj.T)
    for name in ("cols_stack", "cols_idx", "rows_stack", "rows_idx"):
        assert _eq(getattr(pp, name), getattr(pj, name)), name
    assert pp.special == pj.special
    assert tbl.make_blocked_plan(mt, w, t) is pp  # cached


@pytest.mark.parametrize("kind", ["chain", "longrange"])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("L,nup,wt", [(10, None, None), (10, 5, (3, 3)),
                                      (9, 4, (2, 4))], ids=str)
def test_blocked_apply_matches_jax_and_dense_f64(L, nup, wt, cplx, kind):
    """float64: the two packages do the same float64 arithmetic up to the
    summation order of a handful of terms per element: 1e-12."""
    mj, mt = _pair(L, nup, kind)
    x = _state(mj, np.random.default_rng(L), cplx)
    pj = None if wt is None else jbl.make_blocked_plan(mj, *wt)
    pp = None if wt is None else tbl.make_blocked_plan(mt, *wt)
    yj = np.asarray(jbl.apply_H_blocked(jnp.asarray(x), mj, pj))
    yt = tbl.apply_H_blocked(state_from_numpy(x, "cpu"), mt, pp)
    assert yt.dtype == (torch.complex128 if cplx else torch.float64)
    yd = pt.build_dense_H(mt) @ x
    scale = np.abs(yd).max()
    assert np.abs(state_to_numpy(yt) - yj).max() <= 1e-12 * scale
    assert np.abs(state_to_numpy(yt) - yd).max() <= 1e-12 * scale
    np.testing.assert_allclose(pt.build_dense_H(mt),
                               np.asarray(sd.build_dense_H(mj)), rtol=0,
                               atol=1e-14)
    if nup is not None:  # the sector is an exact invariant subspace
        assert not yt[~mt.valid_mask()].any()


def test_apply_H_backends_and_rescaled():
    mj, mt = _pair(9, 4, "longrange")
    x = _state(mj, np.random.default_rng(3), True)
    xt = state_from_numpy(x, "cpu")
    want = pt.build_dense_H(mt) @ x
    for backend in (None, "blocked", "dense", "fused", "tensor"):
        y = pt.apply_H(xt, mt, backend=backend)
        assert np.abs(state_to_numpy(y) - want).max() <= 1e-12 * np.abs(
            want).max(), backend
        H = pt.matvec_fn(mt, backend=backend, device="cpu")
        assert H.backend == (backend or "blocked") and not H.supports_axpy
        assert torch.equal(H(xt), y)
    yj = np.asarray(sd.apply_rescaled_H(jnp.asarray(x), mj, 3.0, -0.5,
                                        backend="blocked"))
    yt = pt.apply_rescaled_H(xt, mt, 3.0, -0.5)
    assert np.abs(state_to_numpy(yt) - yj).max() <= 1e-12
    with pytest.raises(ValueError, match="unknown backend"):
        pt.apply_H(xt, mt, backend="pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        pt.matvec_fn(mt, backend="sector_kron", device="cpu")
    # 'ell' is a backend now; an embedded model has no table for it
    with pytest.raises(ValueError, match="no ELL neighbour table"):
        pt.matvec_fn(mt, backend="ell", device="cpu")
    kron = pt.xxz_chain(8, nup=4)
    with pytest.raises(ValueError, match="KronHamiltonian"):
        pt.apply_H(xt, kron)
    with pytest.raises(ValueError, match="full, embedded, compact or sector_blocked"):
        pt.matvec_fn(kron, device="cpu")


# ---- K3's route against the Pallas kernel in interpret mode --------------


@pytest.mark.parametrize("L,w,t", [(8, 2, 3), (10, 3, 3), (12, 4, 4)])
def test_k3_route_matches_pallas_interpret_and_dense(L, w, t):
    """float32 state through K3's wrapper (its plain version on the CPU)
    against the JAX kernel in interpret mode and the float64 oracle. Both
    are float32-grade (the Pallas kernel's split dots ~2^-17 per half, a
    few products deep): 5e-6 relative to max |y| for the port, the JAX
    test's own 3e-5 for the Pallas kernel."""
    mj, mt = _pair(L, None, "chain")
    x = _state(mj, np.random.default_rng(L)).astype(np.float32)
    want = pt.build_dense_H(mt) @ x.astype(np.float64)
    scale = np.abs(want).max()
    n0 = fm.kernel_launch_count()
    yt = fm.fused_matvec_apply(state_from_numpy(x, "cpu"), mt)
    assert fm.kernel_launch_count() == n0  # CPU tensor: the plain version
    assert yt.dtype == torch.float32
    yj = np.asarray(apply_H_pallas(jnp.asarray(x), mj,
                                   jbl.make_blocked_plan(mj, w, t),
                                   interpret=True))
    assert np.abs(state_to_numpy(yt) - want).max() <= 5e-6 * scale
    assert np.abs(yj - want).max() <= 3e-5 * scale
    assert np.abs(state_to_numpy(yt) - yj).max() <= 3e-5 * scale


@pytest.mark.parametrize("case", ["complex", "longrange", "hold"])
def test_k3_route_matches_pallas_interpret_cases(case):
    """The other cases of the JAX kernel's own tests: a complex64 state,
    long-range bonds, and the L=16 embedded chain on small (4, 4) tiles
    whose adjacent block-bit bonds are the hold-elided ones."""
    rng = np.random.default_rng(5)
    if case == "hold":
        mj, mt = _pair(16, 8, "chain", f64=False)
        plan = jbl.make_blocked_plan(mj, w=4, t=4)
        x = _state(mj, rng).astype(np.float32)
    elif case == "longrange":
        mj, mt = _pair(8, None, "longrange")
        plan = jbl.make_blocked_plan(mj, 3, 3)
        x = _state(mj, rng).astype(np.float32)
    else:
        mj, mt = _pair(9, None, "chain")
        plan = jbl.make_blocked_plan(mj, 3, 3)
        x = _state(mj, rng, cplx=True).astype(np.complex64)
    yj = np.asarray(apply_H_pallas(jnp.asarray(x), mj, plan, interpret=True))
    yt = state_to_numpy(
        fm.fused_matvec_apply(state_from_numpy(x, "cpu"), mt))
    want = state_to_numpy(tbl.apply_H_blocked(
        state_from_numpy(x.astype(np.complex128 if case == "complex"
                                  else np.float64), "cpu"),
        model_from_numpy(mt.L, mt.nup, mt.hop_sites, mt.hop_J,
                         mt.field.astype(np.float64), mt.zz_sites, mt.zz_J,
                         layout=mt.mode)))
    scale = np.abs(want).max()
    assert np.abs(yt - want).max() <= 5e-6 * scale
    assert np.abs(yt - yj).max() <= 3e-5 * scale
    if case == "hold":
        assert not yt[~np.asarray(mj.valid_mask())].any()


# ---- the CUDA kernel's index arithmetic, emulated on the host ------------


def _emulate_k3(d):
    """Run fused_matvec.cu's schedule in numpy, reading every operand
    through the pointers and integers of the ctypes descriptor: tiles of
    2^k amplitudes, output chunks of 2^chunk_bits, 16-byte vectors (4
    float32 or 2 complex64 lanes) with the lane swizzle for partners inside
    a vector (a bond whose bits are both above it has one mask per
    vector), the factored diagonal, and per chunk the compacted partner
    list: a straddle bond stages chunk c (local bit i below the chunk bits)
    or c ^ 2^(i - chunk_bits) for the active half of the chunks; a
    tile-space bond stages chunk c where the tile's mask is 1. Returns the
    output and the designed passes: 2 + the staged partner chunks over the
    state."""
    def arr(ptr, n, ct=ctypes.c_float):
        if not ptr or n == 0:
            return np.zeros(0)
        return np.ctypeslib.as_array((ct * n).from_address(ptr))

    k, L, cb = d.k, d.L, d.chunk_bits
    VB = 1 if d.is_complex else 2
    VW, comps = 1 << VB, 2 if d.is_complex else 1
    # the state as 16-byte vectors [n_vec, lane, component]
    X = arr(d.x, (1 << L) * comps).astype(np.float64).reshape(-1, VW, comps)
    Y = np.full_like(X, np.nan)
    nb = d.n_local + d.n_strad + d.n_tile
    hij = arr(d.hop_ij, 2 * nb, ctypes.c_int).reshape(-1, 2)
    hJ = arr(d.hop_J, nb).astype(np.float64)
    nz = d.n_zs + d.n_zb
    zij = arr(d.zz_ij, 2 * nz, ctypes.c_int).reshape(-1, 2)
    zJ = arr(d.zz_J, nz).astype(np.float64)
    fh = arr(d.fh, max(L - k, 1)).astype(np.float64)
    dtab = arr(d.dtab, 1 << k).astype(np.float64)
    lanes = np.arange(VW)
    nvec = 1 << (cb - VB)
    v = np.arange(nvec)
    staged = 0

    def bit_lanes(e0, i):  # [nvec, VW]: the lanes whose amplitude has bit i
        return (((e0[:, None] + lanes) >> i) & 1).astype(bool)

    def swz(p, s):  # lane l takes lane l ^ s
        return p[:, lanes ^ s]

    for t in range(1 << (L - k)):  # the persistent grid's tiles, any order
        own = X[(t << k) >> VB:((t + 1) << k) >> VB]

        def szb(b):
            return ((t >> b) & 1) - 0.5

        heff = np.zeros(16)
        for z in range(d.n_zs):
            heff[zij[z, 0]] += zJ[z] * szb(zij[z, 1])
        dscal = sum(zJ[z] * szb(zij[z, 0]) * szb(zij[z, 1])
                    for z in range(d.n_zs, nz))
        dscal += sum(fh[b] * szb(b) for b in range(L - k))
        for c in range(1 << (k - cb)):
            e0 = (c << cb) + (v << VB)  # in-tile index of each vector's lane 0
            e = e0[:, None] + lanes
            dg = dtab[e] + dscal
            for q in range(d.n_hbits):
                bit = d.hbits[q]
                dg = dg + heff[bit] * (((e >> bit) & 1) - 0.5)
            acc = dg[..., None] * own[e0 >> VB]
            for q in range(d.n_local):
                i, j = hij[q]
                m = (1 << i) | (1 << j)
                if i >= VB:  # both bits above the vector: one mask each
                    on = (((e0 >> i) ^ (e0 >> j)) & 1).astype(bool)
                    acc[on] += hJ[q] * own[(e0[on] ^ m) >> VB]
                    continue
                on = bit_lanes(e0, i) ^ bit_lanes(e0, j)
                p = swz(own[(e0 ^ m) >> VB], m & (VW - 1))
                acc[on] += hJ[q] * p[on]

            def stage(elem):  # one ring stage: a partner chunk
                nonlocal staged
                staged += 1
                return X[elem >> VB:(elem >> VB) + nvec]

            for q in range(d.n_local, d.n_local + d.n_strad):
                i, jt = hij[q]
                want = ((t >> jt) & 1) ^ 1
                base = (t ^ (1 << jt)) << k
                if i >= cb:  # partner chunk c ^ 2^(i - cb), every lane
                    if ((c >> (i - cb)) & 1) != want:
                        continue
                    acc += hJ[q] * stage(base + ((c ^ (1 << (i - cb))) << cb))
                elif i >= VB:  # one mask per vector
                    st = stage(base + (c << cb))
                    on = ((e0 >> i) & 1) == want
                    acc[on] += hJ[q] * st[v[on] ^ (1 << (i - VB))]
                else:
                    st = stage(base + (c << cb))
                    on = bit_lanes(e0, i) == bool(want)
                    p = swz(st[v ^ ((1 << i) >> VB)], (1 << i) & (VW - 1))
                    acc[on] += hJ[q] * p[on]
            for q in range(d.n_local + d.n_strad, nb):
                it, jt = hij[q]
                if ((t >> it) ^ (t >> jt)) & 1:  # else nothing is staged
                    base = (t ^ (1 << it) ^ (1 << jt)) << k
                    acc += hJ[q] * stage(base + (c << cb))
            Y[((t << k) + (c << cb)) >> VB:][:nvec] = acc
    y = Y.reshape(-1, comps)
    out = y[:, 0] if comps == 1 else y[:, 0] + 1j * y[:, 1]
    return out, 2 + staged * (1 << cb) / (1 << L)


def _oracle(mt, x):
    """H x in float64 from the model's couplings, element by element (the
    rule of build_dense_H without the N x N matrix, above L=12)."""
    if mt.L <= 12:
        return pt.build_dense_H(mt) @ x
    s = np.arange(mt.n_states)
    y = mt.diag("cpu", torch.float64).numpy() * x
    for (i, j), J in zip(mt.hop_sites, np.asarray(mt.hop_J, np.float64)):
        on = ((s >> i) ^ (s >> j)) & 1
        y = y + J * on * x[s ^ ((1 << i) | (1 << j))]
    return y


@pytest.mark.parametrize("L,nup,k,kind,cplx", [
    (8, None, 3, "chain", False), (9, None, 4, "longrange", True),
    (10, 5, 5, "longrange", False), (12, 6, None, "chain", True),
    (12, 6, 7, "chain", False), (8, None, 8, "chain", False),
    (8, 4, 2, "longrange", False), (13, 6, None, "chain", False),
    (14, 7, 13, "chain", False), (13, None, 12, "longrange", True),
    (16, 8, 15, "chain", False), (16, 8, 15, "longrange", False),
    (16, 8, 14, "chain", True), (16, 8, 14, "longrange", True),
    (16, None, 14, "chain", False), (16, 8, 14, "longrange", False)],
    ids=str)
def test_k3_emulation_matches_dense_oracle(L, nup, k, kind, cplx):
    """The emulation is driven by the descriptor K3 receives (tables of a
    float32 plan on the CPU); it must equal the float64 oracle to the
    float32 rounding of the tables and the state (2e-6 of max |y|), leave
    exact zeros outside the sector, and stage exactly the partner chunks
    that `fused_pass_count` designs. (14, 13) and (13, 12 complex) put a
    straddle bond's local bit above the chunk bits at a tile of two chunks;
    the L=16 cases are the largest tiles, 2^15 float32 and 2^14 complex64
    (128 KB, eight chunks)."""
    mj, mt = _pair(L, nup, kind)
    x = _state(mj, np.random.default_rng(L + 1), cplx)
    x32 = state_from_numpy(
        x.astype(np.complex64 if cplx else np.float32), "cpu")
    plan = fm.make_fused_plan(mt, k, is_complex=cplx)
    assert plan.n_local + plan.n_strad + plan.n_tile == mt.n_bonds
    assert plan.tile_bits == (min(12 if cplx else 13, L - 1) if k is None
                              else k)
    assert plan.chunk_bits == min(plan.tile_bits, 11 if cplx else 12)
    d = fm.FusedCall(plan, device="cpu").descriptor()
    assert (d.k, d.chunk_bits, d.is_complex) == (plan.tile_bits,
                                                 plan.chunk_bits, int(cplx))
    out = torch.empty_like(x32)
    d.x, d.y = x32.data_ptr(), out.data_ptr()
    emu, passes = _emulate_k3(d)
    want = _oracle(mt, state_to_numpy(x32).astype(
        np.complex128 if cplx else np.float64))
    assert np.abs(emu - want).max() <= 2e-6 * np.abs(want).max()
    assert passes == fm.fused_pass_count(plan)
    if nup is not None:
        assert not emu[~mt.valid_mask().numpy()].any()
    ref = state_to_numpy(fm.fused_matvec_apply_reference(x32, mt))
    assert np.abs(emu - ref).max() <= 2e-6 * np.abs(want).max()


def test_fused_plan_and_wrapper_contract():
    # 8 pointers, then L, k, chunk_bits, is_complex, 6 counts, hbits[16]
    assert ctypes.sizeof(fm._K3Desc) == 8 * 8 + 4 * 26
    _, mt = _pair(16, 8, "chain")
    plan = fm.make_fused_plan(mt)  # float32: a 2^13 tile of 2^12 chunks
    assert (plan.tile_bits, plan.chunk_bits, plan.n_local, plan.n_strad,
            plan.n_tile, plan.is_complex) == (13, 12, 12, 1, 2, False)
    assert (plan.n_zs, plan.n_zb, plan.hbits) == (1, 2, (12,))
    assert fm.fused_pass_count(plan) == 2 + 0.5 * 2 + 0.5  # bit 12 >= 12
    cp = fm.make_fused_plan(mt, is_complex=True)  # 32 KB: 2^12 complex64
    assert (cp.tile_bits, cp.chunk_bits, cp.n_local, cp.n_strad,
            cp.n_tile, cp.is_complex) == (12, 11, 11, 1, 3, True)
    assert fm.fused_pass_count(cp) == 2 + 0.5 * 3 + 0.5  # bit 11 >= 11
    # the L=26 chain: 7.5 designed passes at 2^15 (the TPU kernel's tile);
    # at 2^12 the tile is one chunk and the straddle bond reads all of it
    chain = pt.xxz_chain(26, nup=13, layout="embedded")
    assert [fm.fused_pass_count(fm.make_fused_plan(chain, k))
            for k in (12, 13, 14, 15)] == [9.5, 8.5, 8.0, 7.5]
    assert fm.fused_supported(mt)
    assert not fm.fused_supported(pt.xxz_chain(16, nup=8))  # sector_kron
    small = pt.xxz_chain(5, nup=2, layout="embedded")
    assert not fm.fused_supported(small)  # below the floor: blocked by rule
    assert pt.matvec_fn(small, device="cpu").backend == "blocked"
    assert fm.tile_bits_range() == (2, 15)
    assert fm.tile_bits_range(True) == (1, 14)
    for k, cplx in ((16, False), (15, True), (1, False), (0, True)):
        with pytest.raises(ValueError, match="tile_bits"):
            fm.make_fused_plan(mt, k, is_complex=cplx)
    # all-pairs at L=26 fits the kernel's per-class lists at both tiles
    big = pt.build_model(26, nup=13, layout="embedded",
                         hopping=pt.long_range_hopping(26, lambda i, j: 1.0))
    for k, most in ((13, 169), (15, 165)):
        bp = fm.make_fused_plan(big, k)
        assert max(bp.n_local, bp.n_strad, bp.n_tile) == most
    bc = fm.make_fused_plan(big, is_complex=True)
    assert max(bc.n_local, bc.n_strad, bc.n_tile) == 168
    assert fm.fused_supported(big)
    # K3 takes CUDA tensors; other devices are refused, never rerouted
    with pytest.raises(ValueError, match="CUDA"):
        fm.fused_matvec_apply(torch.zeros(1 << 16, device="meta"), mt)
    x = torch.randn(1 << 16, dtype=torch.float64)
    x0 = x.clone()
    fm.fused_matvec_apply(x, mt)
    assert torch.equal(x, x0)  # the input is not modified
    fm.reset_kernel_launch_count()
    assert pt.fused_matvec_launch_count() == fm.kernel_launch_count() == 0


def test_fused_capacity_raises_and_names_blocked():
    """A model above K3's list capacity (a user list with duplicate bonds:
    300 straddle bonds against 256) is not rerouted to the plain version:
    the plan, the module and the wrapper raise and name backend="blocked",
    which then runs it. Only the floor (L < 6) routes by rule."""
    hop = pt.nn_hopping(16, 1.0) + [(11, 12, 0.01)] * 300
    m = pt.build_model(16, nup=8, hopping=hop, layout="embedded")
    assert fm.fused_supported(m)  # the floor says nothing of capacity
    for f in (lambda: fm.make_fused_plan(m),
              lambda: pt.FlatHamiltonian(m, backend="fused", device="cpu")):
        with pytest.raises(ValueError, match='backend="blocked"'):
            f()
    x = pt.domain_wall_state(m, device="cpu")
    H = pt.FlatHamiltonian(m, backend="blocked", device="cpu")
    assert torch.equal(H(x), pt.apply_H(x, m))
    zz = [(0, 15, 0.001)] * 1025
    with pytest.raises(ValueError, match='backend="blocked"'):
        fm.make_fused_plan(pt.build_model(16, nup=8, zz=zz,
                                          layout="embedded"))


def test_fused_module_tables_are_buffers():
    _, mt = _pair(10, 5, "longrange")
    H = pt.FlatHamiltonian(mt, backend="fused", device="cpu")
    names = {n for n, _ in H.named_buffers()}
    tables = {"dtab", "hop_ij", "hop_J", "zz_ij", "zz_J", "fh"}
    assert {"k3_" + n for n in tables} | {"k3c_" + n for n in tables} <= names
    assert H.k3_hop_ij.dtype == torch.int32 and H.device.type == "cpu"
    # one plan per element type: 2^(L-1) amplitudes at L=10 for both
    assert [H.plans[c].is_complex for c in (False, True)] == [False, True]
    assert H.k3_dtab.shape == H.k3c_dtab.shape == (512,)
    x = state_from_numpy(_state(sd.build_model(
        10, nup=5, layout="embedded"), np.random.default_rng(0)), "cpu")
    assert torch.equal(H(x), tbl.apply_H_blocked(x, mt))
    Hd = pt.FlatHamiltonian(mt, backend="dense", device="cpu")
    assert Hd.H.shape == (1024, 1024)
    assert (Hd(x) - H(x)).abs().max() <= 1e-12 * H(x).abs().max()


# ---- spin operators, initial states, observables -------------------------


@pytest.mark.parametrize("nup", [None, 4])
def test_spin_operators_match_jax(nup):
    mj, mt = _pair(8, nup)
    rng = np.random.default_rng(2)
    for cplx in (False, True):
        x = _state(mj, rng, cplx)
        xt = state_from_numpy(x, "cpu")
        for kind in ("z", "plus", "minus", "x", "y"):
            for site in (0, 3, 7):
                if nup is not None and kind != "z":
                    continue  # the JAX embedded path is the full-space one
                a = np.asarray(sd.apply_spin_operator(jnp.asarray(x), mj,
                                                      site, kind))
                b = pt.apply_spin_operator(xt, mt, site, kind)
                assert np.abs(state_to_numpy(b) - a).max() <= 1e-14
                assert b.is_complex() == np.iscomplexobj(a)
    op = pt.make_spin_operator(2, "plus")
    assert torch.equal(op(xt, mt), pt.apply_spin_operator(xt, mt, 2, "plus"))
    with pytest.raises(ValueError, match="out of range"):
        pt.apply_spin_operator(xt, mt, 8, "z")
    with pytest.raises(ValueError, match="unknown operator"):
        pt.apply_spin_operator(xt, mt, 0, "w")
    for q in (0.0, 2 * np.pi / 8, np.pi):
        wj = np.asarray(sd.sz_q_weights(mj, q, dtype=jnp.complex128))
        wt = pt.sz_q_weights(mt, q, dtype=torch.complex128)
        assert np.abs(state_to_numpy(wt) - wj).max() <= 1e-14
        pj = np.asarray(sd.sz_q_vector(mj, jnp.asarray(x), q,
                                       dtype=jnp.complex128))
        pp = pt.sz_q_vector(mt, xt, q, dtype=torch.complex128)
        assert np.abs(state_to_numpy(pp) - pj).max() <= 1e-14


@pytest.mark.parametrize("nup", [None, 4])
def test_initial_states_match_jax(nup):
    from spindynamics_tpu.models import initial_states as jis

    mj, mt = _pair(8, nup)
    for name, args in (("domain_wall_state", ()), ("neel_state", ()),
                       ("polarized_state_with_flips", ([0, 2, 5, 7],))):
        a = np.asarray(getattr(jis, name)(mj, *args))
        b = getattr(pt, name)(mt, *args, device="cpu")
        assert b.dtype == torch.float64 and np.array_equal(
            state_to_numpy(b), a)
    assert pt.state_index(mt, 0b00001111) == jis.state_index(mj, 0b00001111)
    assert pt.basis_state_vector(mt, 0b11110000, dtype=torch.complex64,
                                 device="cpu")[0b11110000] == 1
    if nup is None:
        assert np.array_equal(
            state_to_numpy(pt.polarized_state(mt, device="cpu")),
            np.asarray(jis.polarized_state(mj)))
    else:
        for f in (lambda m: pt.polarized_state(m, device="cpu"),
                  lambda m: pt.state_index(m, 0b111)):
            with pytest.raises(ValueError, match="wrong magnetization"):
                f(mt)
    with pytest.raises(ValueError, match="out of range"):
        pt.polarized_state_with_flips(mt, [8], device="cpu")
    with pytest.raises(ValueError, match="bv_basis_state"):
        pt.state_index(pt.xxz_chain(8, nup=4), 0b1111)


@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("nup", [None, 5])
def test_observables_match_jax(nup, cplx):
    from spindynamics_tpu import observables as jo

    mj, mt = _pair(10, nup)
    x = _state(mj, np.random.default_rng(4), cplx)
    x = x / np.linalg.norm(x)
    xj, xt = jnp.asarray(x), state_from_numpy(x, "cpu")
    np.testing.assert_allclose(
        pt.magnetization_per_site(xt, mt, chunk=300).numpy(),
        np.asarray(jo.magnetization_per_site(xj, mj)), rtol=0, atol=1e-13)
    szsz_j, si_j = jo.szsz_matrix(xj, mj)
    szsz_t, si_t = pt.szsz_matrix(xt, mt, chunk=300)
    np.testing.assert_allclose(szsz_t.numpy(), np.asarray(szsz_j), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(si_t.numpy(), np.asarray(si_j), rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(
        pt.connected_correlations(xt, mt).numpy(),
        np.asarray(jo.connected_correlations(xj, mj)), rtol=0, atol=1e-13)
    qj, sj = jo.structure_factor_Sq(xj, mj)
    qt, st = pt.structure_factor_Sq(xt, mt)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0, atol=1e-13)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-13)
    dj = jo.structure_factor_Sq_dict(xj, mj)
    dt = pt.structure_factor_Sq_dict(xt, mt)
    assert len(dt) == len(dj) == 10
    for (ka, va), (kb, vb) in zip(sorted(dt.items()), sorted(dj.items())):
        assert abs(ka - kb) <= 1e-12 and abs(va - vb) <= 1e-12
    with pytest.raises(ValueError, match="observables_kron"):
        pt.magnetization_per_site(xt, pt.xxz_chain(10, nup=5))
