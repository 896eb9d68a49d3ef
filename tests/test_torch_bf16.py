"""bfloat16 states on the kron layout: the plain versions of the bf16
instances of K1 and K2 (the CPU path of the wrappers), the fused apply and
the Chebyshev scan on bf16 leaves against the JAX package (Pallas interpret
mode) and the float64 apply, the bf16 trajectory, a bf16 KPM recurrence, the
emulation of both kernels' bf16 loads and single store read through the
ctypes descriptors, and the numpy <-> bf16 conversion. The kernels
themselves are tested on the card in tests/test_torch_cuda_bf16.py.

Accuracy class of a bf16 state: one rounding (8 significand bits: at most
2^-8 relative, half a unit in the last place) of the state per stored
vector, never of a sum: every tolerance below is either that
class (3e-2 of the scale after an apply, 2e-2 on observables) or, where the
point is indexing and ordering, the tight bound of ONE rounding of the
float32 value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu.models import initial_states as jis
from spindynamics_tpu.ops import sector_kron as jsk
from spindynamics_tpu.ops.pallas_kron import (
    apply_H_sector_kron_fused as j_fused)
from spindynamics_tpu.solvers import chebyshev as jch
from spindynamics_tpu.solvers import kron_evolve as jke
from spindynamics_tpu.solvers.blockvec import BlockVec as JBV
from spindynamics_tpu_torch.models import initial_states as tis
from spindynamics_tpu_torch.ops import cheb_term as ct
from spindynamics_tpu_torch.ops import kron_group as kg
from spindynamics_tpu_torch.ops import sector_kron as tsk
from spindynamics_tpu_torch.solvers import blockvec as tbv
from spindynamics_tpu_torch.solvers import chebyshev as tch
from spindynamics_tpu_torch.solvers import kron_evolve as tke
from spindynamics_tpu_torch.utils import convert

import test_torch_cheb_term as tct
import test_torch_kron_group as tkg

BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per test process, so
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _one_rounding(out, y32):
    """`out` (bfloat16) is `y32` (the float32 value before rounding) rounded
    once: |out - y32| <= 2^-8 |y32| + 1e-6 max|y32| element by element
    (half a unit in the last place of 8 significand bits). An indexing or
    ordering error moves an element by far more."""
    assert out.dtype == BF16 and y32.dtype == torch.float32
    d = (out.float() - y32).abs()
    lim = 2.0 ** -8 * y32.abs() + 1e-6 * y32.abs().max()
    return bool((d <= lim).all())


def _bf16_blocks(x, lay):
    """(float32 blocks, the same rounded to bfloat16) of a flat numpy state."""
    b32 = tsk.flat_to_blocks(torch.as_tensor(x, dtype=torch.float32), lay)
    return b32, [b.to(BF16) for b in b32]


# ---- K1 --------------------------------------------------------------------


@pytest.mark.parametrize("L,splits,longrange", [
    (12, (5, 4, 3), False), (14, None, False), (10, (4, 3, 3), True)],
    ids=["L12", "L14", "L10-longrange"])
def test_k1_bf16_plain_version_rounds_once(L, splits, longrange):
    """K1's plain version on bf16 inputs returns bf16, equal to ONE rounding
    of the float32 sum over the lifted inputs (with and without a seed)."""
    mj, lj, mt, lt = tkg._models(L, splits=splits, longrange=longrange)
    _, bb = _bf16_blocks(tkg._state(mj, lj, 3), lt)
    calls = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32).calls
    for gi in kg.fused_group_set(lt, tsk.default_fused_topk(lt)):
        call = calls[gi]
        srcs = [bb[c[0]] for c in call.cross]
        srcsh = [bb[c[0]] for c in call.crossh]
        for seed in (None, (bb[gi].float() * 0.5 + 1.0).to(BF16)):
            n0 = kg.kernel_launch_count()
            out = kg.kron_group_apply(bb[gi], seed, srcs, srcsh, call)
            assert kg.kernel_launch_count() == n0  # CPU: the plain version
            y32 = kg.kron_group_apply_reference(
                bb[gi].float(), None if seed is None else seed.float(),
                [s.float() for s in srcs], [s.float() for s in srcsh], call)
            assert torch.equal(out, y32.to(BF16))
            assert _one_rounding(out, y32)


@pytest.mark.parametrize("case", ["chain", "axpy", "tail", "longrange"])
def test_fused_apply_bf16_matches_jax_and_x64(case):
    """apply_H_sector_kron_fused on bf16 leaves: bf16 out, within the bf16
    class (3e-2 of the scale, tests/test_sector_kron.py:271-300) of the JAX
    fused apply in interpret mode and of the float64 apply. "tail" leaves
    most groups to the plain apply (top_k=2); "longrange" has lo|mid entries
    K1 does not take (_unsupported_terms); "axpy" folds s * psi0 into the
    seeds."""
    if case == "longrange":
        mj, lj, mt, lt = tkg._models(8, splits=(3, 3, 2), longrange=True)
        assert any(p.unsupported for p in kg.fused_group_plans(lt))
    else:
        mj, lj, mt, lt = tkg._models(12)
    top_k = 2 if case == "tail" else None
    x, z = tkg._state(mj, lj, 0), tkg._state(mj, lj, 1)
    s = -0.37
    y64 = np.asarray(jsk.apply_H_sector_kron(jnp.asarray(x), None, lj))
    if case == "axpy":
        y64 = y64 + s * z
    y64 = [np.asarray(b) for b in jsk.flat_to_blocks(jnp.asarray(y64), lj)]

    def jb(v):
        return [b.astype(jnp.bfloat16) for b in jsk.flat_to_blocks(
            jnp.asarray(v, jnp.float32), lj)]

    yj = j_fused(jb(x), lj, top_k=top_k,
                 axpy=(jnp.float32(s), jb(z)) if case == "axpy" else None)
    _, bx = _bf16_blocks(x, lt)
    _, bz = _bf16_blocks(z, lt)
    H = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32, top_k=top_k)
    if case == "axpy":
        yt = H(pt.BlockVec(bx), torch.tensor(s), pt.BlockVec(bz)).leaves
    else:
        yt = H(pt.BlockVec(bx)).leaves
    scale = max(float(np.abs(b).max()) for b in y64)
    err_j = err_64 = 0.0
    for a, b, c, pad in zip(yj, yt, y64, tkg._pads(lt)):
        assert b.dtype == BF16
        got = b.double().numpy()
        err_j = max(err_j, np.abs(got - np.asarray(
            a.astype(jnp.float32), np.float64)).max())
        err_64 = max(err_64, np.abs(got - c).max())
        assert np.all(got[pad] == 0.0)
    assert err_j < 3e-2 * scale and err_64 < 3e-2 * scale
    assert err_64 > 1e-7 * scale  # it IS the bf16 class
    # the plain (unfused) module on the same bf16 leaves: bf16 out, same class
    Hp = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32,
                            fused=False)
    for b, c in zip(Hp(pt.BlockVec(bx)).leaves if case != "axpy" else
                    Hp(pt.BlockVec(bx), torch.tensor(s),
                       pt.BlockVec(bz)).leaves, y64):
        assert b.dtype == BF16
        assert np.abs(b.double().numpy() - c).max() < 3e-2 * scale


def test_fused_apply_bf16_rounds_each_output_once():
    """Against the float32 fused apply of the SAME bf16-valued state, every
    output element is one rounding away (seeded groups: the seed's own
    rounding adds a second 2^-8 of the seed), so an indexing error in the
    bf16 plumbing cannot hide in the loose class tolerance."""
    mj, lj, mt, lt = tkg._models(12, splits=(5, 4, 3))
    _, bx = _bf16_blocks(tkg._state(mj, lj, 5), lt)
    H = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32)
    y32 = H(pt.BlockVec([b.float() for b in bx])).leaves
    ybf = H(pt.BlockVec(bx)).leaves
    scale = max(float(y.abs().max()) for y in y32)
    for a, b in zip(ybf, y32):
        assert float((a.float() - b).abs().max()) <= 2.0 ** -7 * scale


def test_k1_bf16_tile_emulation_matches_reference():
    """The descriptor-driven tile emulation with the bf16 state type: 2-byte
    loads through the descriptor's pointers, float32 tables, one rounding
    at the store. Equal to the plain version but where the two float32 sums
    straddle a rounding boundary: one bf16 ulp at most, and tight against
    the unrounded value."""
    mj, lj, mt, lt = tkg._models(12, splits=(5, 4, 3))
    _, bb = _bf16_blocks(tkg._state(mj, lj, 8), lt)
    calls = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32).calls
    n_crossh = 0
    for gi in kg.fused_group_set(lt, tsk.default_fused_topk(lt)):
        call = calls[gi]
        n_crossh += len(call.crossh)
        srcs = [bb[c[0]] for c in call.cross]
        srcsh = [bb[c[0]] for c in call.crossh]
        for seed in (None, (bb[gi].float() * 0.5 + 1.0).to(BF16)):
            d = tkg._k1_descriptor(call, bb[gi], seed, srcs, srcsh)
            assert d.state_type == 1
            emu = torch.tensor(tkg._emulate_k1(d), dtype=torch.float32)
            assert torch.equal(emu, emu.to(BF16).float())  # stored as bf16
            y32 = kg.kron_group_apply_reference(
                bb[gi].float(), None if seed is None else seed.float(),
                [s.float() for s in srcs], [s.float() for s in srcsh], call)
            assert _one_rounding(emu.to(BF16), y32)
    assert n_crossh > 0


# ---- K2 --------------------------------------------------------------------

SCAL = tuple(float(np.float32(x)) for x in (0.083, -0.41, 0.37, -0.62))


@pytest.mark.parametrize("L,splits,long_range", [
    (12, (5, 4, 3), False), (14, (6, 4, 4), False), (10, (4, 3, 3), True)],
    ids=["L12", "L14", "L10-longrange"])
def test_k2_bf16_plain_version_and_emulation(L, splits, long_range):
    """K2's plain version on bf16 states: next comes back bf16, one
    rounding of the float32 x; the float32 accumulator is updated from the
    UNROUNDED x, so it equals the accumulator of a run on the lifted inputs
    to 1e-5; with out=prev the result is the same bit for bit. The
    descriptor-driven emulation (bf16 loads, float32 acc) agrees."""
    _, lt = tct._models(L, long_range=long_range, splits=splits, Jz=0.7)
    n_seeded = 0
    for g in tct._group_args(lt, sdt=BF16):
        call = g["call"]
        assert g["T"][0].dtype == BF16 and g["acc"][0].dtype == torch.float32
        assert g["seed"] is None or g["seed"][0].dtype == BF16
        n_seeded += g["seed"] is not None
        lifted = {k: (None if g[k] is None else tuple(x.float() for x in g[k]))
                  for k in ("T", "prev", "seed")}
        lsrc = {k: [tuple(x.float() for x in p) for p in g[k]]
                for k in ("srcs", "srcsh")}
        acc32 = tuple(a.clone() for a in g["acc"])
        x32 = ct.cheb_term_apply_reference(
            lifted["T"], lifted["prev"], acc32, lifted["seed"], lsrc["srcs"],
            lsrc["srcsh"], call, SCAL)
        acc = tuple(a.clone() for a in g["acc"])
        nxt = ct.cheb_term_apply(g["T"], g["prev"], acc, g["seed"],
                                 g["srcs"], g["srcsh"], call, SCAL)
        for n, x in zip(nxt, x32):
            assert _one_rounding(n, x)
        for a, w in zip(acc, acc32):
            assert a.dtype == torch.float32
            assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max())
        # next written over prev's storage
        own = tuple(x.clone() for x in g["prev"])
        acc2 = tuple(a.clone() for a in g["acc"])
        got = ct.cheb_term_apply(g["T"], own, acc2, g["seed"], g["srcs"],
                                 g["srcsh"], call, SCAL, out=own)
        assert got is own
        assert all(torch.equal(a, b) for a, b in zip((*own, *acc2),
                                                     (*nxt, *acc)))
        # the kernel's arithmetic through the descriptor
        d = tct._k2_descriptor(g, g["seed"], SCAL)
        assert d.re.state_type == 1
        emu = [torch.tensor(e, dtype=torch.float32)
               for e in tct._emulate_k2(d)]
        for e, x in zip(emu[:2], x32):
            assert _one_rounding(e.to(BF16), x)
        for e, w in zip(emu[2:], acc32):
            assert float((e - w).abs().max()) <= 2e-6 * (
                float(w.abs().max()) + 1.0)
    assert n_seeded > 0


@pytest.mark.parametrize("case", ["default", "tail", "longrange"])
def test_cheb_scan_bf16_matches_jax_fused(monkeypatch, case):
    """One Chebyshev step on a bf16 pair through the port's K2 route against
    the JAX scan with the fused term kernel (interpret mode), at bf16
    resolution (rtol 0.05, atol 0.02 of tests/test_pallas_cheb.py:60-66;
    the leaves are O(1e-2), so the atol alone would pass anything: the
    relative bound on the whole vector below is the real check)."""
    L, cheb_n = (8, 6) if case == "longrange" else (10, 8)
    top_k = 2 if case == "tail" else None
    lj, lt = tct._models(L, long_range=case == "longrange",
                         splits=(3, 3, 2) if case == "longrange" else None)
    p = tct._pair(lj, 0, zero_im=False)
    c, a, b = jch.chebyshev_coefficients(0.15, -0.8 * L, 0.8 * L, cheb_n)
    c_ri = np.stack([c.real, c.imag], axis=1).astype(np.float32)
    monkeypatch.setenv("SDTPU_CHEB_FUSED", "1")
    if top_k is not None:
        monkeypatch.setenv("SDTPU_CHEB_TOPK", str(top_k))
    oj = jke._cheb_kron_scan(
        jke.kron_planes_matvec_fn(lj, fused=True),
        tuple(JBV([jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                   for x in q]) for q in p),
        jnp.asarray(c_ri), (jnp.float32(1.0 / a), jnp.float32(b)), cheb_n)
    planes = tke.kron_planes_matvec_fn(lt, device="cpu", cheb_top_k=top_k)
    ab = (float(np.float32(1.0 / a)), float(np.float32(b)))

    def tpair(dtype):
        return tuple(pt.BlockVec([torch.tensor(x, dtype=torch.float32)
                                  for x in q]).astype(dtype) for q in p)

    ot = tke._cheb_kron_scan(planes, tpair(BF16), c_ri, ab, cheb_n)
    o32 = tke._cheb_kron_scan(planes, tpair(torch.float32), c_ri, ab, cheb_n)
    num = den = num32 = 0.0
    for P, Q, R in zip(oj, ot, o32):
        for x, y, z in zip(P.leaves, Q.leaves, R.leaves):
            assert y.dtype == BF16
            xj = np.asarray(x.astype(jnp.float32), np.float64)
            np.testing.assert_allclose(y.double().numpy(), xj, rtol=0.05,
                                       atol=0.02)
            num += float(((y.double().numpy() - xj) ** 2).sum())
            num32 += float(((y.double() - z.double()) ** 2).sum())
            den += float((xj ** 2).sum())
    assert np.sqrt(num / den) < 2e-2      # against JAX's bf16 step
    assert np.sqrt(num32 / den) < 2e-2    # against the port's float32 step


def test_cheb_scan_bf16_plain_route_matches_fused():
    """cheb_fused=False (two K1 applies + the torch combine per term) on a
    bf16 pair agrees with the K2 route in the bf16 class."""
    _, lt = tct._models(10)
    p = tct._pair(lt, 4, zero_im=False)
    c, a, b = tch.chebyshev_coefficients(0.15, -8.0, 8.0, 8)
    c_ri = np.stack([c.real, c.imag], axis=1).astype(np.float32)
    ab = (float(np.float32(1.0 / a)), float(np.float32(b)))
    outs = []
    for cheb_fused in (True, False):
        planes = tke.kron_planes_matvec_fn(lt, device="cpu",
                                           cheb_fused=cheb_fused)
        pair = tuple(pt.BlockVec([torch.tensor(x, dtype=torch.float32)
                                  for x in q]).astype(BF16) for q in p)
        outs.append(tke._cheb_kron_scan(planes, pair, c_ri, ab, 8))
    num = sum(float(((x.double() - y.double()) ** 2).sum())
              for P, Q in zip(*outs) for x, y in zip(P.leaves, Q.leaves))
    den = sum(float((x.double() ** 2).sum())
              for P in outs[0] for x in P.leaves)
    assert all(x.dtype == BF16 for P in outs[1] for x in P.leaves)
    assert np.sqrt(num / den) < 2e-2


# ---- the trajectory ---------------------------------------------------------


def test_bf16_trajectory_matches_jax_and_f32():
    """evolve_trajectory_kron(state_dtype=bfloat16) from the domain wall
    (tests/test_kron_evolve.py:343-360): bf16 leaves, every <Sz_i> within
    2e-2 of the port's float32 trajectory and of the JAX bf16 trajectory,
    norm drift < 5e-2, total Sz conserved to 1e-2."""
    L = 12
    kw = dict(Jxy=1.0, Jz=0.5, nup=L // 2)
    mj = sd.xxz_chain(L, dtype=jnp.float32, layout="sector_kron", **kw)
    mt = pt.xxz_chain(L, **kw)
    bits = tis.domain_wall_bitstring(mt)
    assert bits == jis.domain_wall_bitstring(mj)
    _, obs32, info32 = tke.evolve_trajectory_kron(mt, bits, 0.1, 4,
                                                  cheb_n=20, device="cpu")
    _, obsj, infoj = jke.evolve_trajectory_kron(
        mj, bits, 0.1, 4, cheb_n=20, state_dtype=jnp.bfloat16,
        Ebounds=info32["Ebounds"])
    n1, n2 = kg.kernel_launch_count(), ct.kernel_launch_count()
    pair, obsbf, infobf = tke.evolve_trajectory_kron(
        mt, bits, 0.1, 4, cheb_n=20, state_dtype=BF16,
        Ebounds=info32["Ebounds"], device="cpu")
    assert (kg.kernel_launch_count(), ct.kernel_launch_count()) == (n1, n2)
    assert all(l.dtype == BF16 for P in pair for l in P.leaves)
    np.testing.assert_allclose(obsbf, obs32, rtol=0, atol=2e-2)
    np.testing.assert_allclose(obsbf, obsj, rtol=0, atol=2e-2)
    assert infobf["norm_drift"] < 5e-2
    np.testing.assert_allclose(obsbf.sum(axis=1), 0.0, atol=1e-2)
    # the bounds solve of a bf16 run is the float32 one, padded harder
    _, _, info = tke.evolve_trajectory_kron(
        mt, bits, 0.1, 1, cheb_n=8, state_dtype=BF16, device="cpu")
    lo32, hi32 = info32["Ebounds"]
    lo, hi = info["Ebounds"]
    w32 = (hi32 - lo32 - 2e-6) / 1.02   # the unpadded Ritz width
    assert abs((hi - lo - 2e-6) / 1.05 - w32) < 1e-4 * w32


def test_bf16_trajectory_from_a_pair_and_plain_route():
    """A given (re, im) pair is cast to the state dtype; fused=False runs
    the plain apply on bf16 leaves; both stay in the bf16 class of the
    float32 run."""
    L = 10
    mt = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2)
    lt = tsk.make_sector_kron_layout(mt, mt.kron_splits)
    p = tuple(pt.BlockVec([torch.tensor(x, dtype=torch.float32) for x in q])
              for q in tct._pair(lt, 9, zero_im=False))
    kw = dict(dt=0.1, n_steps=2, cheb_n=12, Ebounds=(-6.0, 6.0),
              device="cpu")
    _, o32, _ = tke.evolve_trajectory_kron(mt, p, **kw)
    for fused in (True, False):
        pair, obf, info = tke.evolve_trajectory_kron(
            mt, p, state_dtype=BF16, fused=fused, **kw)
        assert all(l.dtype == BF16 for P in pair for l in P.leaves)
        np.testing.assert_allclose(obf, o32, rtol=0, atol=2e-2)
        assert info["norm_drift"] < 5e-2


# ---- a bf16 BlockVec recurrence outside the trajectory ----------------------


def test_kpm_moments_bf16_vs_f32():
    """Jackson-damped KPM moments from a bf16 BlockVec recurrence through
    the fused apply against the float32 recurrence (TestBf16Physics,
    tests/test_sector_kron.py:317-362: dmax < 5e-3), and against the JAX
    package's bf16 recurrence."""
    L, M = 12, 24
    kw = dict(Jxy=1.0, Jz=1.0, nup=L // 2)
    mj = sd.xxz_chain(L, dtype=jnp.float64, layout="sector_kron", **kw)
    mt = pt.xxz_chain(L, dtype=torch.float64, **kw)
    lj = jsk.make_sector_kron_layout(mj, mj.kron_splits)
    lt = tsk.make_sector_kron_layout(mt, mt.kron_splits)
    v = np.random.default_rng(3).standard_normal(lj.n_states)
    v = np.where(np.asarray(mj.valid_mask()), v, 0.0)
    v /= np.linalg.norm(v)
    a, b = float(L) * 0.75, 0.0
    H = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32)

    def mvr(bv):
        return (H(bv) - bv * b) * (1.0 / a)

    def jmvr(bv):
        return (JBV(j_fused(bv.leaves, lj)) - b * bv) * (1.0 / a)

    b32, bbf = _bf16_blocks(v, lt)
    mu32 = tch.chebyshev_moments(mvr, pt.BlockVec(b32), M).numpy()
    mubf = tch.chebyshev_moments(mvr, pt.BlockVec(bbf), M)
    assert mubf.dtype == torch.float32  # the dots are float32 sums
    mubf = mubf.numpy()
    muj = np.asarray(jch.chebyshev_moments(jmvr, JBV([
        x.astype(jnp.bfloat16) for x in jsk.flat_to_blocks(
            jnp.asarray(v, jnp.float32), lj)]), M).astype(jnp.float32))
    g = tch.jackson_kernel(M)
    assert np.abs(g * (mubf - mu32)).max() < 5e-3
    assert np.abs(g * (mubf - muj)).max() < 5e-3
    x = np.linspace(-0.95, 0.95, 101) * a
    d32 = tch.kpm_reconstruct(torch.as_tensor(mu32), x, a, b).numpy()
    dbf = tch.kpm_reconstruct(torch.as_tensor(mubf), x, a, b).numpy()
    assert np.abs(d32 - dbf).max() < 5e-3 * max(1.0, np.abs(d32).max())


# ---- states and conversion ---------------------------------------------------


def test_blockvec_helpers_on_bf16():
    mt = pt.xxz_chain(10, nup=5)
    lt = tsk.make_sector_kron_layout(mt, mt.kron_splits)
    bits = tis.domain_wall_bitstring(mt)
    e = tbv.bv_basis_state(lt, bits, BF16, "cpu")
    e32 = tbv.bv_basis_state(lt, bits, torch.float32, "cpu")
    assert e.dtype == BF16
    assert all(torch.equal(a.float(), b) for a, b in zip(e.leaves, e32.leaves))
    g = torch.Generator().manual_seed(3)
    r = tbv.bv_random(lt, g, BF16, "cpu")
    r32 = tbv.bv_random(lt, torch.Generator().manual_seed(3), torch.float32,
                        "cpu")
    assert r.dtype == BF16  # the float32 draw, rounded; pads zero
    assert all(torch.equal(a, b.to(BF16)) for a, b in zip(r.leaves,
                                                          r32.leaves))
    for x, (_, _, _, ch, cm, cl, cmp, clp) in zip(r.leaves, lt.groups):
        assert not x[:, cm:, :].any() and not x[:, :, cl:].any()
    assert r32.astype(BF16).dtype == BF16 and r.astype(torch.float32).dtype \
        == torch.float32
    # a 0-d float32 scalar is cast to the leaf dtype (x * s.astype(dtype))
    s = torch.tensor(0.3)
    assert (r * s).dtype == BF16 and (r / s).dtype == BF16
    assert tbv.bv_zeros_like(r).dtype == BF16
    # dots and probabilities of bf16 leaves are float32 sums
    n2 = tke.pair_norm2((r, r))
    want = 2 * sum(float((x.double() ** 2).sum()) for x in r.leaves)
    assert n2.dtype == torch.float32 and abs(float(n2) - want) < 1e-5 * want


def test_numpy_bf16_round_trip_matches_ml_dtypes():
    """blockvec_from_numpy / state_from_numpy with dtype=bfloat16 round the
    float32 values to nearest even, as `astype(bfloat16)` of the JAX package
    (ml_dtypes) does, ties included; back to numpy they are float32,
    exactly."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 8, 128)).astype(np.float32)
    # exact ties: 1 + (2k + 1) 2^-8 lies halfway between two bf16 values
    x[0, 0, :8] = 1.0 + (2 * np.arange(8) + 1) * 2.0 ** -8
    want = x.astype(ml_dtypes.bfloat16).astype(np.float32)
    bv = convert.blockvec_from_numpy([x, x[:1]], "cpu", dtype=BF16)
    assert bv.dtype == BF16
    back = convert.blockvec_to_numpy(bv)
    assert back[0].dtype == np.float32
    assert np.array_equal(back[0], want) and np.array_equal(back[1], want[:1])
    jx = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(back[0], jx)
    flat = convert.state_from_numpy(x.reshape(-1).astype(np.float64), "cpu",
                                    dtype=BF16)
    assert flat.dtype == BF16
    assert np.array_equal(convert.state_to_numpy(flat), want.reshape(-1))
    # other dtypes as before
    assert convert.state_from_numpy(x, "cpu").dtype == torch.float32
    assert convert.blockvec_from_numpy([x], "cpu").dtype == torch.float32


# ---- lift once per use: bit for bit against a lift-per-use composition ----


def _lift_all(bv):
    return [l.float() for l in bv.leaves]


def _ref_k1(H, bv, axpy=None):
    """H bv (+ s bv0) of a bfloat16 BlockVec through the plain K1, composed
    with a lift at every use: every sum on float32 copies of the leaves,
    the seeds and tails rounded once to bfloat16."""
    lay, tables, calls = H.layout, H.tables, H.calls
    fused = kg.fused_group_set(lay, H.top_k)
    L32, bf = _lift_all(bv), torch.bfloat16
    tail = frozenset(range(len(lay.groups))) - fused
    hi = tsk.apply_H_sector_kron(L32, None, lay, tables, terms="hi,crossh",
                                 group_filter=tail) if tail else None
    lo = tsk.apply_H_sector_kron(L32, None, lay, tables,
                                 terms="diag,lo,mid,crossl",
                                 group_filter=tail) if tail else None
    outs = []
    for gi in range(len(lay.groups)):
        sg = None if axpy is None else axpy[0] * axpy[1].leaves[gi].float()
        if gi in tail:
            t = lo[gi] + hi[gi]
            outs.append((t if sg is None else t + sg).to(bf))
            continue
        call = calls[gi]
        seed = (tsk.apply_H_sector_kron(L32, None, lay, tables,
                                        terms=call.seed_terms,
                                        group_filter=(gi,))[gi]
                if call.has_seed else None)
        if sg is not None:
            seed = sg if seed is None else seed + sg
        seed = None if seed is None else seed.to(bf).float()
        outs.append(kg.kron_group_apply_reference(
            L32[gi], seed, [L32[c[0]] for c in call.cross],
            [L32[c[0]] for c in call.crossh], call).to(bf))
    un = [calls[gi] for gi in sorted(fused) if calls[gi].unsupported]
    if un:
        ex = kg._unsupported_terms(L32, lay, tables, un)
        outs = [o if e is None else (o.float() + e).to(bf)
                for o, e in zip(outs, ex)]
    return outs


def _ref_term(H, fused, prev, curr, acc, scal):
    """One K2-fused Chebyshev term of bfloat16 pairs through K2's plain
    version, composed with a lift at every use; acc updated in place."""
    lay, tables, calls = H.layout, H.tables, H.calls
    a_inv, b, c_r, c_i = scal
    bf = torch.bfloat16
    C32 = (_lift_all(curr[0]), _lift_all(curr[1]))
    tail = frozenset(range(len(lay.groups))) - fused
    un = [calls[gi] for gi in sorted(fused) if calls[gi].unsupported]
    ex = [kg._unsupported_terms(c, lay, tables, un) for c in C32] if un \
        else None
    nxt = []
    for gi in range(len(lay.groups)):
        if gi in tail:
            h = [tsk.apply_H_sector_kron(c, None, lay, tables,
                                         group_filter=(gi,))[gi] for c in C32]
        else:
            call = calls[gi]
            seed = []
            for p in (0, 1):
                s = (tsk.apply_H_sector_kron(C32[p], None, lay, tables,
                                             terms=call.seed_terms,
                                             group_filter=(gi,))[gi]
                     if call.has_seed else None)
                e = None if ex is None else ex[p][gi]
                if e is not None:
                    s = e if s is None else s + e
                seed.append(None if s is None else s.to(bf).float())
            h = [kg.kron_group_apply_reference(
                C32[p][gi], seed[p], [C32[p][c[0]] for c in call.cross],
                [C32[p][c[0]] for c in call.crossh], call) for p in (0, 1)]
        x = [(h[p] - b * curr[p].leaves[gi].float()) * (2.0 * a_inv)
             - prev[p].leaves[gi].float() for p in (0, 1)]
        acc[0].leaves[gi].add_(c_r * x[0]).sub_(c_i * x[1])
        acc[1].leaves[gi].add_(c_i * x[0]).add_(c_r * x[1])
        nxt.append((x[0].to(bf), x[1].to(bf)))
    return [n[0] for n in nxt], [n[1] for n in nxt]


def _ref_plain_step(H, pair, c_ri, ab, n):
    """The plain recurrence's step of a bfloat16 pair (terms through the
    lift-per-use K1 composition), every combine on lifted leaves."""
    a_inv, b = ab
    bf = torch.bfloat16
    c = [(float(r), float(i)) for r, i in np.asarray(c_ri, np.float32)]

    def mvr(p):
        return [[((h.float() - b * x.float()) * a_inv).to(bf)
                 for h, x in zip(_ref_k1(H, P), P.leaves)] for P in p]

    def acc_add(acc, x, ck):
        for ar, ai, xr, xi in zip(acc[0], acc[1], x[0], x[1]):
            xr, xi = xr.float(), xi.float()
            ar.add_(xr * ck[0]).sub_(xi * ck[1])
            ai.add_(xr * ck[1]).add_(xi * ck[0])

    pr, pi = pair[0].leaves, pair[1].leaves
    acc = ([r.float() * c[0][0] - i.float() * c[0][1] for r, i in zip(pr, pi)],
           [r.float() * c[0][1] + i.float() * c[0][0] for r, i in zip(pr, pi)])
    prev, curr = [list(pr), list(pi)], mvr(pair)
    acc_add(acc, curr, c[1])
    for ck in c[2:n]:
        t = mvr((pair[0].like(curr[0]), pair[0].like(curr[1])))
        nx = [[(tt.float() * 2.0 - pv.float()).to(bf)
               for tt, pv in zip(t[p], prev[p])] for p in (0, 1)]
        acc_add(acc, nx, ck)
        prev, curr = curr, nx
    return [l.to(bf) for l in acc[0]], [l.to(bf) for l in acc[1]]


@pytest.mark.parametrize("kind", ["xxz", "long_range"])
def test_bf16_lift_once_is_bit_for_bit(kind):
    """The bfloat16 glue that lifts each leaf once per use and lets each
    write round once (ops/cheb_term, ops/kron_group, ops/sector_kron,
    solvers/kron_evolve) against a local lift-per-use composition of the
    same operations: one K2 term (tail groups and, for the long-range
    model, unsupported seed entries included), one K1 apply with the
    Lanczos axpy, and one plain-recurrence step are equal bit for bit;
    term_seed's bfloat16 seed equals the float32 seed rounded."""
    if kind == "xxz":
        m, top_k = pt.xxz_chain(14, Jxy=1.0, Jz=0.5, nup=7,
                                kron_splits=(6, 4, 4)), 6
    else:
        m = pt.build_model(8, nup=4, hopping=tct.long_range_hopping(
            8, tct._lr), kron_splits=(3, 3, 2))
        top_k = 4
    lay = tsk.make_sector_kron_layout(m, m.kron_splits)
    H = pt.KronHamiltonian(lay, device="cpu", top_k=top_k)
    fused = kg.fused_group_set(lay, top_k)
    assert len(fused) < len(lay.groups)  # tail groups take part
    if kind == "long_range":
        assert any(H.calls[gi].unsupported for gi in fused)
    g = torch.Generator().manual_seed(3)
    bf = torch.bfloat16
    prev, curr = ((tbv.bv_random(lay, g, bf, "cpu"),
                   tbv.bv_random(lay, g, bf, "cpu")) for _ in range(2))
    acc = (tbv.bv_random(lay, g, torch.float32, "cpu"),
           tbv.bv_random(lay, g, torch.float32, "cpu"))
    acc_ref = tuple(a.map(torch.clone) for a in acc)
    scal = (0.11, 0.7, 0.3, -0.2)
    got = ct.cheb_term_fused(lay, H.tables, H.calls, fused, prev, curr, acc,
                             scal)
    want = _ref_term(H, fused, prev, curr, acc_ref, scal)
    for p in (0, 1):
        assert all(torch.equal(a, b) for a, b in zip(got[p].leaves, want[p]))
        assert all(torch.equal(a, b) for a, b in zip(acc[p].leaves,
                                                     acc_ref[p].leaves))
    # the seeds: the float32 sum rounded once
    un = [H.calls[gi] for gi in sorted(fused) if H.calls[gi].unsupported]
    for gi in sorted(fused):
        call = H.calls[gi]
        blocks = (list(curr[0].leaves), list(curr[1].leaves))
        ex32 = ([kg._unsupported_terms(b, lay, H.tables, un)[gi]
                 for b in blocks] if un else [None, None])
        ex = None if ex32[0] is None else tuple(ex32)
        seed = ct.term_seed(blocks, lay, H.tables, call, ex)
        H32 = pt.KronHamiltonian(lay, device="cpu", top_k=top_k)
        f32 = ct.term_seed(([l.float() for l in blocks[0]],
                            [l.float() for l in blocks[1]]), lay,
                           H32.tables, H32.calls[gi], ex)
        if seed is None:
            assert f32 is None
            continue
        assert seed[0].dtype == bf
        assert all(torch.equal(s, f.to(bf)) for s, f in zip(seed, f32))
    # one K1 apply with the Lanczos axpy, and without
    for axpy in (None, (torch.tensor(-0.37), prev[0])):
        got = H(curr[0]) if axpy is None else H(curr[0], *axpy)
        assert all(torch.equal(a, b) for a, b in zip(
            got.leaves, _ref_k1(H, curr[0], axpy)))
    # one plain-recurrence step
    planes = tke.kron_planes_matvec_fn(lay, device="cpu", cheb_fused=False)
    planes.H.top_k = top_k
    c_ri, ab = tke._coeff_arrays(tch.chebyshev_coefficients(0.1, -6.0, 6.0,
                                                            8))
    got = tke._cheb_kron_scan(planes, curr, c_ri, ab, 8)
    want = _ref_plain_step(planes.H, curr, c_ri, ab, 8)
    for p in (0, 1):
        assert all(torch.equal(a, b) for a, b in zip(got[p].leaves, want[p]))
