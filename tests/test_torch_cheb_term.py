"""K2, the fused Chebyshev term: its route on the CPU (the plain version)
against the JAX package's fused term in Pallas interpret mode, including
the tail groups and the unsupported entries folded into the seeds; an
emulation of the CUDA kernel's grid, tiles and epilogue read through the
ctypes descriptor K2 receives; and the wrapper's contract (launch count,
in-place accumulator, inputs left untouched, refusals). The kernel itself
is tested on the card in tests/test_torch_cuda_cheb.py."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu.ops import sector_kron as jsk
from spindynamics_tpu.solvers import kron_evolve as jke
from spindynamics_tpu.solvers.blockvec import BlockVec as JBV
from spindynamics_tpu.solvers.chebyshev import chebyshev_coefficients
from spindynamics_tpu_torch.model import long_range_hopping
from spindynamics_tpu_torch.ops import cheb_term as ct
from spindynamics_tpu_torch.ops import kron_group as kg
from spindynamics_tpu_torch.ops import sector_kron as tsk
from spindynamics_tpu_torch.solvers import kron_evolve as tke

from test_torch_kron_group import _emulate_k1, _round_bf16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per test process, so
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lr(i, j):
    return 1.0 / (j - i) ** 2


def _models(L, long_range=False, splits=None, Jz=0.5):
    if long_range:
        mj = sd.long_range_xy_chain(L, _lr, nup=L // 2, dtype=jnp.float32,
                                    layout="sector_kron", kron_splits=splits)
        mt = pt.build_model(L, nup=L // 2, hopping=long_range_hopping(L, _lr),
                            kron_splits=splits)
    else:
        kw = dict(Jxy=1.0, Jz=Jz, nup=L // 2, kron_splits=splits)
        mj = sd.xxz_chain(L, dtype=jnp.float32, layout="sector_kron", **kw)
        mt = pt.xxz_chain(L, **kw)
    return (jsk.make_sector_kron_layout(mj, mj.kron_splits),
            tsk.make_sector_kron_layout(mt, mt.kron_splits))


def _pair(lay, seed, zero_im=False):
    """A normalized (re, im) pair as numpy leaves, zero on pad slots."""
    rng = np.random.default_rng(seed)

    def leaves():
        out = []
        for (_, _, _, ch, cm, cl, cmp, clp) in lay.groups:
            x = np.zeros((ch, cmp, clp))
            x[:, :cm, :cl] = rng.standard_normal((ch, cm, cl))
            out.append(x)
        return out

    re = leaves()
    im = [np.zeros_like(x) for x in re] if zero_im else leaves()
    n = np.sqrt(sum(float((x * x).sum()) for x in re + im))
    return [x / n for x in re], [x / n for x in im]


def _step_both(monkeypatch, L, cheb_n, long_range=False, top_k=None,
               zero_im=True, splits=None):
    """One Chebyshev step through JAX's fused term (interpret mode) and
    through the port's K2 route (K2's plain version on the CPU)."""
    lj, lt = _models(L, long_range=long_range, splits=splits)
    p = _pair(lj, 0, zero_im=zero_im)
    c, a, b = chebyshev_coefficients(0.15, -0.8 * L, 0.8 * L, cheb_n)
    c_ri = np.stack([c.real, c.imag], axis=1).astype(np.float32)
    monkeypatch.setenv("SDTPU_CHEB_FUSED", "1")
    if top_k is not None:
        monkeypatch.setenv("SDTPU_CHEB_TOPK", str(top_k))
    oj = jke._cheb_kron_scan(
        jke.kron_planes_matvec_fn(lj, fused=True),
        tuple(JBV([jnp.asarray(x, jnp.float32) for x in q]) for q in p),
        jnp.asarray(c_ri), (jnp.float32(1.0 / a), jnp.float32(b)), cheb_n)
    planes = tke.kron_planes_matvec_fn(lt, device="cpu", cheb_top_k=top_k)
    assert planes.cheb_fused
    n0 = ct.kernel_launch_count()
    ot = tke._cheb_kron_scan(
        planes, tuple(pt.BlockVec([torch.tensor(x, dtype=torch.float32)
                                   for x in q]) for q in p),
        c_ri, (float(np.float32(1.0 / a)), float(np.float32(b))), cheb_n)
    assert ct.kernel_launch_count() == n0  # CPU tensors: the plain version
    return lt, oj, ot


@pytest.mark.parametrize("top_k", [None, 2], ids=["default", "tail"])
def test_k2_route_matches_jax_interpret(monkeypatch, top_k):
    """top_k=2 sends most groups through the tail's plain apply and torch
    combine; the default fuses every group."""
    lt, oj, ot = _step_both(monkeypatch, 10, 8, top_k=top_k, zero_im=False)
    if top_k is not None:
        assert len(kg.fused_group_set(lt, top_k)) < len(lt.groups)
    for P, Q in zip(oj, ot):
        for a, b in zip(P.leaves, Q.leaves):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-6,
                                       atol=2e-7)


def test_k2_route_long_range_unsupported_seeds(monkeypatch):
    """Long-range bonds give lo|mid entries K2 cannot fuse: they fold into
    the seeds (pallas_cheb.py:266-271,307-314), not drop. The splits
    (3, 3, 2) give multi-run mid factors; the default (6, 1, 1) gives
    none."""
    lt, oj, ot = _step_both(monkeypatch, 8, 6, long_range=True,
                            splits=(3, 3, 2))
    assert any(p.unsupported for p in kg.fused_group_plans(lt))
    for P, Q in zip(oj, ot):
        for a, b in zip(P.leaves, Q.leaves):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-6,
                                       atol=2e-7)


_ARGS = ("T", "prev", "acc", "seed", "srcs", "srcsh", "call")


def _group_args(lt, seed=11, sdt=torch.float32):
    """Per K2-fused group, the main path's launch arguments
    (cheb_term.term_launches) from numpy-made curr, prev and acc pairs:
    curr and prev in the state dtype `sdt`, acc float32."""
    H = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32)
    curr, prev, acc = (tuple(pt.BlockVec([torch.tensor(x, dtype=torch.float32)
                                          for x in q]).astype(dt)
                             for q in _pair(lt, seed + i))
                       for i, dt in enumerate((sdt, sdt, torch.float32)))
    fused = kg.fused_group_set(lt, tsk.default_fused_topk(lt, 1 << 15))
    return [dict(zip(_ARGS, args)) for _, args in ct.term_launches(
        lt, H.tables, H.calls, fused, prev, curr, acc)]


def _emulate_k2(d, with_mag=False):
    """Run cheb_term.cu in numpy from its ctypes descriptor: K1's grid,
    tiles, segment masks and hi-local sum (the K1 emulation, driven once
    per plane by a K1 descriptor holding that plane's pointers, exactly the
    pointers the kernel reads for it), then the epilogue per element with
    the descriptor's float32 scalars. States are read in the descriptor's
    state type and acc as float32; a bfloat16 launch rounds next once and
    updates acc from the unrounded x. Returns (next_re, next_im, acc_re,
    acc_im) without touching the inputs; `with_mag` also returns a bound of
    the hi/lo split's sum |a||b| through the epilogue, per element."""
    ch, cmp, clp = d.re.ch, d.re.cmp, d.re.clp
    n = ch * cmp * clp
    bf16 = d.re.state_type == 1

    def acc_arr(ptr):
        return np.ctypeslib.as_array((ctypes.c_float * n).from_address(ptr)
                                     ).astype(np.float64).reshape(ch, cmp, clp)

    def arr(ptr):
        if not bf16:
            return acc_arr(ptr)
        u = np.ctypeslib.as_array((ctypes.c_uint16 * n).from_address(ptr))
        return (u.astype(np.uint32) << 16).view(np.float32).astype(
            np.float64).reshape(ch, cmp, clp)

    d_im = kg._KgDesc.from_buffer_copy(d.re)
    d_im.T, d_im.seed = d.T_im, d.seed_im
    for i in range(d.re.n_cross):
        d_im.cross[i].src = d.cross_src_im[i]
    for i in range(d.re.n_crossh):
        d_im.crossh[i].src = d.crossh_src_im[i]
    (h_re, m_re), (h_im, m_im) = (_emulate_k1(d.re, store=False, with_mag=True),
                                  _emulate_k1(d_im, store=False, with_mag=True))
    f = np.float32
    two_ai, b, c_r, c_i = f(2.0) * f(d.a_inv), f(d.b), f(d.c_r), f(d.c_i)
    xr = (h_re - b * arr(d.re.T)) * two_ai - arr(d.prev_re)
    xi = (h_im - b * arr(d.T_im)) * two_ai - arr(d.prev_im)
    ar = acc_arr(d.acc_re) + c_r * xr - c_i * xi
    ai = acc_arr(d.acc_im) + c_i * xr + c_r * xi
    if bf16:
        xr, xi = _round_bf16(xr), _round_bf16(xi)
    if with_mag:  # the split's error scale, carried through the epilogue
        mag = abs(two_ai) * (1 + abs(c_r) + abs(c_i)) * np.maximum(m_re, m_im)
        return (xr, xi, ar, ai), mag
    return xr, xi, ar, ai


def _k2_descriptor(g, seed, scal):
    """The group's descriptor as cheb_term_apply fills it for a launch (but
    for the outputs), over the CPU tensors of `g` (_group_args)."""
    d = ct.term_descriptor(g["call"], torch.device("cpu"))
    d.re.state_type = kg._state_type(g["T"][0])
    d.re.T, d.T_im = g["T"][0].data_ptr(), g["T"][1].data_ptr()
    d.re.seed, d.seed_im = ((None, None) if seed is None else
                            (seed[0].data_ptr(), seed[1].data_ptr()))
    d.prev_re, d.prev_im = g["prev"][0].data_ptr(), g["prev"][1].data_ptr()
    d.acc_re, d.acc_im = g["acc"][0].data_ptr(), g["acc"][1].data_ptr()
    for i, (sr, si) in enumerate(g["srcs"]):
        d.re.cross[i].src, d.cross_src_im[i] = sr.data_ptr(), si.data_ptr()
    for i, (sr, si) in enumerate(g["srcsh"]):
        d.re.crossh[i].src, d.crossh_src_im[i] = sr.data_ptr(), si.data_ptr()
    d.a_inv, d.b, d.c_r, d.c_i = scal
    return d


@pytest.mark.parametrize("L,splits,long_range", [
    (16, None, False), (12, (5, 4, 3), False), (14, (6, 4, 4), False),
    (10, (4, 3, 3), True)], ids=["L16", "L12", "L14", "L10-longrange"])
def test_k2_emulation_matches_reference(L, splits, long_range):
    """Every K2-fused group, with its main-path seed (and without one): the
    descriptor-driven emulation equals cheb_term_apply_reference, to the
    float32 summation order (2e-6 of the scale) and, per element, the hi/lo
    split's 2^-16 sum |a||b| carried through the epilogue. The long-range
    layout's tables are not exactly bf16: its segments take the FMA
    route."""
    _, lt = _models(L, long_range=long_range, splits=splits, Jz=0.7)
    scal = tuple(float(np.float32(x)) for x in (0.083, -0.41, 0.37, -0.62))
    n_cross = n_crossh = 0
    for g in _group_args(lt):
        call = g["call"]
        n_cross += len(call.cross)
        n_crossh += len(call.crossh)
        for seed in (g["seed"], None):
            acc = tuple(a.clone() for a in g["acc"])
            want = ct.cheb_term_apply_reference(g["T"], g["prev"], acc, seed,
                                                g["srcs"], g["srcsh"], call,
                                                scal)
            emu, mag = _emulate_k2(_k2_descriptor(g, seed, scal),
                                   with_mag=True)
            for e, w in zip(emu, (*want, *acc)):
                scale = float(w.abs().max()) + 1.0
                assert np.all(np.abs(e - w.double().numpy())
                              <= 2.0 ** -16 * mag + 2e-6 * scale)
    # both cross kinds were exercised; the long-range layout takes its
    # mid|hi terms and unsupported entries through the seed instead
    assert n_cross > 0 and (n_crossh > 0) != long_range


def test_k2_wrapper_contract_on_cpu():
    """The accumulator is updated in place; the state, prev and seed are
    untouched; the CPU route launches no kernel; a non-CUDA, non-CPU tensor
    is refused, never rerouted; the descriptor embeds K1's."""
    _, lt = _models(12, splits=(5, 4, 3))
    g = next(g for g in _group_args(lt) if g["seed"] is not None)
    keep = [x.clone() for x in (*g["T"], *g["prev"], *g["seed"])]
    acc0 = tuple(a.clone() for a in g["acc"])
    scal = (0.1, 0.2, 0.3, 0.4)
    n0 = ct.kernel_launch_count()
    nr, ni = ct.cheb_term_apply(g["T"], g["prev"], g["acc"], g["seed"],
                                g["srcs"], g["srcsh"], g["call"], scal)
    assert ct.kernel_launch_count() == n0
    assert all(torch.equal(a, b) for a, b in zip(
        keep, (*g["T"], *g["prev"], *g["seed"])))
    want = (acc0[0] + 0.3 * nr - 0.4 * ni, acc0[1] + 0.4 * nr + 0.3 * ni)
    for a, w in zip(g["acc"], want):
        assert float((a - w).abs().max()) < 1e-6 * float(w.abs().max())
    assert ctypes.sizeof(ct._CtDesc) == ctypes.sizeof(kg._KgDesc) + 7 * 8 \
        + 24 * 8 + 16
    meta = tuple(torch.zeros(g["call"].shape, device="meta")
                 for _ in range(2))
    with pytest.raises(ValueError, match="CUDA"):
        ct.cheb_term_apply(meta, meta, meta, None, [], [], g["call"], scal)


def test_scan_terms_reuse_storage():
    """cheb_scan_terms_fused writes each term from the second on over the
    term before last: the result equals fresh outputs bit for bit, the
    caller's pair_prev is untouched, and the accumulator it was given comes
    back updated in place."""
    _, lt = _models(10, long_range=True, splits=(4, 3, 3))
    H = pt.KronHamiltonian(lt, device="cpu", dtype=torch.float32)

    def pairs():
        return [tuple(pt.BlockVec([torch.tensor(x, dtype=torch.float32)
                                   for x in q]) for q in _pair(lt, s))
                for s in (1, 2, 3)]

    coeffs = [(0.3, -0.2), (0.1, 0.05), (-0.07, 0.02), (0.01, 0.03)]
    fused = kg.fused_group_set(lt, 3)  # with a tail
    prev, curr, acc = pairs()
    for cr, ci in coeffs:  # fresh outputs every term
        nxt = ct.cheb_term_fused(lt, H.tables, H.calls, fused, prev, curr,
                                 acc, (0.1, 0.4, cr, ci))
        prev, curr = curr, nxt
    prev, curr, acc2 = pairs()
    keep = [l.clone() for Q in prev for l in Q.leaves]
    out = ct.cheb_scan_terms_fused(lt, H.tables, H.calls, prev, curr, acc2,
                                   coeffs, (0.1, 0.4), top_k=3)
    assert out is acc2
    assert all(torch.equal(a, b) for a, b in zip(
        keep, [l for Q in prev for l in Q.leaves]))
    assert all(torch.equal(a, b) for P, Q in zip(acc, acc2)
               for a, b in zip(P.leaves, Q.leaves))
