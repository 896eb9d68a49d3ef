"""K2: the fused Chebyshev evolution term on BlockVec plane pairs (port of
spindynamics_tpu/ops/pallas_cheb.py).

Term k >= 2 of the Chebyshev-Bessel step e^{-iH dt}
(solvers/kron_evolve._cheb_kron_scan) does, per (re, im) plane,

    x = 2 * (H p_curr - b p_curr) / a - p_prev          (shifted recurrence)
    acc_re += c_r x_re - c_i x_im                        (coefficient update)
    acc_im += c_i x_re + c_r x_im

For each fused group one K2 launch computes both planes of K1's hi-local
apply and this whole combine; the W_hi contraction (and any mid|hi term K1
does not fuse, and any lo|mid entry it cannot take) arrives as the
per-plane seed, computed in plain torch; the tail groups run the plain
apply and the same combine in torch. The per-group structure, tables and
descriptor are K1's `_GroupCall` (ops/kron_group.py); the fused set comes
from `kron_group.fused_group_set`.

The kernel is CUDA C++ (`csrc/cheb_term.cu`, sharing `csrc/kron_tile.cuh`
with K1), built with nvcc for sm_90a on first use and loaded with ctypes.
`cheb_term_apply_reference` is its plain torch version: the wrapper
`cheb_term_apply` uses it for tensors on the CPU and only there; a CUDA
tensor launches the kernel or raises.

States are float32 or bfloat16. With bfloat16 the terms, the seeds and the
cross sources are bfloat16 in memory and the next term is stored bfloat16
(one rounding), while the accumulator pair stays float32 and is updated
from the unrounded float32 x, as in the TPU kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..solvers.blockvec import BlockVec
from ..utils.dtypes import lift_bf16
from .cuda_build import CSRC, build_shared_library
from .kron_group import (
    _MAX_CROSS,
    _MAX_CROSSH,
    _check_tensor,
    _KgDesc,
    _state_type,
    _unsupported_terms,
    apply_H_sector_kron_fused_reference,
    fused_group_set,
    group_seed,
    kron_group_apply_reference,
)
from .sector_kron import SectorKronLayout, apply_H_sector_kron

__all__ = [
    "cheb_scan_terms_fused",
    "cheb_term_fused",
    "cheb_term_fused_reference",
    "term_launches",
    "cheb_term_apply",
    "cheb_term_apply_reference",
    "kernel_launch_count",
    "reset_kernel_launch_count",
    "build_kernel",
]


class _CtDesc(ctypes.Structure):
    _fields_ = [("re", _KgDesc),
                ("next_im", ctypes.c_void_p), ("T_im", ctypes.c_void_p),
                ("seed_im", ctypes.c_void_p),
                ("prev_re", ctypes.c_void_p), ("prev_im", ctypes.c_void_p),
                ("acc_re", ctypes.c_void_p), ("acc_im", ctypes.c_void_p),
                ("cross_src_im", ctypes.c_void_p * _MAX_CROSS),
                ("crossh_src_im", ctypes.c_void_p * _MAX_CROSSH),
                ("a_inv", ctypes.c_float), ("b", ctypes.c_float),
                ("c_r", ctypes.c_float), ("c_i", ctypes.c_float)]


_SRC = CSRC / "cheb_term.cu"
_HEADERS = (CSRC / "kron_tile.cuh",)
_LIB = None
# the launch counter of each state dtype's instance of the kernel
_COUNTER = {torch.float32: "launches.k2.float32",
            torch.bfloat16: "launches.k2.bfloat16"}


def build_kernel() -> dict:
    """Compile K2 (once per source hash) and load it. Returns {"path",
    "seconds" (0 when the library was already built), "log" (nvcc's
    -Xptxas -v report)}."""
    global _LIB
    info = build_shared_library(_SRC, _HEADERS, "K2")
    if _LIB is None or _LIB._name != info["path"]:
        lib = ctypes.CDLL(info["path"])
        lib.ct_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.ct_launch.restype = ctypes.c_int
        lib.ct_desc_size.argtypes = []
        lib.ct_desc_size.restype = ctypes.c_int
        if lib.ct_desc_size() != ctypes.sizeof(_CtDesc):
            raise RuntimeError(
                f"CtDesc layout mismatch: C {lib.ct_desc_size()} bytes, "
                f"ctypes {ctypes.sizeof(_CtDesc)}")
        _LIB = lib
    return info


def kernel_launch_count(dtype=None) -> int:
    """Number of K2 launches since import (or the last reset): of the
    instance for states of `dtype` (torch.float32 or torch.bfloat16), or of
    both when None. The counters `launches.k2.<dtype>`
    (utils/profiling.py)."""
    from ..utils.profiling import counters

    c = counters()
    return sum(c.get(k, 0) for k in (_COUNTER.values() if dtype is None
                                     else (_COUNTER[dtype],)))


def reset_kernel_launch_count() -> None:
    from ..utils.profiling import reset_counters

    reset_counters("launches.k2")


def term_descriptor(call, device) -> _CtDesc:
    """K2's descriptor of one group: a copy of K1's (the tables, offsets
    and cross-term structure, checked on `device`) with room for the second
    plane, built once and cached on the call. Per launch only the state
    pointers and the four scalars change."""
    d1 = call.descriptor(device)
    if call.term_desc is None:
        d = _CtDesc()
        d.re = d1  # ctypes copies the structure
        call.term_desc = d
    return call.term_desc


def _combine(h, T, prev, acc, scal, out=None):
    """The term's epilogue on one group in torch, in the TPU kernel's
    operation order (pallas_cheb.py:165-178): x = (h - b T) * (2/a) - prev
    per plane; acc updated in place. Returns (x_re, x_im), written into
    `out` when given (which may be prev). T is the current term's pair
    LIFTED to float32 by the caller (who lifted it for h already); prev
    stays in the state dtype and is read as float32 by the subtraction's
    type promotion, so no lift pass is made. With bfloat16 prev, h and x
    are float32: acc takes the unrounded x, and the returned term is x
    rounded once to bfloat16 (in the copy into `out` when given)."""
    a_inv, b, c_r, c_i = scal
    two_ai = 2.0 * a_inv
    xr = (h[0] - b * T[0]) * two_ai - prev[0]
    xi = (h[1] - b * T[1]) * two_ai - prev[1]
    acc[0].add_(c_r * xr).sub_(c_i * xi)
    acc[1].add_(c_i * xr).add_(c_r * xi)
    if out is None:
        return xr.to(prev[0].dtype), xi.to(prev[1].dtype)
    out[0].copy_(xr)
    out[1].copy_(xi)
    return out


def cheb_term_apply(T, prev, acc, seed, srcs, srcsh, call, scal,
                    out=None):
    """One fused group of one Chebyshev term: K2 on CUDA tensors, its plain
    version on CPU tensors.

    T, prev: (re, im) pairs [ch, cmp, clp] (the current and previous terms),
    float32 or bfloat16, and every other state tensor (seed, sources, out)
    in the same dtype;
    acc: the (re, im) accumulator pair, float32, UPDATED IN PLACE (the
    alias of pallas_cheb.py:232); seed: (re, im) pair or None; srcs / srcsh:
    (re, im) source pairs of the lo|mid / mid|hi cross terms, in `call`'s
    order; call: the group's K1 call (ops/kron_group._GroupCall); scal:
    (1/a, b, c_r, c_i) host floats; out: an (re, im) pair to write the next
    term into, which may be `prev` itself (each element of prev is read
    before the same thread writes next there). Returns the next term
    (x_re, x_im), in `out` or in new tensors."""
    dev = T[0].device
    if dev.type == "cpu":
        return cheb_term_apply_reference(T, prev, acc, seed, srcs, srcsh,
                                         call, scal, out)
    if dev.type != "cuda":
        raise ValueError(f"K2 runs on CUDA tensors; got {dev}")
    from ..utils.profiling import count

    if len(srcs) != len(call.cross) or len(srcsh) != len(call.crossh):
        raise ValueError(f"group {call.gi}: expected {len(call.cross)} + "
                         f"{len(call.crossh)} source pairs")
    state_type = _state_type(T[0], "K2")
    sdt = T[0].dtype
    for name, pair, dt in (("state", T, sdt), ("prev", prev, sdt),
                           ("acc", acc, torch.float32), ("seed", seed, sdt),
                           ("out", out, sdt)):
        for x in (() if pair is None else pair):
            _check_tensor(x, call.shape, dev, name, "K2", dt)
    for S, shp in zip(srcs, call.cross_shapes):
        for x in S:
            _check_tensor(x, shp, dev, "lo|mid source", "K2", sdt)
    for S, shp in zip(srcsh, call.crossh_shapes):
        for x in S:
            _check_tensor(x, shp, dev, "mid|hi source", "K2", sdt)
    if _LIB is None:
        build_kernel()
    d = term_descriptor(call, dev)
    d.re.state_type = state_type
    nr, ni = ((torch.empty_like(T[0]), torch.empty_like(T[1]))
              if out is None else out)
    d.re.out, d.re.T, d.next_im, d.T_im = (
        nr.data_ptr(), T[0].data_ptr(), ni.data_ptr(), T[1].data_ptr())
    d.re.seed, d.seed_im = ((None, None) if seed is None
                            else (seed[0].data_ptr(), seed[1].data_ptr()))
    d.prev_re, d.prev_im = prev[0].data_ptr(), prev[1].data_ptr()
    d.acc_re, d.acc_im = acc[0].data_ptr(), acc[1].data_ptr()
    for i, (sr, si) in enumerate(srcs):
        d.re.cross[i].src, d.cross_src_im[i] = sr.data_ptr(), si.data_ptr()
    for i, (sr, si) in enumerate(srcsh):
        d.re.crossh[i].src, d.crossh_src_im[i] = (sr.data_ptr(),
                                                  si.data_ptr())
    d.a_inv, d.b, d.c_r, d.c_i = scal
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _LIB.ct_launch(ctypes.byref(d), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"K2 launch failed for group {call.gi}: "
                           f"cudaError {err}")
    count(_COUNTER[sdt])
    return (nr, ni) if out is None else out


def cheb_term_apply_reference(T, prev, acc, seed, srcs, srcsh, call, scal,
                              out=None):
    """Plain torch version of K2 (same arguments, same in-place acc update,
    same output), in the state's dtype: K1's plain version per plane, then
    the epilogue. bfloat16 states are lifted to float32 (K1's sum is not
    rounded on the way), acc takes the unrounded x and the next term is
    rounded once."""
    Tl = (lift_bf16(T[0]), lift_bf16(T[1]))
    h = tuple(kron_group_apply_reference(
        Tl[p], None if seed is None else lift_bf16(seed[p]),
        [lift_bf16(s[p]) for s in srcs],
        [lift_bf16(s[p]) for s in srcsh], call)
        for p in (0, 1))
    return _combine(h, Tl, prev, acc, scal, out)


def term_seed(blocks, layout, tables, call, extra):
    """The (re, im) seed of one fused group's K2 launch: the plain apply's
    `call.seed_terms` (W_hi, and the mid|hi terms when K2 does not fuse
    them) per plane, plus the group's unsupported lo|mid entries `extra`
    ((re, im) or None), each plane rounded once to the state dtype by the
    add that writes it (kron_group.group_seed). None when the group has
    neither."""
    sdt = blocks[0][call.gi].dtype
    seed = tuple(group_seed(b, layout, tables, call,
                            None if extra is None else e, sdt)
                 for b, e in zip(blocks, extra or (None, None)))
    return None if seed[0] is None else seed


def term_launches(layout, tables, calls, fused, pair_prev, pair_curr, acc):
    """The K2 launches of one term: yields (gi, args) per fused group, in
    order, with cheb_term_apply(*args, scal) running the group. Each seed is
    made when its group comes up, so it is freed after its launch; the
    group's unsupported lo|mid entries fold into it (pallas_cheb.py:266-271,
    307-314)."""
    blocks = (list(pair_curr[0].leaves), list(pair_curr[1].leaves))
    un = [calls[gi] for gi in sorted(fused) if calls[gi].unsupported]
    extra = ([_unsupported_terms(b, layout, tables, un) for b in blocks]
             if un else None)
    for gi in sorted(fused):
        call = calls[gi]
        ex = (None if extra is None or extra[0][gi] is None
              else (extra[0][gi], extra[1][gi]))
        yield gi, ((blocks[0][gi], blocks[1][gi]),
                   (pair_prev[0].leaves[gi], pair_prev[1].leaves[gi]),
                   (acc[0].leaves[gi], acc[1].leaves[gi]),
                   term_seed(blocks, layout, tables, call, ex),
                   [(blocks[0][c[0]], blocks[1][c[0]]) for c in call.cross],
                   [(blocks[0][c[0]], blocks[1][c[0]]) for c in call.crossh],
                   call)


def cheb_term_fused(layout, tables, calls, fused, pair_prev, pair_curr, acc,
                    scal, reuse_prev: bool = False):
    """One term on every group (port of pallas_cheb._cheb_term_fused): K2
    for the groups in `fused`, the plain apply + torch combine for the
    rest. acc (an (re, im) BlockVec pair) is updated in place; returns the
    next term as an (re, im) BlockVec pair, written over pair_prev's
    storage when `reuse_prev`."""
    tail = frozenset(range(len(layout.groups))) - fused

    def out(gi):
        return ((pair_prev[0].leaves[gi], pair_prev[1].leaves[gi])
                if reuse_prev else None)

    nxt = [None] * len(layout.groups)
    if tail:
        # each tail leaf (and cross source) of a bfloat16 pair is lifted
        # once, for the apply and the combine alike
        lifted = ({}, {})
        ht = [apply_H_sector_kron(list(p.leaves), None, layout, tables,
                                  terms="all", group_filter=tail, lifted=lf)
              for p, lf in zip(pair_curr, lifted)]
        for gi in sorted(tail):
            nxt[gi] = _combine(
                (ht[0][gi], ht[1][gi]), (lifted[0][gi], lifted[1][gi]),
                (pair_prev[0].leaves[gi], pair_prev[1].leaves[gi]),
                (acc[0].leaves[gi], acc[1].leaves[gi]), scal, out(gi))
        del ht, lifted
    for gi, args in term_launches(layout, tables, calls, fused, pair_prev,
                                  pair_curr, acc):
        nxt[gi] = cheb_term_apply(*args, scal, out(gi))
    return BlockVec([x[0] for x in nxt]), BlockVec([x[1] for x in nxt])


def cheb_term_fused_reference(layout, tables, calls, fused, pair_prev,
                              pair_curr, acc, scal):
    """The plain version of cheb_term_fused (same arguments, acc updated in
    place) in float32: per plane apply_H_sector_kron_fused_reference, whose
    fused seeds are rounded to the state dtype as K2's are, then the
    combine x = (h - b curr) 2 a_inv - prev and acc += c x. Returns x as an
    (re, im) BlockVec pair, before the term's one rounding."""
    a_inv, b, c_r, c_i = scal
    x = tuple(BlockVec([(h - b * t.float()) * (2.0 * a_inv) - v.float()
                        for h, t, v in zip(
                            apply_H_sector_kron_fused_reference(
                                list(P.leaves), layout, tables, calls, fused),
                            P.leaves, V.leaves)])
              for P, V in zip(pair_curr, pair_prev))
    for ar, ai, xr, xi in zip(acc[0].leaves, acc[1].leaves, x[0].leaves,
                              x[1].leaves):
        ar.add_(c_r * xr).sub_(c_i * xi)
        ai.add_(c_i * xr).add_(c_r * xi)
    return x


def cheb_scan_terms_fused(layout: SectorKronLayout, tables, calls, pair_prev,
                          pair_curr, acc, coeffs_tail, ab, top_k: int):
    """Run the Chebyshev terms k = 2..n-1 through K2 (port of
    pallas_cheb.cheb_scan_terms_fused).

    tables / calls: a KronHamiltonian's plain-apply tables and per-group
    calls; pair_prev / pair_curr: (re, im) BlockVec pairs (phi_0, phi_1);
    acc: the (acc_re, acc_im) float32 BlockVec pair already holding the
    k = 0, 1 contributions, updated in place (the JAX kernel's in->out
    alias) and returned; coeffs_tail: [n-2, 2] (c_r, c_i) rows; ab =
    (1/a, b) host floats; top_k: the number of K2-fused groups (the rest
    are the tail).

    From the second term on, each term writes phi_k over phi_{k-2}'s
    storage, so the recurrence lives in pair_curr's storage and one new
    pair: pair_prev (the caller's state) is left untouched, pair_curr is
    overwritten. A step then holds 8 state-sized vectors (state, two
    recurrence pairs, acc) where fresh outputs would hold 10-12."""
    fused = fused_group_set(layout, top_k)
    a_inv, b = ab
    prev, curr = pair_prev, pair_curr
    for k, (cr, ci) in enumerate(coeffs_tail):
        nxt = cheb_term_fused(layout, tables, calls, fused, prev, curr, acc,
                              (a_inv, b, float(cr), float(ci)),
                              reuse_prev=k > 0)
        prev, curr = curr, nxt
    return acc
