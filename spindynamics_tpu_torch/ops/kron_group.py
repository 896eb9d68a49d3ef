"""K1: the fused sector_kron group apply, and the H apply built on it (port of
spindynamics_tpu/ops/pallas_kron.py).

For each fused group one kernel launch computes every hi-local term of the
group (the factored diagonal, T@W_lo, W_mid^T@T and the lo|mid cross terms)
plus, when `fuse_crossh`, the mid|hi run x run cross terms as shifted-row
slice adds. The W_hi contraction (and any mid|hi term that is not fused)
is computed in plain torch as the kernel's SEED; the tail groups (too small
to fuse) run the plain blocks-mode apply. This is the JAX package's design.

The `crossw` variant serves the sharded apply
(parallel/sharded_kron_scaling.py), where a launch covers one shard's LOCAL
hi block [b, cmp, clp]: the mid|hi source rows live on other shards, so
each term arrives as a WINDOW [b, cmp_s, clp], the source rows already
shifted onto the output's rows and zero elsewhere, and the kernel adds
`val * win[h, ra0 + m - ca0, l]` for every mid run that holds m: no hi
shift, no mask.

The kernel is CUDA C++ (`csrc/kron_group.cu`, with the tile code it shares
with K2 in `csrc/kron_tile.cuh`), built with nvcc for sm_90a on first use
into `build/spindynamics_tpu_torch/` of the checkout (`ops/cuda_build.py`)
and loaded with ctypes. `kron_group_apply_reference` is its plain torch version: the
wrapper `kron_group_apply` uses it for tensors on the CPU and only there; a
CUDA tensor launches the kernel or raises.

Each K segment of the kernel's tile (T@W_lo, W_mid^T@T, each lo|mid cross
term) takes the route its table allows, decided here once per group when
the plans are built (`bf16_exact`, the TPU kernel's `_bf16_exact`): a table
that is exactly bf16 is handed to the kernel as a bf16 copy with a flag in
the descriptor, and the segment runs on the tensor cores with the TPU
kernel's hi/lo split of the state; any other table stays float32 and the
segment runs float32 FMAs.

States are float32 or bfloat16 (the JAX package's `state_dtype=bfloat16`
amplitude mode): with bfloat16 leaves the state, the seed and the cross
sources are bfloat16 in memory, the tables stay float32, every sum is taken
in float32 and each output is rounded once. The state dtype is the leaves',
not the module's: one KronHamiltonian (float32 tables) serves both.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from ..solvers.blockvec import BlockVec
from ..utils.device import resolve_device
from ..utils.dtypes import lift_bf16
from .cuda_build import CSRC, build_shared_library
from .sector_kron import (
    SectorKronLayout,
    _as_tensor,
    _contract,
    apply_H_sector_kron,
    default_fused_topk,
    kron_tables,
)

__all__ = [
    "KronHamiltonian",
    "bf16_exact",
    "apply_H_sector_kron_fused",
    "apply_H_sector_kron_fused_reference",
    "fused_group_plans",
    "fused_group_set",
    "kron_group_apply",
    "kron_group_apply_reference",
    "kernel_launch_count",
    "reset_kernel_launch_count",
    "build_kernel",
]


# ---------------------------------------------------------------------------
# host-side fusion plans (numpy, verbatim from the JAX package)
# ---------------------------------------------------------------------------


def bf16_exact(M) -> bool:
    """True when every entry of M, as float32, is exactly a bfloat16 (dyadic
    couplings like 1.0 and 0.5 are): the segment of that table runs on the
    tensor cores with the hi/lo state split, at float32 grade."""
    M32 = torch.as_tensor(np.asarray(M, np.float32))
    return bool(torch.equal(M32.to(torch.bfloat16).float(), M32))


class _GroupPlan:
    """Static per-group fusion plan (host side)."""

    def __init__(self, gi, D1, D2, D3, W_lo, W_mid_T, cross, unsupported,
                 crossh=(), crossh_fusable=False):
        self.gi = gi
        self.D1 = D1        # [cmp, clp] or None
        self.D2 = D2        # [ch, cmp] or None
        self.D3 = D3        # [ch, clp] or None
        self.W_lo = W_lo    # [clp, clp] or None
        self.W_mid_T = W_mid_T  # [cmp, cmp] (transposed) or None
        # cross: [(g_src, r0, c0, ln, val, A_lo[clp_s, clp])]
        self.cross = cross
        # cross_meta entries the kernel cannot fuse (multi-run local factor
        # or both-matmul local term): applied by _unsupported_terms
        self.unsupported = unsupported
        # crossh: mid|hi run x run terms [(g_src, rb0, cb0, lnb,
        # ((ra0, ca0, lna, val), ...))]; crossh_fusable: every hi-axis cross
        # entry of this group took this form
        self.crossh = crossh
        self.crossh_fusable = crossh_fusable
        # per K segment, the table is exactly bfloat16 (the TPU kernel's
        # `exact`, pallas_kron.py:530-532): (W_lo, W_mid, (A per cross))
        self.exact = (W_lo is not None and bf16_exact(W_lo),
                      W_mid_T is not None and bf16_exact(W_mid_T),
                      tuple(bf16_exact(c[5]) for c in cross))


def fused_group_plans(layout: SectorKronLayout):
    """Build (and cache on the layout) per-group fusion plans."""
    plans = layout.__dict__.get("_fused_plans")
    if plans is not None:
        return plans
    plans = []
    for gi, (k_h, k_m, k_l, ch, cm, cl, cmp, clp) in enumerate(layout.groups):
        kp = (k_l, k_m, k_h)
        # ---- combined 2-D diagonal factors --------------------------------
        d_l = layout.diag_vecs[0].get(k_l)
        d_m = layout.diag_vecs[1].get(k_m)
        d_h = layout.diag_vecs[2].get(k_h)
        D1 = np.zeros((cmp, clp))
        D2 = np.zeros((ch, cmp))
        D3 = None
        if d_l is not None:
            D1 = D1 + np.asarray(d_l)[None, :]
        if d_m is not None:
            D1 = D1 + np.asarray(d_m)[:, None]
        if d_h is not None:
            D2 = D2 + np.asarray(d_h)[:, None]
        for (pa, pb, va, vb) in layout.diag_cross:
            a = np.asarray(va[kp[pa]])
            b = np.asarray(vb[kp[pb]])
            if (pa, pb) == (0, 1):
                D1 = D1 + b[:, None] * a[None, :]
            elif (pa, pb) == (1, 2):
                D2 = D2 + b[:, None] * a[None, :]
            elif (pa, pb) == (0, 2):
                D3 = (np.zeros((ch, clp)) if D3 is None else D3)
                D3 = D3 + b[:, None] * a[None, :]
            else:  # pragma: no cover - parts are ordered pa < pb
                raise AssertionError((pa, pb))
        if not np.any(D1):
            D1 = None
        if not np.any(D2):
            D2 = None
        # ---- within-part operators ----------------------------------------
        W_lo = layout.W[0].get(k_l)
        W_mid = layout.W[1].get(k_m)
        W_mid_T = None if W_mid is None else np.ascontiguousarray(W_mid.T)
        # ---- hi-local cross terms ------------------------------------------
        cross = []
        unsupported = []
        for entry in layout.cross_meta[gi]:
            (g_src, pa, pb, a_key, b_key) = entry
            if 2 in (pa, pb):
                continue
            # supported pattern: single-run mid factor x lo matmul factor
            runs_a = layout.cross_runs.get(a_key)
            runs_b = layout.cross_runs.get(b_key)
            runs_mid, key_lo = ((runs_a, b_key) if pa == 1
                                else (runs_b, a_key))
            if (runs_mid is None or len(runs_mid) != 1
                    or key_lo in layout.cross_runs):
                unsupported.append(entry)
                continue
            (r0, c0, ln, val) = runs_mid[0]
            A = layout.cross_pool[key_lo]
            cross.append((g_src, r0, c0, ln, float(val), A))
        # ---- hi-axis cross terms: run x run slice adds ---------------------
        crossh = []
        crossh_fusable = True
        for entry in layout.cross_meta[gi]:
            (g_src, pa, pb, a_key, b_key) = entry
            if 2 not in (pa, pb):
                continue
            runs_a = layout.cross_runs.get(a_key)
            runs_b = layout.cross_runs.get(b_key)
            runs_mid, runs_hi = ((runs_a, runs_b) if (pa, pb) == (1, 2)
                                 else (runs_b, runs_a))
            if ((pa, pb) != (1, 2) or runs_mid is None or runs_hi is None
                    or len(runs_hi) != 1):
                crossh_fusable = False
                break
            (rb0, cb0, lnb, vb) = runs_hi[0]
            mids = tuple((ra0, ca0, lna, float(va * vb))
                         for (ra0, ca0, lna, va) in runs_mid)
            crossh.append((g_src, rb0, cb0, lnb, mids))
        if not crossh_fusable:
            crossh = []
        plans.append(_GroupPlan(gi, D1, D2, D3, W_lo, W_mid_T, cross,
                                unsupported, tuple(crossh), crossh_fusable))
    layout._fused_plans = plans
    return plans


def fused_group_set(layout: SectorKronLayout, top_k: int) -> frozenset:
    """Indices of the top_k LARGEST groups (ties: higher index first) — the
    groups the kernel computes; the rest form the plain-torch tail."""
    sizes = [(ch * cmp * clp, gi) for gi, (_, _, _, ch, _, _, cmp, clp)
             in enumerate(layout.groups)]
    return frozenset(gi for _, gi in sorted(sizes, reverse=True)[:top_k])


def fused_group_tables(layout: SectorKronLayout, dtype, device, memo=None,
                       hi_pad=None):
    """Per-group kernel tables as tensors: [{"D1", "D2", "D3", "W_lo",
    "W_mid_T": tensor | None, "A": [tensor per lo|mid cross term]}].
    `hi_pad` (per group) zero-pads the hi rows of D2 and D3 to that length:
    the sharded apply hands each shard its rows of the padded table."""
    memo = {} if memo is None else memo

    def conv(x, rows=None):
        if x is None:
            return None
        if rows is not None and rows != x.shape[0]:
            # a padded copy is a temporary: keep it out of the id-keyed memo
            return torch.as_tensor(
                np.pad(x, ((0, rows - x.shape[0]), (0, 0))), dtype=dtype,
                device=device)
        return _as_tensor(x, dtype, device, memo)

    return [{"D1": conv(p.D1),
             "D2": conv(p.D2, hi_pad and hi_pad[p.gi]),
             "D3": conv(p.D3, hi_pad and hi_pad[p.gi]),
             "W_lo": conv(p.W_lo), "W_mid_T": conv(p.W_mid_T),
             "A": [conv(c[5]) for c in p.cross]}
            for p in fused_group_plans(layout)]


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

# csrc/kron_tile.cuh KG_MAX_*
_MAX_CROSS, _MAX_CROSSH, _MAX_CROSSW, _MAX_MIDS = 16, 8, 8, 4
_TILE_M, _TILE_L = 8, 128  # K1 needs cmp % 8 == 0 and clp % 128 == 0
# KgDesc.state_type (csrc/kron_tile.cuh KG_STATE_*) per state dtype
_STATE_TYPES = {torch.float32: 0, torch.bfloat16: 1}


class _KgCross(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("A", ctypes.c_void_p),
                ("cmp_s", ctypes.c_int), ("clp_s", ctypes.c_int),
                ("r0", ctypes.c_int), ("c0", ctypes.c_int),
                ("ln", ctypes.c_int), ("val", ctypes.c_float),
                ("exact", ctypes.c_int)]


class _KgMid(ctypes.Structure):
    _fields_ = [("ra0", ctypes.c_int), ("ca0", ctypes.c_int),
                ("lna", ctypes.c_int), ("val", ctypes.c_float)]


class _KgCrossH(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p),
                ("ch_s", ctypes.c_int), ("cmp_s", ctypes.c_int),
                ("rb0", ctypes.c_int), ("cb0", ctypes.c_int),
                ("lnb", ctypes.c_int), ("n_mids", ctypes.c_int),
                ("mids", _KgMid * _MAX_MIDS)]


class _KgCrossW(ctypes.Structure):
    _fields_ = [("win", ctypes.c_void_p),
                ("cmp_s", ctypes.c_int), ("n_mids", ctypes.c_int),
                ("mids", _KgMid * _MAX_MIDS)]


class _KgDesc(ctypes.Structure):
    _fields_ = [("out", ctypes.c_void_p), ("T", ctypes.c_void_p),
                ("seed", ctypes.c_void_p), ("D1", ctypes.c_void_p),
                ("D2", ctypes.c_void_p), ("D3", ctypes.c_void_p),
                ("W_lo", ctypes.c_void_p), ("W_mid_T", ctypes.c_void_p),
                ("ch", ctypes.c_int), ("cmp", ctypes.c_int),
                ("clp", ctypes.c_int),
                ("n_cross", ctypes.c_int), ("n_crossh", ctypes.c_int),
                ("state_type", ctypes.c_int), ("n_crossw", ctypes.c_int),
                ("wlo_exact", ctypes.c_int), ("wmid_exact", ctypes.c_int),
                ("tile_rows", ctypes.c_int),
                ("cross", _KgCross * _MAX_CROSS),
                ("crossh", _KgCrossH * _MAX_CROSSH),
                ("crossw", _KgCrossW * _MAX_CROSSW)]


_SRC = CSRC / "kron_group.cu"
_HEADERS = (CSRC / "kron_tile.cuh",)
_LIB = None
# the launch counter of each state dtype's instance of the kernel, and of
# those launches, the crossw variant's (a launch that reads windows)
_COUNTER = {torch.float32: "launches.k1.float32",
            torch.bfloat16: "launches.k1.bfloat16"}
_CROSSW_COUNTER = {torch.float32: "launches.k1_crossw.float32",
                   torch.bfloat16: "launches.k1_crossw.bfloat16"}


def build_kernel() -> dict:
    """Compile K1 (once per source hash) and load it. Returns {"path",
    "seconds" (0 when the library was already built), "log" (nvcc's
    -Xptxas -v report: registers, shared memory, spills)}."""
    global _LIB
    info = build_shared_library(_SRC, _HEADERS, "K1")
    if _LIB is None or _LIB._name != info["path"]:
        lib = ctypes.CDLL(info["path"])
        lib.kg_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.kg_launch.restype = ctypes.c_int
        lib.kg_desc_size.argtypes = []
        lib.kg_desc_size.restype = ctypes.c_int
        if lib.kg_desc_size() != ctypes.sizeof(_KgDesc):
            raise RuntimeError(
                f"KgDesc layout mismatch: C {lib.kg_desc_size()} bytes, "
                f"ctypes {ctypes.sizeof(_KgDesc)}")
        _LIB = lib
    return info


def kernel_launch_count(dtype=None, crossw: bool = False) -> int:
    """Number of K1 launches since import (or the last reset): of the
    instance for states of `dtype` (torch.float32 or torch.bfloat16), or of
    both when None. `crossw=True` counts only the launches of the crossw
    variant (those that read windows). The counters
    `launches.k1.<dtype>` and `launches.k1_crossw.<dtype>`
    (utils/profiling.py)."""
    from ..utils.profiling import counters

    n = _CROSSW_COUNTER if crossw else _COUNTER
    c = counters()
    return sum(c.get(k, 0) for k in (n.values() if dtype is None
                                     else (n[dtype],)))


def reset_kernel_launch_count() -> None:
    from ..utils.profiling import reset_counters

    reset_counters("launches.k1", "launches.k1_crossw")


class _GroupCall:
    """Everything one fused group's kernel call needs besides the state:
    static offsets, the group's table tensors, and (on CUDA) the cached
    ctypes descriptor whose table pointers never change.

    The sharded apply makes one call per (group, shard): `rows` is the
    shard's local hi block size b (every group tensor of the launch then
    has b hi rows, and gt's D2/D3 are the shard's rows of the tables), and
    `windowed` delivers the mid|hi terms as windows (`crossw`) instead of
    shifted reads of the source groups (`crossh`)."""

    def __init__(self, layout, plan, gt, fuse_crossh, rows=None,
                 windowed=False, bf16_memo=None):
        k_h, _, _, ch, _, _, cmp, clp = layout.groups[plan.gi]
        self.gi = plan.gi
        self.exact = plan.exact
        # output-tile rows of the launch (32 or 64); 0: the kernel's rule
        self.tile_rows = 0
        # bfloat16 copies of the exact tables, shared between the calls of
        # one module (keyed by the float table's id)
        self._bf16 = {} if bf16_memo is None else bf16_memo
        self.shape = (ch if rows is None else rows, cmp, clp)
        self.D1, self.D2, self.D3 = gt["D1"], gt["D2"], gt["D3"]
        self.W_lo, self.W_mid_T = gt["W_lo"], gt["W_mid_T"]
        self.A = gt["A"]
        self.cross = [c[:5] for c in plan.cross]  # (g_src, r0, c0, ln, val)
        fused_h = fuse_crossh and plan.crossh_fusable
        self.crossh = list(plan.crossh) if fused_h and not windowed else []
        # crossw: per window (cmp_s, ((ra0, ca0, lna, val), ...))
        self.crossw = ([(layout.groups[c[0]][6], c[4]) for c in plan.crossh]
                       if fused_h and windowed else [])
        # the seed carries W_hi (and the mid|hi terms when not fused)
        self.has_seed = (k_h in layout.W[2]) if fused_h else True
        self.seed_terms = "hi" if fused_h else "hi,crossh"
        self.unsupported = plan.unsupported

        def shape_of(g, hi=None):
            (_, _, _, chs, _, _, cmps, clps) = layout.groups[g]
            return (chs if hi is None else hi, cmps, clps)

        # lo|mid sources share the hi axis (and so the shard's block size)
        self.cross_shapes = [shape_of(c[0], rows) for c in self.cross]
        self.crossh_shapes = [shape_of(c[0]) for c in self.crossh]
        self.crossw_shapes = [(self.shape[0], cmps, clp)
                              for (cmps, _) in self.crossw]
        self._desc = None
        self._desc_device = None
        # K2's descriptor (ops/cheb_term.py): a copy of this one plus the
        # second plane's pointers, built on K2's first launch
        self.term_desc = None

    def descriptor(self, device):
        if self._desc is not None:
            if device != self._desc_device:
                raise ValueError(f"state on {device}, K1 tables on "
                                 f"{self._desc_device}")
            return self._desc
        ch, cmp, clp = self.shape
        if cmp % _TILE_M or clp % _TILE_L or any(
                s[2] % _TILE_L for s in self.cross_shapes):
            raise ValueError(f"K1 and K2 need (8, 128) tile pads; group "
                             f"{self.gi} is {self.shape}")
        # lo|mid sources share the hi axis, mid|hi sources the lo axis
        if (any(s[0] != ch for s in self.cross_shapes)
                or any(s[2] != clp for s in self.crossh_shapes)):
            raise ValueError(f"group {self.gi}: cross source shapes "
                             "do not match the kernel's indexing")
        if (len(self.cross) > _MAX_CROSS or len(self.crossh) > _MAX_CROSSH
                or len(self.crossw) > _MAX_CROSSW
                or any(len(c[4]) > _MAX_MIDS for c in self.crossh)
                or any(len(c[1]) > _MAX_MIDS for c in self.crossw)):
            raise ValueError(f"group {self.gi} has more cross terms than K1 "
                             "takes (kron_tile.cuh KG_MAX_*)")
        d = _KgDesc()
        d.ch, d.cmp, d.clp = ch, cmp, clp
        d.tile_rows = self.tile_rows
        for name in ("D1", "D2", "D3", "W_lo", "W_mid_T"):
            t = getattr(self, name)
            if t is not None:
                _check_tensor(t, t.shape, device, f"table {name}")
                setattr(d, name, t.data_ptr())
        # an exact table's segment reads its bfloat16 copy (tensor cores)
        e_lo, e_mid, e_cross = self.exact
        d.wlo_exact, d.wmid_exact = int(e_lo), int(e_mid)
        if e_lo:
            d.W_lo = self._bf16_copy(self.W_lo).data_ptr()
        if e_mid:
            d.W_mid_T = self._bf16_copy(self.W_mid_T).data_ptr()
        d.n_cross = len(self.cross)
        for i, ((_, r0, c0, ln, val), A, (_, cmps, clps), ex) in enumerate(
                zip(self.cross, self.A, self.cross_shapes, e_cross)):
            _check_tensor(A, (clps, clp), device, "table A")
            e = d.cross[i]
            e.A = (self._bf16_copy(A) if ex else A).data_ptr()
            e.exact = int(ex)
            e.cmp_s, e.clp_s = cmps, clps
            e.r0, e.c0, e.ln, e.val = r0, c0, ln, val
        d.n_crossh = len(self.crossh)
        for i, ((_, rb0, cb0, lnb, mids), (chs, cmps, _)) in enumerate(
                zip(self.crossh, self.crossh_shapes)):
            e = d.crossh[i]
            e.ch_s, e.cmp_s = chs, cmps
            e.rb0, e.cb0, e.lnb, e.n_mids = rb0, cb0, lnb, len(mids)
            for k, (ra0, ca0, lna, val) in enumerate(mids):
                e.mids[k].ra0, e.mids[k].ca0 = ra0, ca0
                e.mids[k].lna, e.mids[k].val = lna, val
        d.n_crossw = len(self.crossw)
        for i, (cmps, mids) in enumerate(self.crossw):
            e = d.crossw[i]
            e.cmp_s, e.n_mids = cmps, len(mids)
            for k, (ra0, ca0, lna, val) in enumerate(mids):
                e.mids[k].ra0, e.mids[k].ca0 = ra0, ca0
                e.mids[k].lna, e.mids[k].val = lna, val
        self._desc, self._desc_device = d, device
        return d

    def _bf16_copy(self, t):
        """The bfloat16 copy of an exact float table (made once)."""
        key = id(t)
        if key not in self._bf16:
            self._bf16[key] = (t, t.to(torch.bfloat16).contiguous())
        return self._bf16[key][1]


def _state_type(T, kernel="K1") -> int:
    """KgDesc.state_type of a launch whose state is T."""
    if T.dtype not in _STATE_TYPES:
        raise TypeError(f"{kernel} state: dtype {T.dtype}; {kernel} takes "
                        "float32 or bfloat16 states")
    return _STATE_TYPES[T.dtype]


def _check_tensor(x, shape, device, what, kernel="K1", dtype=torch.float32):
    """The kernels' input contract. `dtype` is float32 for tables and
    accumulators and the launch's state dtype for every state tensor, so
    all state tensors of one launch have one dtype."""
    if x.device != device:
        raise ValueError(f"{kernel} {what}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{kernel} {what}: dtype {x.dtype}, expected "
                        f"{dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{kernel} {what}: shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{kernel} {what}: must be contiguous and 16-byte "
                         "aligned")


def kron_group_apply(T, seed, srcs, srcsh, call: _GroupCall, wins=(),
                     out=None):
    """One fused group: K1 on a CUDA tensor, its plain version on a CPU
    tensor. T [ch, cmp, clp], float32 or bfloat16; seed same shape and
    dtype or None; srcs / srcsh the source groups of the lo|mid / mid|hi
    cross terms, in `call`'s order and T's dtype; wins the windows of a
    windowed call (the crossw variant), [ch, cmp_s, clp] each, T's dtype.
    `out` (T's shape and dtype, e.g. one shard's rows of a whole leaf) is
    written when given. Returns the output, in T's dtype."""
    if T.device.type == "cpu":
        res = kron_group_apply_reference(T, seed, srcs, srcsh, call, wins)
        return res if out is None else out.copy_(res)
    if T.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors; got {T.device}")
    from ..utils.profiling import count

    dev = T.device
    if (len(srcs) != len(call.cross) or len(srcsh) != len(call.crossh)
            or len(wins) != len(call.crossw)):
        raise ValueError(f"group {call.gi}: expected {len(call.cross)} + "
                         f"{len(call.crossh)} source groups and "
                         f"{len(call.crossw)} windows")
    state_type = _state_type(T)
    _check_tensor(T, call.shape, dev, "state", dtype=T.dtype)
    if seed is not None:
        _check_tensor(seed, call.shape, dev, "seed", dtype=T.dtype)
    for S, shp in zip(srcs, call.cross_shapes):
        _check_tensor(S, shp, dev, "lo|mid source", dtype=T.dtype)
    for S, shp in zip(srcsh, call.crossh_shapes):
        _check_tensor(S, shp, dev, "mid|hi source", dtype=T.dtype)
    for S, shp in zip(wins, call.crossw_shapes):
        _check_tensor(S, shp, dev, "mid|hi window", dtype=T.dtype)
    if out is None:
        out = torch.empty_like(T)
    else:
        _check_tensor(out, call.shape, dev, "output", dtype=T.dtype)
    if _LIB is None:
        build_kernel()
    d = call.descriptor(dev)
    d.state_type = state_type
    d.out, d.T = out.data_ptr(), T.data_ptr()
    d.seed = None if seed is None else seed.data_ptr()
    for i, S in enumerate(srcs):
        d.cross[i].src = S.data_ptr()
    for i, S in enumerate(srcsh):
        d.crossh[i].src = S.data_ptr()
    for i, S in enumerate(wins):
        d.crossw[i].win = S.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _LIB.kg_launch(ctypes.byref(d), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"K1 launch failed for group {call.gi}: "
                           f"cudaError {err}")
    count(_COUNTER[T.dtype])
    if wins:
        count(_CROSSW_COUNTER[T.dtype])
    return out


def kron_group_apply_reference(T, seed, srcs, srcsh, call: _GroupCall,
                               wins=()):
    """Plain torch version of K1 (same arguments, same output), in the
    state's dtype (float32 or float64). bfloat16 inputs are lifted to
    float32, summed there and rounded once, as the kernel does; the value
    before that rounding is this function on the lifted inputs."""
    if T.dtype == torch.bfloat16:
        return kron_group_apply_reference(
            lift_bf16(T), None if seed is None else lift_bf16(seed),
            [lift_bf16(S) for S in srcs], [lift_bf16(S) for S in srcsh],
            call, [lift_bf16(S) for S in wins]).to(torch.bfloat16)
    dt = T.dtype
    out = torch.zeros_like(T) if seed is None else seed.clone()
    d = None
    for t in (None if call.D1 is None else call.D1.to(dt)[None],
              None if call.D2 is None else call.D2.to(dt)[:, :, None],
              None if call.D3 is None else call.D3.to(dt)[:, None, :]):
        if t is not None:
            d = t if d is None else d + t
    if d is not None:
        out += T * d
    if call.W_lo is not None:
        out += torch.matmul(T, call.W_lo.to(dt))
    if call.W_mid_T is not None:
        out += torch.matmul(call.W_mid_T.to(dt), T)
    for S, (_, r0, c0, ln, val), A in zip(srcs, call.cross, call.A):
        out[:, c0:c0 + ln] += val * torch.matmul(S[:, r0:r0 + ln], A.to(dt))
    for S, (_, rb0, cb0, lnb, mids) in zip(srcsh, call.crossh):
        for (ra0, ca0, lna, val) in mids:
            out[cb0:cb0 + lnb, ca0:ca0 + lna] += (
                val * S[rb0:rb0 + lnb, ra0:ra0 + lna])
    for W, (_, mids) in zip(wins, call.crossw):
        for (ra0, ca0, lna, val) in mids:
            out[:, ca0:ca0 + lna] += val * W[:, ra0:ra0 + lna]
    return out


# ---------------------------------------------------------------------------
# the H apply
# ---------------------------------------------------------------------------


def _group_calls(layout, group_tables, fuse_crossh):
    from ..utils.profiling import count

    count("build.k1_descriptors")
    memo = {}
    return [_GroupCall(layout, plan, gt, fuse_crossh, bf16_memo=memo)
            for plan, gt in zip(fused_group_plans(layout), group_tables)]


def apply_H_sector_kron_fused(blocks, layout: SectorKronLayout, tables,
                              calls, top_k: int | None = None, axpy=None):
    """H|psi> on BlockVec leaves: K1 for the hi-local (and the fused mid|hi)
    terms of the top_k largest groups, plain torch for the W_hi seed and the
    tail groups.

    tables / calls: the plain-apply tables and the per-group kernel calls,
    both owned by a KronHamiltonian (its `tables` and `calls`; the calls
    carry its `fuse_crossh`).
    top_k: number of fused groups (default `default_fused_topk`).
    axpy=(s, blocks0): return H psi + s * psi0, with s * psi0 folded into
    each fused group's kernel seed. Kept from the JAX package, where it cut
    the Lanczos recurrence's peak from 4 to ~3 live vectors to fit L=32 on a
    16 GB chip; on 80 GB it stays for parity.

    bfloat16 leaves come back bfloat16: the seed, the tail and the
    unsupported entries are computed from the lifted leaves in float32 (the
    plain apply lifts) and rounded where the JAX package rounds them: each
    seed once, the axpy fold included, and each tail output once."""
    if top_k is None:
        top_k = default_fused_topk(layout)
    fused = fused_group_set(layout, top_k)
    tail = frozenset(range(len(layout.groups))) - fused
    blocks = list(blocks)
    sdt = blocks[0].dtype

    # tail groups (small): both term halves through the plain apply, each
    # tail leaf and cross source lifted once for both
    if tail:
        lifted = {}
        hi_tail = apply_H_sector_kron(blocks, None, layout, tables,
                                      terms="hi,crossh", group_filter=tail,
                                      lifted=lifted)
        tail_out = apply_H_sector_kron(blocks, None, layout, tables,
                                       terms="diag,lo,mid,crossl",
                                       group_filter=tail, lifted=lifted)
        del lifted
    outs = []
    for gi in range(len(layout.groups)):
        if gi in tail:
            if axpy is None:
                outs.append(round_sum(tail_out[gi], hi_tail[gi], sdt))
            else:
                outs.append(round_sum(tail_out[gi] + hi_tail[gi],
                                      axpy[0] * lift_bf16(axpy[1][gi]), sdt))
            continue
        call = calls[gi]
        # seed per group, so each is freed once its kernel has consumed it
        seed = group_seed(blocks, layout, tables, call,
                          None if axpy is None
                          else axpy[0] * lift_bf16(axpy[1][gi]), sdt)
        outs.append(kron_group_apply(
            blocks[gi], seed, [blocks[c[0]] for c in call.cross],
            [blocks[c[0]] for c in call.crossh], call))

    # rare unsupported local terms of fused groups (the tail already applied
    # its full crossl set)
    extra_calls = [calls[gi] for gi in sorted(fused) if calls[gi].unsupported]
    if extra_calls:
        extra = _unsupported_terms(blocks, layout, tables, extra_calls)
        outs = [o if e is None else round_sum(o, e, sdt)
                for o, e in zip(outs, extra)]
    return outs


def apply_H_sector_kron_fused_reference(blocks, layout: SectorKronLayout,
                                        tables, calls, fused) -> list:
    """The plain version of apply_H_sector_kron_fused (no axpy; K1 for the
    groups in `fused`) in float32, before the apply's one rounding of each
    output: the other groups through the plain apply and each fused group
    through K1's plain version, every sum on float32 copies of the leaves,
    and each fused group's seed stored in the leaves' dtype as the apply
    stores it (group_seed). For bfloat16 leaves the seed's rounding is part
    of the function, so an output is one rounding from this value, where
    the float32 apply of the same leaves is two."""
    sdt = blocks[0].dtype
    f32 = [x.float() for x in blocks]
    tail = frozenset(range(len(layout.groups))) - fused
    out = (apply_H_sector_kron(f32, None, layout, tables, group_filter=tail)
           if tail else [None] * len(blocks))
    for gi in sorted(fused):
        c = calls[gi]
        if c.unsupported:
            raise NotImplementedError("unsupported fused entries are added "
                                      "after the kernel's rounding")
        seed = group_seed(blocks, layout, tables, c, None, sdt)
        out[gi] = kron_group_apply_reference(
            f32[gi], None if seed is None else seed.float(),
            [f32[x[0]] for x in c.cross], [f32[x[0]] for x in c.crossh], c)
    return out


def round_sum(a, b, dtype):
    """a + b (b may be None) rounded once to `dtype`: the add writes the
    `dtype` tensor itself. torch computes it in the inputs' promoted type
    (a bfloat16 `a` beside a float32 `b` is read as float32) and rounds to
    the output's, the same round-to-nearest as .to(dtype)."""
    if b is None:
        return a.to(dtype)
    return torch.add(a, b, out=torch.empty_like(b, dtype=dtype))


def group_seed(blocks, layout, tables, call, extra, sdt):
    """The seed of one fused group's launch on one plane: the plain
    apply's `call.seed_terms` (W_hi, and the mid|hi terms when the kernel
    does not fuse them) plus `extra` (a float32 tensor, or None), rounded
    once to `sdt`; None when the group has neither. The sums are float32
    on lifted bfloat16 leaves.

    A W_hi-only seed is the plain apply's 0 + T W_hi made in one product
    and one add: the zero is added by that add (0 + x and x + 0 are the
    same float) or, with `extra`, in place before the add of `extra`; the
    last add writes the `sdt` seed."""
    gi = call.gi
    if not call.has_seed:
        return None if extra is None else extra.to(sdt)
    if call.seed_terms != "hi":
        seed = apply_H_sector_kron(blocks, None, layout, tables,
                                   terms=call.seed_terms,
                                   group_filter=(gi,))[gi]
        return round_sum(seed, extra, sdt)
    X = _contract(lift_bf16(blocks[gi]),
                  tables["W"][2][layout.groups[gi][0]], 2)
    if extra is None:
        return torch.add(X, 0.0, out=torch.empty_like(X, dtype=sdt))
    return round_sum(X.add_(0.0), extra, sdt)


def _unsupported_terms(blocks, layout, tables, calls):
    """The cross_meta entries K1 cannot fuse, through the generic
    contraction path (port of pallas_kron._xla_unsupported). bfloat16
    blocks are lifted: the result is float32."""
    outs = [None] * len(layout.groups)
    for call in calls:
        for (g_src, pa, pb, a_key, b_key) in call.unsupported:
            T = lift_bf16(blocks[g_src])
            runs_a = layout.cross_runs.get(a_key)
            runs_b = layout.cross_runs.get(b_key)
            acc = outs[call.gi]
            if runs_a is not None or runs_b is not None:
                runs, pr = (runs_a, pa) if runs_a is not None else (runs_b, pb)
                m_key, pm = (b_key, pb) if runs_a is not None else (a_key, pa)
                M = tables["cross"][m_key]
                if pr != 1:
                    raise NotImplementedError(
                        f"run-form cross factor on axis {pr} among the "
                        "unsupported fused entries")
                base = torch.zeros_like(blocks[call.gi], dtype=T.dtype)
                for (r0, c0, ln, val) in runs:
                    X = _contract(T[:, r0:r0 + ln], M, pm)
                    if val != 1.0:
                        X = val * X
                    base[:, c0:c0 + ln] += X
                acc = base if acc is None else acc + base
            else:
                X = _contract(T, tables["cross"][a_key], pa)
                X = _contract(X, tables["cross"][b_key], pb)
                acc = X if acc is None else acc + X
            outs[call.gi] = acc
    return outs


# ---------------------------------------------------------------------------
# nn.Module form
# ---------------------------------------------------------------------------


class _Buf(str):
    """Name of a registered buffer inside a table skeleton."""


def _to_skeleton(module, tree, names):
    if isinstance(tree, torch.Tensor):
        name = names.get(id(tree))
        if name is None:
            name = f"table_{len(names)}"
            module.register_buffer(name, tree, persistent=False)
            names[id(tree)] = name
        return _Buf(name)
    if isinstance(tree, dict):
        return {k: _to_skeleton(module, v, names) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_skeleton(module, v, names) for v in tree)
    return tree


def _from_skeleton(module, skel):
    if isinstance(skel, _Buf):
        return getattr(module, skel)
    if isinstance(skel, dict):
        return {k: _from_skeleton(module, v) for k, v in skel.items()}
    if isinstance(skel, (list, tuple)):
        return type(skel)(_from_skeleton(module, v) for v in skel)
    return skel


class KronHamiltonian(nn.Module):
    """H on BlockVec states of one SectorKronLayout.

    The layout's tables are registered buffers (non-persistent: they are
    derived from the layout), so `.to(device)` moves them. Routing is fixed
    at construction: `fused` (K1 for the top_k largest groups, else the
    plain blocks apply), `top_k` and `fuse_crossh` are fields, not
    environment reads. `device` defaults to the card (pass device="cpu" for
    a CPU module). forward(bv, s=None, bv0=None) returns H bv (+ s bv0: the
    Lanczos axpy, folded into the kernel seed when fused), in bv's dtype:
    a float32 module also takes bfloat16 states (float32 sums, one rounding
    per output; K1's bfloat16 instance when fused). forward(bv, groups=...)
    computes those groups' outputs alone (None elsewhere) through the plain
    apply: the bucketed Ritz finalize of the ground-state solve asks for
    H psi a few groups at a time. `shard` and `to_mesh` are what the
    sharded module (parallel.ShardedKronHamiltonian) answers with its spec
    and mesh: no sharding here. `tables` (the plain apply's tables of
    `layout` on `device`, ops/sector_kron.kron_tables) are taken as they
    are instead of built."""

    shard = None  # the `shard=` argument of the BlockVec state constructors

    def __init__(self, layout: SectorKronLayout, dtype=torch.float32,
                 device=None, fused: bool = True, top_k: int | None = None,
                 fuse_crossh: bool = True, tables: dict | None = None):
        super().__init__()
        device = resolve_device(device)
        self.layout = layout
        self.fused = fused
        self.top_k = default_fused_topk(layout) if top_k is None else top_k
        self.fuse_crossh = fuse_crossh
        # the Lanczos solvers fold -beta v_prev into the apply when set
        self.supports_axpy = fused
        memo = {}
        tree = {"tables": (kron_tables(layout, dtype, device, memo)
                           if tables is None else tables),
                "groups": (fused_group_tables(layout, dtype, device, memo)
                           if fused else [])}
        self.register_buffer("_anchor", torch.empty(0, dtype=dtype,
                                                    device=device),
                             persistent=False)
        self._skeleton = _to_skeleton(self, tree, {})
        self._resolved = None

    def _apply(self, fn, recurse=True):
        self._resolved = None  # tensors move: rebuild tables and descriptors
        return super()._apply(fn, recurse)

    @property
    def dtype(self):
        return self._anchor.dtype

    @property
    def device(self):
        return self._anchor.device

    def _state(self):
        if self._resolved is None:
            tree = _from_skeleton(self, self._skeleton)
            calls = (_group_calls(self.layout, tree["groups"],
                                  self.fuse_crossh) if self.fused else None)
            self._resolved = (tree["tables"], calls)
        return self._resolved

    @property
    def tables(self) -> dict:
        """The plain-apply tables (kron_tables layout) on this device."""
        return self._state()[0]

    @property
    def calls(self) -> list | None:
        """Per-group K1 calls (tables + cached descriptors), or None when
        not fused."""
        return self._state()[1]

    def to_mesh(self, bv: BlockVec) -> BlockVec:
        return bv

    def forward(self, bv: BlockVec, s=None, bv0: BlockVec | None = None,
                groups=None) -> BlockVec:
        """One apply, in the span and counter of its route (`apply.k1`,
        `apply.plain` or `apply.groups`, utils/profiling.py)."""
        from ..utils.profiling import annotate, count

        route = ("groups" if groups is not None
                 else "k1" if self.fused else "plain")
        count("applies." + route)
        with annotate("apply." + route):
            return self._forward(bv, s, bv0, groups)

    def _forward(self, bv, s, bv0, groups) -> BlockVec:
        tables, calls = self._state()
        if groups is not None:
            out = apply_H_sector_kron(bv.leaves, None, self.layout, tables,
                                      group_filter=groups)
            return BlockVec([o if o is None else o.to(bv.dtype)
                             for o in out])
        if self.fused:
            axpy = None if s is None else (s, list(bv0.leaves))
            return BlockVec(apply_H_sector_kron_fused(
                bv.leaves, self.layout, tables, calls, top_k=self.top_k,
                axpy=axpy))
        out = apply_H_sector_kron(bv.leaves, None, self.layout, tables)
        if s is not None:
            out = [o + s * lift_bf16(x) for o, x in zip(out, bv0.leaves)]
        return BlockVec([o.to(bv.dtype) for o in out])
