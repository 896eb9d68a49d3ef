"""The solvers' compensated inner product as one CUDA kernel: the sum over
a list of leaf pairs of x_l . y_l in one launch and one read.

The kernel (`csrc/dot2.cu`) forms each product of two float32 or bfloat16
values exactly in float64, sums in float64 and rounds once to float32 (a
float64 call stays in float64): at least as accurate as Dot2's
sum(e) + sum(p) in float32, and deterministic (a fixed grid, a fixed
element-to-thread map, fixed reduction trees, no float atomics), so two
calls on the same inputs give the same bits. It is built with nvcc for
sm_90a on first use (`ops/cuda_build.py`) and loaded with ctypes.

`describe` builds the ctypes leaf tables a call passes to the kernel (one
per D2_MAX_LEAVES leaves) without launching anything, so a host emulation
can read them from CPU tensors (tests/_dot2_emulation.py). The wrapper that
chooses between this kernel and the plain version is
`utils/compensated.dot2_leaves`: this module only launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .cuda_build import CSRC, build_shared_library

__all__ = [
    "MAX_LEAVES",
    "BLOCK",
    "UNROLL",
    "TILE",
    "leaf_tiles",
    "BLOCKS_PER_SM",
    "Dot2Call",
    "describe",
    "dot2_launch",
    "build_kernel",
    "dot2_launch_count",
    "reset_dot2_launch_count",
]

# csrc/dot2.cu: D2_MAX_LEAVES, D2_BLOCK, the flags and the meta bits
MAX_LEAVES = 112
BLOCK = 256
UNROLL = 4
TILE = UNROLL * BLOCK  # items (16-byte vectors, or elements) per tile
BLOCKS_PER_SM = 4
H100_SMS = 132  # the grid `describe` plans for when no card is asked
F_FIRST, F_LAST, F_F64 = 1, 2, 4
M_XBF16, M_YBF16, M_SAME, M_VEC = 1 << 4, 1 << 5, 1 << 6, 1 << 7
VEC_ELEMS = {torch.float32: 4, torch.bfloat16: 8, torch.float64: 2}


class _Dot2Desc(ctypes.Structure):
    _fields_ = [("out", ctypes.c_uint64), ("partials", ctypes.c_uint64),
                ("acc", ctypes.c_uint64), ("counter", ctypes.c_uint64),
                ("n_tiles", ctypes.c_longlong),
                ("n_leaves", ctypes.c_int), ("grid", ctypes.c_int),
                ("flags", ctypes.c_int), ("pad", ctypes.c_int),
                ("x", ctypes.c_uint64 * MAX_LEAVES),
                ("y", ctypes.c_uint64 * MAX_LEAVES),
                ("n", ctypes.c_longlong * MAX_LEAVES),
                ("tile0", ctypes.c_longlong * MAX_LEAVES),
                ("meta", ctypes.c_uint * MAX_LEAVES)]


class Dot2Call(NamedTuple):
    descs: list        # one _Dot2Desc per launch, in launch order
    leaves: list       # (x, x stride, y, y stride, numel) the tables read
    grid: int
    f64: bool          # float64 elements and result


def _flat(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(t, 1) for a contiguous t; else a 1-D view of stride 1 or 2 (a .real
    / .imag plane) and its stride; any other tensor (not evenly strided,
    stride 0 or wider) is copied contiguous."""
    if t.is_contiguous():
        return t, 1
    f = t.reshape(-1)
    if f.numel() > 1 and f.stride(0) not in (1, 2):
        f = f.contiguous()
    return f, (f.stride(0) if f.numel() > 1 else 1)


def leaf_tiles(n: int, vec_elems: int) -> tuple[int, int]:
    """(vector tiles, scalar tiles) of a leaf of n elements: TILE 16-byte
    vectors of vec_elems each (0: off the vector route), then TILE single
    elements a tile for the rest."""
    if not vec_elems:
        return 0, -(-n // TILE)
    nv = n // vec_elems
    return -(-nv // TILE), -(-(n - nv * vec_elems) // TILE)


def describe(xs, ys, n_sm: int = H100_SMS) -> Dot2Call:
    """The leaf tables of sum_l xs[l] . ys[l] on a grid of BLOCKS_PER_SM x
    n_sm blocks, without a launch (the pointers may be CPU addresses).
    Leaves are float32, bfloat16 or float64 tensors of any shape, each pair
    of equal numel; if any leaf is float64 every leaf is read as float64.
    The tables' out / workspace pointers are left 0 for the launch."""
    xs, ys = list(xs), list(ys)
    if not xs or len(xs) != len(ys):
        raise ValueError(f"dot2: {len(xs)} x leaves, {len(ys)} y leaves")
    for t in (*xs, *ys):
        if t.dtype not in VEC_ELEMS:
            raise TypeError(f"dot2 takes float32, bfloat16 or float64 "
                            f"leaves, not {t.dtype} (complex: vdot2)")
    f64 = any(t.dtype == torch.float64 for t in (*xs, *ys))
    pairs = []  # (x, x stride, y, y stride, numel)
    for a, b in zip(xs, ys):
        n = a.numel()
        if n != b.numel():
            raise ValueError(f"dot2: leaf sizes {n} != {b.numel()}")
        fa, sa = _flat(a.double() if f64 else a)
        fb, sb = (fa, sa) if b is a else _flat(b.double() if f64 else b)
        pairs.append((fa, sa, fb, sb, n))
    grid = BLOCKS_PER_SM * n_sm
    descs = []
    for c0 in range(0, len(pairs), MAX_LEAVES):
        chunk = pairs[c0:c0 + MAX_LEAVES]
        d = _Dot2Desc()
        d.n_leaves, d.grid = len(chunk), grid
        d.flags = ((F_FIRST if c0 == 0 else 0)
                   | (F_LAST if c0 + MAX_LEAVES >= len(pairs) else 0)
                   | (F_F64 if f64 else 0))
        xp, yp, ns, meta, tile0 = [], [], [], [], []
        n_tiles = 0
        for fa, sa, fb, sb, n in chunk:
            pa, pb = fa.data_ptr(), fb.data_ptr()
            ta, tb = fa.dtype, fb.dtype
            m = sa | sb << 2
            if ta is torch.bfloat16:
                m |= M_XBF16
            if tb is torch.bfloat16:
                m |= M_YBF16
            if fb is fa or (pa == pb and sa == sb and ta is tb):
                m |= M_SAME
            v = 0
            if ta is tb and sa == sb == 1 and not (pa | pb) & 15:
                m |= M_VEC
                v = VEC_ELEMS[ta]
            tiles = sum(leaf_tiles(n, v))
            xp.append(pa)
            yp.append(pb)
            ns.append(n)
            tile0.append(n_tiles)
            meta.append(m)
            n_tiles += tiles
        k = len(chunk)
        d.n_tiles = n_tiles
        np.ctypeslib.as_array(d.tile0)[:k] = tile0
        np.ctypeslib.as_array(d.x)[:k] = xp
        np.ctypeslib.as_array(d.y)[:k] = yp
        np.ctypeslib.as_array(d.n)[:k] = ns
        np.ctypeslib.as_array(d.meta)[:k] = meta
        descs.append(d)
    return Dot2Call(descs, pairs, grid, f64)


_SRC = CSRC / "dot2.cu"
_LIB = None
_N_SM: dict = {}
_WORKSPACE: dict = {}


def build_kernel() -> dict:
    """Compile the dot2 kernel (once per source hash) and load it. Returns
    {"path", "seconds" (0 when the library was already built), "log"
    (nvcc's -Xptxas -v report)}."""
    global _LIB
    info = build_shared_library(_SRC, (), "dot2")
    if _LIB is None or _LIB._name != info["path"]:
        lib = ctypes.CDLL(info["path"])
        lib.dot2_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.dot2_launch.restype = ctypes.c_int
        lib.dot2_desc_size.argtypes = []
        lib.dot2_desc_size.restype = ctypes.c_int
        if lib.dot2_desc_size() != ctypes.sizeof(_Dot2Desc):
            raise RuntimeError(
                f"Dot2Desc layout mismatch: C {lib.dot2_desc_size()} bytes, "
                f"ctypes {ctypes.sizeof(_Dot2Desc)}")
        _LIB = lib
    return info


def dot2_launch_count() -> int:
    """Number of dot2 kernel launches since import (or the last reset):
    the counter `launches.dot2` (utils/profiling.py)."""
    from ..utils.profiling import counters

    return counters().get("launches.dot2", 0)


def reset_dot2_launch_count() -> None:
    from ..utils.profiling import reset_counters

    reset_counters("launches.dot2")


def _workspace(dev: torch.device, stream: int, grid: int) -> torch.Tensor:
    """The partials, the carried sum and the block counter of one device
    and stream ([grid + 2] float64, zeroed once; the kernel leaves the
    counter at 0)."""
    key = (dev.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None:
        ws = _WORKSPACE[key] = torch.zeros(grid + 2, dtype=torch.float64,
                                           device=dev)
    return ws


def dot2_launch(xs, ys) -> torch.Tensor:
    """sum_l xs[l] . ys[l] by the kernel, as a 0-d float32 tensor (float64
    if any leaf is float64) on the leaves' card, with no host sync. Every
    leaf must lie on one CUDA device; the launch or the build raises on
    failure. One launch per MAX_LEAVES leaves."""
    from ..utils.profiling import count

    dev = xs[0].device
    if dev.type != "cuda":
        raise ValueError(f"the dot2 kernel runs on CUDA tensors; got {dev}")
    for t in (*xs, *ys):
        if t.device != dev:
            raise ValueError(f"dot2 leaves on {t.device} and {dev}")
    if _LIB is None:
        build_kernel()
    n_sm = _N_SM.get(dev.index)
    if n_sm is None:
        n_sm = _N_SM[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    call = describe(xs, ys, n_sm)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        ws = _workspace(dev, stream, call.grid)
        out = torch.empty((), device=dev,
                          dtype=torch.float64 if call.f64 else torch.float32)
        base = ws.data_ptr()
        for d in call.descs:
            d.out, d.partials = out.data_ptr(), base
            d.acc, d.counter = base + 8 * call.grid, base + 8 * (call.grid + 1)
            err = _LIB.dot2_launch(ctypes.byref(d), ctypes.c_void_p(stream))
            if err != 0:
                raise RuntimeError(f"dot2 launch failed: cudaError {err}")
            count("launches.dot2")
    return out
