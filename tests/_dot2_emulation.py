"""Host emulation of the dot2 kernel (spindynamics_tpu_torch/csrc/dot2.cu),
read through the ctypes leaf tables of `ops/dot2.describe`.

It replays the kernel's partition in numpy float64: each leaf cut into
tiles of UNROLL x BLOCK items (16-byte vectors of V elements, 4 float32 or
8 bfloat16, on the vector route, then single elements for the rest),
numbered in leaf order from the table's `tile0`; block b takes tiles b,
b + G, ...; thread t of a tile takes items u x BLOCK + t and adds their
exact products in the order u, then the element within a vector; then each
block's tree (warp shuffles down 16..1, the warps' sums likewise with
zeros past them), the last block's fixed-order sum of the partials and the
same tree, the running sum carried across the launches of one call, and
one rounding to float32. Float32 and bfloat16 calls only: a float64 call's
products are rounded by the FMA, which numpy does not have.

Imports no JAX: the card's tests use it too.
"""

from __future__ import annotations

import ctypes

import numpy as np

from spindynamics_tpu_torch.ops import dot2 as d2

_CT = {"f32": ctypes.c_float, "bf16": ctypes.c_uint16}


def read_host(ptr: int, n: int, stride: int, kind: str) -> np.ndarray:
    """n elements at a host address with an element stride, as float64."""
    if n == 0:
        return np.zeros(0)
    raw = np.ctypeslib.as_array(
        (_CT[kind] * ((n - 1) * stride + 1)).from_address(ptr))[::stride]
    if kind == "bf16":
        raw = (raw.astype(np.uint32) << 16).view(np.float32)
    return raw.astype(np.float64)


def _vec_elems(m: int) -> int:
    """V of a leaf's vector route (0: off it)."""
    return (8 if m & d2.M_XBF16 else 4) if m & d2.M_VEC else 0


def owner(desc, leaf: int, i: int) -> tuple[int, int]:
    """(block, thread) that adds element i of leaf `leaf` (int64
    arithmetic, as in the kernel)."""
    m, n = desc.meta[leaf], desc.n[leaf]
    V = _vec_elems(m)
    vt, _ = d2.leaf_tiles(n, V)
    main = (n // V) * V if V else 0
    if i < main:
        j, q = divmod(i // V, d2.TILE)
    else:
        j, q = divmod(i - main, d2.TILE)
        j += vt
    return (desc.tile0[leaf] + j) % desc.grid, q % d2.BLOCK


def _tree(a: np.ndarray) -> np.ndarray:
    """Lane 0 of `v += shfl_down(v, o)` for o = 16, 8, 4, 2, 1 over the
    last axis (32 lanes)."""
    for o in (16, 8, 4, 2, 1):
        a = a[..., :o] + a[..., o:2 * o]
    return a[..., 0]


def _block_sum(a: np.ndarray) -> np.ndarray:
    """block_sum of csrc/dot2.cu for each row of [rows, BLOCK]."""
    w = _tree(a.reshape(a.shape[0], d2.BLOCK // 32, 32))
    v = np.zeros((a.shape[0], 32))
    v[:, :d2.BLOCK // 32] = w
    return _tree(v)


def _emulate_dot2(call: d2.Dot2Call, read=read_host) -> np.float32:
    """The kernel's result for `call`, bit for bit. `read(ptr, n, stride,
    kind)` gives a leaf's elements (default: from host memory)."""
    if call.f64:
        raise ValueError("float64 calls are not emulated (FMA rounding)")
    total = None
    for d in call.descs:
        acc = np.zeros((d.grid, d2.BLOCK))
        tiles = {}  # global tile -> [UNROLL, BLOCK, V] products, 0-padded
        for l in range(d.n_leaves):
            m, n = d.meta[l], d.n[l]
            kx = "bf16" if m & d2.M_XBF16 else "f32"
            ky = "bf16" if m & d2.M_YBF16 else "f32"
            x = read(d.x[l], n, m & 3, kx)
            y = x if m & d2.M_SAME else read(d.y[l], n, (m >> 2) & 3, ky)
            p = x * y  # exact: at most 48 significant bits
            V = _vec_elems(m)
            vt, st = d2.leaf_tiles(n, V)
            main = (n // V) * V if V else 0
            parts = []
            if vt:
                pv = np.zeros((vt * d2.TILE, V))
                pv[:main // V] = p[:main].reshape(-1, V)
                parts += list(pv.reshape(vt, d2.UNROLL, d2.BLOCK, V))
            if st:
                ps = np.zeros(st * d2.TILE)
                ps[:n - main] = p[main:]
                parts += list(ps.reshape(st, d2.UNROLL, d2.BLOCK, 1))
            assert len(parts) == vt + st
            for j, t in enumerate(parts):
                tiles[d.tile0[l] + j] = t
        assert sorted(tiles) == list(range(d.n_tiles))
        for g in range(d.n_tiles):
            t, b = tiles[g], g % d.grid
            for u in range(d2.UNROLL):
                for k in range(t.shape[2]):
                    acc[b] += t[u, :, k]
        part = _block_sum(acc)
        s = np.zeros(d2.BLOCK)
        for b0 in range(0, d.grid, d2.BLOCK):
            seg = part[b0:b0 + d2.BLOCK]
            s[:len(seg)] += seg
        s = _block_sum(s[None, :])[0]
        total = s if d.flags & d2.F_FIRST else total + s
    return np.float32(total)
