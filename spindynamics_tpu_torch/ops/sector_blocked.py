"""Compact-sector blocked apply (port of spindynamics_tpu/ops/sector_blocked.py):
exactly C(L, nup) amplitudes, no per-element gathers, the "sublattice coding"
(Lin tables) of large-scale exact diagonalization.

Split the chain into lo bits [0, Ll) and hi bits [Ll, L). Order the sector
basis by (k_hi, rank_hi, rank_lo): the state vector becomes a concatenation
over k_hi of row-major matrices  M_k [C(Lh, k_hi), C(Ll, nup - k_hi)].

  - lo bonds (both bits < Ll) fold into the off-diagonal lo-sector operator
    Wlo_k [C_lo, C_lo]: one matrix product  M_k @ Wlo_k  per group.
  - hi bonds (both bits >= Ll) permute whole rows of a group: one
    `index_select` of contiguous rows per bond, by a small precomputed row
    table, times the bond's masked coupling (a row whose two bits are equal
    gets 0).
  - the single cut bond (Ll-1, Ll) maps group k -> k +- 1: a masked row
    gather of the source group, then a rectangular one-hot product on the
    columns.

The layout construction is host numpy, as in the JAX package; the apply is
plain torch on any device and dtype (the JAX package computes it with XLA
matrix products and gathers, not a Pallas kernel). The tables are kept in
float64 on the host and cast to the state's real dtype, where the JAX
package stores its tables in float32 whatever the state: a float64 apply
here keeps couplings that are not float32 numbers exact.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..model import SpinModel
from .sector_kron import _lo_offdiag_dense, _sector_states

__all__ = ["SectorBlockedLayout", "make_sector_blocked_layout",
           "apply_H_sector_blocked", "sector_blocked_tables",
           "blocked_order_states", "blocked_rank"]


class SectorBlockedLayout:
    """Static structure of the (k_hi, rank_hi, rank_lo) layout of one model.

    groups: [(k_hi, C_hi, C_lo)]; offsets: k_hi -> start index; Wlo: k_hi ->
    float64 [C_lo, C_lo] lo-sector operator (None without lo bonds);
    hi_tables: k_hi -> [(J, src row per dst row, -1 where the bond's bits
    are equal)]; cut: k_hi -> [(J, src row per dst row (-1: none), dst
    column per src column (-1: none), k_src)], the contributions INTO k_hi."""

    def __init__(self, L, nup, Ll, groups, offsets, Wlo, hi_tables, cut):
        self.L = L
        self.nup = nup
        self.Ll = Ll
        self.Lh = L - Ll
        self.groups = groups
        self.offsets = offsets
        self.Wlo = Wlo
        self.hi_tables = hi_tables
        self.cut = cut

    @property
    def n_states(self):
        return sum(ch * cl for (_, ch, cl) in self.groups)


def blocked_order_states(L: int, nup: int, Ll: int) -> np.ndarray:
    """uint32 states in (k_hi, rank_hi, rank_lo) order."""
    Lh = L - Ll
    out = []
    for k_hi in range(max(0, nup - Ll), min(Lh, nup) + 1):
        his = _sector_states(Lh, k_hi).astype(np.uint64)
        los = _sector_states(Ll, nup - k_hi).astype(np.uint64)
        out.append(((his[:, None] << np.uint64(Ll)) | los[None, :]).reshape(-1))
    return np.concatenate(out).astype(np.uint32)


def blocked_rank(state: int, L: int, nup: int, Ll: int) -> int:
    """Host rank of a state in the blocked order."""
    from ..basis import rank_state

    Lh = L - Ll
    lo = state & ((1 << Ll) - 1)
    hi = state >> Ll
    k_hi = bin(hi).count("1")
    k_lo = nup - k_hi
    off = 0
    for k in range(max(0, nup - Ll), k_hi):
        off += math.comb(Lh, k) * math.comb(Ll, nup - k)
    return (off + rank_state(hi, Lh, k_hi) * math.comb(Ll, k_lo)
            + rank_state(lo, Ll, k_lo))


def _hi_row_table(Lh, k_hi, bi, bj):
    """src row index per dst row for hi bond (bi, bj), -1 where bits equal."""
    states = _sector_states(Lh, k_hi)
    mask = np.uint32((1 << bi) | (1 << bj))
    differ = (((states >> np.uint32(bi)) ^ (states >> np.uint32(bj)))
              & 1).astype(bool)
    src = np.searchsorted(states, states ^ mask).astype(np.int32)
    return np.where(differ, src, np.int32(-1))


@lru_cache(maxsize=None)
def _cached_layout(L, nup, Ll, hop_sites, hop_J_key):
    hop_J = np.asarray(hop_J_key, np.float64)
    Lh = L - Ll
    lo_bonds, hi_bonds, cut_bonds = [], [], []
    for b, (si, sj) in enumerate(hop_sites):
        i, j = min(si, sj), max(si, sj)
        J = float(hop_J[b])
        if j < Ll:
            lo_bonds.append((i, j, J))
        elif i >= Ll:
            hi_bonds.append((i - Ll, j - Ll, J))
        else:
            if not (i == Ll - 1 and j == Ll):
                raise ValueError(
                    f"bond ({si},{sj}) crosses the lo/hi cut non-adjacently; "
                    "sector_blocked supports nearest-neighbour cut bonds "
                    "only: choose Ll at a chain cut or use another layout")
            cut_bonds.append(J)

    ks = range(max(0, nup - Ll), min(Lh, nup) + 1)
    groups = [(k, math.comb(Lh, k), math.comb(Ll, nup - k)) for k in ks]
    offsets, off = {}, 0
    for (k, ch, cl) in groups:
        offsets[k] = off
        off += ch * cl

    Wlo, hi_tables = {}, {}
    for (k, ch, cl) in groups:
        Wlo[k] = (_lo_offdiag_dense(Ll, nup - k, lo_bonds, dtype=np.float64)
                  if lo_bonds else None)
        hi_tables[k] = [(J, _hi_row_table(Lh, k, bi, bj))
                        for (bi, bj, J) in hi_bonds]

    # the cut bond: the contribution INTO group k_dst = k_src +- 1
    cut = {k: [] for (k, _, _) in groups}
    if cut_bonds:
        J_cut = float(sum(cut_bonds))
        for (k_src, ch_s, _) in groups:
            his_src = _sector_states(Lh, k_src)
            los_src = _sector_states(Ll, nup - k_src)
            for dk in (+1, -1):
                k_dst = k_src + dk
                if k_dst not in offsets:
                    continue
                # hi bit 0 flips 0 -> 1 (dk = +1) or 1 -> 0 (dk = -1), the
                # top lo bit the other way
                his_dst = _sector_states(Lh, k_dst)
                los_dst = _sector_states(Ll, nup - k_dst)
                valid_r = (his_src & 1) == (0 if dk == +1 else 1)
                row_dst = np.searchsorted(his_dst, his_src ^ np.uint32(1))
                row_dst = np.where(valid_r, row_dst.astype(np.int32),
                                   np.int32(-1))
                valid_c = ((los_src >> np.uint32(Ll - 1)) & 1) == (
                    1 if dk == +1 else 0)
                col_dst = np.searchsorted(
                    los_dst, los_src ^ np.uint32(1 << (Ll - 1)))
                col_dst = np.where(valid_c, col_dst.astype(np.int32),
                                   np.int32(-1))
                # inverted: for each dst row, the src row that feeds it
                inv_row = np.full(his_dst.shape[0], -1, np.int32)
                ok = row_dst >= 0
                inv_row[row_dst[ok]] = np.arange(ch_s, dtype=np.int32)[ok]
                cut[k_dst].append((J_cut, inv_row, col_dst, k_src))
    return SectorBlockedLayout(L, nup, Ll, groups, offsets, Wlo, hi_tables,
                               cut)


def default_lo_bits(L: int) -> int:
    """The JAX package's Ll rule: the largest lo part with C(Ll, Ll//2) <=
    512 (the matrix-product sweet spot), at least 8 for L >= 16, leaving at
    least two hi bits."""
    Ll = 8 if L >= 16 else max(2, L // 2)
    while math.comb(Ll + 1, (Ll + 1) // 2) <= 512 and Ll + 1 < L - 1:
        Ll += 1
    return Ll


def make_sector_blocked_layout(model_or_args, Ll: int | None = None
                               ) -> SectorBlockedLayout:
    """The layout of a model, or of (L, nup, hop_sites, hop_J); `Ll`
    defaults to default_lo_bits(L)."""
    if isinstance(model_or_args, SpinModel):
        m = model_or_args
        if m.nup is None:
            raise ValueError("sector_blocked requires a sector (nup set)")
        L, nup, hop_sites = m.L, m.nup, m.hop_sites
        hop_J = tuple(np.asarray(m.hop_J, np.float64).tolist())
        if Ll is None:
            Ll = m.lo_bits
    else:
        L, nup, hop_sites, hop_J = model_or_args
        hop_J = tuple(float(J) for J in hop_J)
    if Ll is None:
        Ll = default_lo_bits(L)
    return _cached_layout(L, nup, Ll, tuple(map(tuple, hop_sites)), hop_J)


def sector_blocked_tables(layout: SectorBlockedLayout, device="cpu",
                          dtype: torch.dtype = torch.float64) -> dict:
    """The layout's tables as a flat dict of tensors on `device` (real
    tables in `dtype`), the names free of dots so that a module can hold
    them as buffers:
      wlo_{k}            [C_lo, C_lo] lo-sector operator
      hi_idx_{k}         int64 [n_hi, C_hi] src row per dst row (0 where
                         masked), hi_w_{k} [n_hi, C_hi] its coupling
                         (J where the bond's bits differ, else 0)
      cut_idx_{k}_{n}    int64 [C_hi] src row of group k's n-th cut term,
                         cut_w_{k}_{n} [C_hi] J or 0 per row, cut_c_{k}_{n}
                         the one-hot [C_lo(src), C_lo] column map."""
    out = {}

    def put(name, arr, real=True):
        out[name] = torch.as_tensor(
            arr, dtype=dtype if real else torch.int64).to(device)

    for (k, _, cl) in layout.groups:
        if layout.Wlo[k] is not None:
            put(f"wlo_{k}", layout.Wlo[k])
        if layout.hi_tables[k]:
            put(f"hi_idx_{k}", np.stack([np.maximum(rows, 0) for _, rows
                                         in layout.hi_tables[k]]), False)
            put(f"hi_w_{k}", np.stack([J * (rows >= 0) for J, rows
                                       in layout.hi_tables[k]]))
        for n, (J, inv_row, col_dst, _) in enumerate(layout.cut[k]):
            C = np.zeros((col_dst.shape[0], cl), np.float64)
            ok = col_dst >= 0
            C[np.arange(col_dst.shape[0])[ok], col_dst[ok]] = 1.0
            put(f"cut_idx_{k}_{n}", np.maximum(inv_row, 0), False)
            put(f"cut_w_{k}_{n}", J * (inv_row >= 0))
            put(f"cut_c_{k}_{n}", C)
    return out


def _times_real(M: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """M @ W for a real W and a real or complex M."""
    if M.is_complex():
        return torch.complex(M.real @ W, M.imag @ W)
    return M @ W


def apply_H_sector_blocked(psi: torch.Tensor, diag: torch.Tensor,
                           layout: SectorBlockedLayout,
                           tables: dict | None = None) -> torch.Tensor:
    """H|psi> in the blocked sector order, plain torch on psi's device, in
    psi's dtype. `diag` must be in the same order. `tables`
    (sector_blocked_tables) default to a build for this one apply: keep a
    FlatHamiltonian (matvec_fn) for repeated applies."""
    rdtype = psi.real.dtype if psi.is_complex() else psi.dtype
    if tables is None:
        tables = sector_blocked_tables(layout, psi.device, rdtype)

    def tab(name):
        return tables[name].to(rdtype)

    out = torch.empty_like(psi)
    blocks = {k: psi[layout.offsets[k]: layout.offsets[k] + ch * cl]
              .view(ch, cl) for (k, ch, cl) in layout.groups}
    for (k, ch, cl) in layout.groups:
        o = layout.offsets[k]
        Mk = blocks[k]
        acc = out[o: o + ch * cl].view(ch, cl)
        torch.mul(diag[o: o + ch * cl].to(rdtype).view(ch, cl), Mk, out=acc)
        if f"wlo_{k}" in tables:
            acc += _times_real(Mk, tab(f"wlo_{k}"))
        if f"hi_idx_{k}" in tables:
            idx, w = tables[f"hi_idx_{k}"], tab(f"hi_w_{k}")
            for b in range(idx.shape[0]):
                # one gathered temporary at a time, as the JAX fori_loop
                g = torch.index_select(Mk, 0, idx[b])
                acc += g.mul_(w[b][:, None])
        for n, (_, _, _, k_src) in enumerate(layout.cut[k]):
            rows = torch.index_select(blocks[k_src], 0,
                                      tables[f"cut_idx_{k}_{n}"])
            rows.mul_(tab(f"cut_w_{k}_{n}")[:, None])
            acc += _times_real(rows, tab(f"cut_c_{k}_{n}"))
    return out
