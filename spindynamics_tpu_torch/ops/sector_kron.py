"""3-way Kronecker-factorized compact-sector apply (port of
spindynamics_tpu/ops/sector_kron.py).

The chain's bits split into lo [0, L1), mid [L1, L1+L2) and hi [L1+L2, L).
The U(1)-sector basis is ordered by (k_hi, k_mid) groups; each group is a
rank-3 tensor [C(L3, k_hi), C(L2, k_mid)_pad, C(L1, k_lo)_pad]. Bonds inside
one part fold into that part's dense sector operator W_part[k]; bonds across
two parts factor into two one-hot flip factors (the mid/hi ones are
contiguous block shifts, "runs", applied as slice adds). Each group's
(C_m, C_l) is zero-padded to multiples of (8, 128): `DEFAULT_PADS` is kept
from the JAX package so that every layout array is identical to its JAX
counterpart, and pad slots stay exactly zero through the apply.

The layout construction is host numpy, ported verbatim.
`apply_H_sector_kron` is the blocks-mode apply in plain torch: the CPU path,
the W_hi seed of the fused kernel and its tail groups (the JAX package runs
these products in XLA outside any Pallas kernel).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from .. import basis as basis_mod
from ..model import SpinModel
from ..utils.dtypes import lift_bf16

__all__ = [
    "SectorKronLayout",
    "make_sector_kron_layout",
    "apply_H_sector_kron",
    "kron_tables",
    "default_kron_splits",
    "default_fused_topk",
    "kron_apply_flops",
    "flat_to_blocks",
    "blocks_to_flat",
    "kron_order_states",
    "kron_rank",
    "kron_split_argmin",
]


@lru_cache(maxsize=None)
def default_kron_splits(L: int, nup: int | None = None
                        ) -> tuple[int, int, int]:
    """(L1, L2, L3): largest lo part with C(L1, L1//2) <= 512, remainder
    split mid >= hi. `nup` is accepted for API symmetry and not used."""
    L1 = 2
    while L1 + 1 <= L - 2 and math.comb(L1 + 1, (L1 + 1) // 2) <= 512:
        L1 += 1
    rest = L - L1
    L3 = rest // 2
    L2 = rest - L3
    return (L1, L2, L3)


# The JAX package's constants for ranking candidate splits (its
# v5e-calibrated matrix-unit rate and memory rate): only the crossover
# between the two terms matters for the ranking, so they are kept as they
# are to give the same argmin; they are not rates of any card of the port.
_SPLIT_COST_TFLOPS = 35.5e12
_SPLIT_COST_HBM_BW = 819e9


def _kron_split_cost(L: int, nup: int, splits, itemsize: int = 4
                     ) -> tuple[float, int]:
    """(roofline-seconds proxy, padded elements) of one apply under
    `splits`: max(matmul flops / matrix rate, 2 state passes / memory rate).
    Flop model: the W contraction of each part costs 2*size*C_part per
    group (dense [C, C] on that axis, padded to the tile); the two
    chain-boundary cross bonds ~2*size*(clp + cmp). `itemsize` is the
    amplitude width in bytes for the memory term (2 for bfloat16 states)."""
    L1, L2, L3 = splits
    flops = 0
    padded = 0
    for kh in range(max(0, nup - L1 - L2), min(L3, nup) + 1):
        for km in range(max(0, nup - kh - L1), min(L2, nup - kh) + 1):
            kl = nup - kh - km
            if kl < 0 or kl > L1:
                continue
            ch = math.comb(L3, kh)
            cmp_ = _pad_up(math.comb(L2, km), 8)
            clp = _pad_up(math.comb(L1, kl), 128)
            size = ch * cmp_ * clp
            padded += size
            w = 0
            if 0 < kl < L1:
                w += clp
            if 0 < km < L2:
                w += cmp_
            if 0 < kh < L3:
                w += ch
            w += clp + cmp_  # lo|mid and mid|hi boundary bonds
            flops += 2 * size * w
    return (max(flops / _SPLIT_COST_TFLOPS,
                2 * padded * itemsize / _SPLIT_COST_HBM_BW), padded)


def kron_split_argmin(L: int, nup: int | None = None,
                      itemsize: int = 4) -> tuple[int, int, int]:
    """Split of least `_kron_split_cost`: an analysis tool, not the
    default. The search is restricted to L1 with C(L1, L1//2) <= 512 (the
    cap of `default_kron_splits`), so this is the argmin over the
    deployable splits. Requires L >= 4. The JAX package measured on its
    chip that the flop-balanced splits this picks ran slower than
    `default_kron_splits` at L = 28 and 32; on the H100 it is not
    measured."""
    if nup is None:
        nup = L // 2
    if L < 4:
        raise ValueError(
            f"kron_split_argmin needs L >= 4 (no valid 3-way split with "
            f"L1 >= 2 exists at L={L}); use default_kron_splits or a "
            "non-kron layout for tiny chains")
    best = None
    for L1 in range(2, L - 1):
        if math.comb(L1, L1 // 2) > 512:
            break
        for L2 in range(1, L - L1):
            key = (_kron_split_cost(L, nup, (L1, L2, L - L1 - L2), itemsize),
                   (L1, L2, L - L1 - L2))
            if best is None or key < best:
                best = key
    return best[1]


PAD_SENTINEL = np.uint32(0xFFFFFFFF)  # popcount 32 > any L-site nup
DEFAULT_PADS = (8, 128)


def _pad_up(n, m):
    return -(-n // m) * m


def _sector_states(L, k):
    return (basis_mod.build_sector_basis(L, k) if L > 0
            else np.zeros(1, np.uint32))


def _lo_offdiag_dense(Ll, k_lo, lo_bonds, dtype=np.float32):
    """Weighted off-diagonal part-sector Hamiltonian [C, C] (numpy):
    W[src, dst] so that out = M @ W gives out[., dst] += J * M[., src]."""
    states = _sector_states(Ll, k_lo)
    n = states.shape[0]
    W = np.zeros((n, n), dtype=dtype)
    for (i, j, J) in lo_bonds:
        mask = np.uint32((1 << i) | (1 << j))
        differ = (((states >> np.uint32(i)) ^ (states >> np.uint32(j)))
                  & 1).astype(bool)
        flipped = states ^ mask
        dst = np.searchsorted(states, flipped)
        src = np.arange(n)
        W[src[differ], dst[differ]] += J
    return W


def kron_part_perms(splits) -> tuple:
    """Per-part internal bit permutations: perm[p][rel] = internal position.

    Mid and hi enumerate their sector states over ROTATED bit order
    (physical bit 0 -> internal top, bit r -> r-1), so flipping a
    chain-boundary bit is one or two contiguous block shifts on a major
    tensor axis. The lo part keeps natural order."""
    L1, L2, L3 = splits

    def rot(Lp):
        if Lp < 2:
            return tuple(range(Lp))
        return tuple((r - 1) % Lp for r in range(Lp))

    return (tuple(range(L1)), rot(L2), rot(L3))


def _perm_sector_states(Lp, k, perm):
    """Physical sub-state values in INTERNAL (permuted-bit combinadic) order."""
    ss = _sector_states(Lp, k).astype(np.uint64)
    if tuple(perm) == tuple(range(Lp)):
        return ss
    phys = np.zeros_like(ss)
    for rel in range(Lp):
        phys |= ((ss >> np.uint64(perm[rel])) & np.uint64(1)) << np.uint64(rel)
    return phys


def _as_runs(U, max_runs: int = 8):
    """Decompose a sparse factor into contiguous block shifts
    [(row0, col0, length, value), ...] (out[col0:col0+length] += value *
    in[row0:row0+length] on a major axis), or None if more than max_runs
    are needed."""
    rows, cols = np.nonzero(U)
    if rows.size == 0:
        return []
    vals = U[rows, cols]
    runs = []
    order = np.lexsort((rows, cols - rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    start = 0
    for i in range(1, rows.size + 1):
        boundary = (
            i == rows.size
            or cols[i] - rows[i] != cols[start] - rows[start]
            or vals[i] != vals[start]
            or rows[i] != rows[i - 1] + 1
        )
        if boundary:
            runs.append((int(rows[start]), int(cols[start]),
                         int(i - start), float(vals[start])))
            if len(runs) > max_runs:
                return None
            start = i
    return runs


def _group_list(L, nup, splits, pads=DEFAULT_PADS):
    """Ordered [(k_h, k_m, k_l, C_h, C_m, C_l, C_m_pad, C_l_pad)] over valid
    (k_h, k_m)."""
    L1, L2, L3 = splits
    pm, pl = pads
    out = []
    for k_h in range(0, min(L3, nup) + 1):
        for k_m in range(0, min(L2, nup - k_h) + 1):
            k_l = nup - k_h - k_m
            if not 0 <= k_l <= L1:
                continue
            cm = math.comb(L2, k_m)
            cl = math.comb(L1, k_l)
            out.append((k_h, k_m, k_l, math.comb(L3, k_h), cm, cl,
                        _pad_up(cm, pm), _pad_up(cl, pl)))
    return out


def kron_order_states(L: int, nup: int, splits, pads=DEFAULT_PADS
                      ) -> np.ndarray:
    """uint32 states in ((k_h, k_m) group, rank_h, rank_m, rank_l) order,
    PAD_SENTINEL in tile-padding slots: entry r is the basis state (bit i =
    site i) whose amplitude a flat kron-order vector holds at r. Part ranks
    follow kron_part_perms (mid and hi in rotated-bit internal order)."""
    L1, L2, L3 = splits
    perms = kron_part_perms(splits)
    parts = []
    for (k_h, k_m, k_l, ch, cm, cl, cmp, clp) in _group_list(L, nup, splits,
                                                             pads):
        his = _perm_sector_states(L3, k_h, perms[2]).astype(np.uint64)
        mids = _perm_sector_states(L2, k_m, perms[1]).astype(np.uint64)
        los = _perm_sector_states(L1, k_l, perms[0]).astype(np.uint64)
        blk = ((his[:, None, None] << np.uint64(L1 + L2))
               | (mids[None, :, None] << np.uint64(L1))
               | los[None, None, :]).astype(np.uint32)
        if (cmp, clp) != (cm, cl):
            blk = np.pad(blk, ((0, 0), (0, cmp - cm), (0, clp - cl)),
                         constant_values=PAD_SENTINEL)
        parts.append(blk.reshape(-1))
    return np.concatenate(parts)


def kron_rank(state: int, L: int, nup: int, splits, pads=DEFAULT_PADS
              ) -> int:
    """Host rank of a basis state in the kron order: the inverse of
    kron_order_states at one state."""
    L1, L2, L3 = splits
    perms = kron_part_perms(splits)

    def internal(sub, Lp, perm):
        v = 0
        for rel in range(Lp):
            v |= ((sub >> rel) & 1) << perm[rel]
        return v

    lo = internal(state & ((1 << L1) - 1), L1, perms[0])
    mid = internal((state >> L1) & ((1 << L2) - 1), L2, perms[1])
    hi = internal(state >> (L1 + L2), L3, perms[2])
    k_h = bin(hi).count("1")
    k_m = bin(mid).count("1")
    off = 0
    for (gkh, gkm, gkl, ch, cm, cl, cmp, clp) in _group_list(L, nup, splits,
                                                             pads):
        if (gkh, gkm) == (k_h, k_m) and bin(lo).count("1") == gkl:
            return (off
                    + (basis_mod.rank_state(hi, L3, k_h) * cmp
                       + basis_mod.rank_state(mid, L2, k_m)) * clp
                    + basis_mod.rank_state(lo, L1, gkl))
        off += ch * cmp * clp
    raise ValueError(f"state {state:#x} not in sector nup={nup}")


def _flip_matrix(Lp: int, k_src: int, p: int, v: int):
    """One-hot [C(Lp,k_src), C(Lp,k_dst)] for flipping bit p when it equals v
    (v=1: S-_p, v=0: S+_p). None if k_dst is out of range or no source state
    has bit p == v."""
    k_dst = k_src - 1 if v == 1 else k_src + 1
    if not 0 <= k_dst <= Lp:
        return None
    S = _sector_states(Lp, k_src).astype(np.int64)
    D = _sector_states(Lp, k_dst).astype(np.int64)
    valid = ((S >> p) & 1) == v
    if not valid.any():
        return None
    U = np.zeros((S.shape[0], D.shape[0]), np.float64)
    dst = np.searchsorted(D, S[valid] ^ (1 << p))
    U[np.nonzero(valid)[0], dst] = 1.0
    return U


class SectorKronLayout:
    """Static structure of the 3-way layout for one (L, nup, bonds) model."""

    def __init__(self, L, nup, splits, pads, groups, offsets, W, cross_meta,
                 cross_pool, diag_vecs=None, diag_cross=None,
                 cross_runs=None, cross_shapes=None):
        self.L, self.nup, self.splits, self.pads = L, nup, splits, pads
        # groups: [(k_h, k_m, k_l, C_h, C_m, C_l, C_m_pad, C_l_pad)]
        self.groups = groups
        self.offsets = offsets          # [int] per group (padded strides)
        self.W = W                      # [W_lo, W_mid, W_hi]: k -> [Cp, Cp]
        # cross_meta: [g_dst] -> [(g_src, part_a, part_b, a_key, b_key)];
        # cross_pool: {key: one-hot factor}, deduped across groups
        self.cross_meta = cross_meta
        self.cross_pool = cross_pool
        # cross_runs: {key: [(row0, col0, len, val)]} for mid/hi factors that
        # are contiguous block shifts; such keys are absent from cross_pool
        self.cross_runs = cross_runs or {}
        self.cross_shapes = cross_shapes or {}
        # factored diagonal: per-part [C_pad] vectors + cross-part ZZ pairs
        self.diag_vecs = diag_vecs or [{}, {}, {}]
        self.diag_cross = diag_cross or []  # [(pa, pb, {k: J*sz_a}, {k: sz_b})]

    @property
    def n_states(self):
        """Flat state-vector length INCLUDING tile padding."""
        return sum(ch * cmp * clp
                   for (_, _, _, ch, _, _, cmp, clp) in self.groups)

    @property
    def n_basis(self):
        """Exact sector dimension C(L, nup)."""
        return sum(ch * cm * cl
                   for (_, _, _, ch, cm, cl, _, _) in self.groups)


def _pad_mat(M, rows, cols):
    if M.shape == (rows, cols):
        return M
    out = np.zeros((rows, cols), M.dtype)
    out[: M.shape[0], : M.shape[1]] = M
    return out


@lru_cache(maxsize=None)
def _cached_kron_layout(L, nup, splits, hop_sites, hop_J_key, pads,
                        field_key=(), zz_sites=(), zz_J_key=()):
    L1, L2, L3 = splits
    if L1 + L2 + L3 != L or min(L1, L2, L3) < 1:
        raise ValueError(f"bad splits {splits} for L={L}")
    hop_J = np.asarray(hop_J_key, np.float64)
    start = [0, L1, L1 + L2]
    plen = [L1, L2, L3]
    perms = kron_part_perms(splits)

    def part_of(bit):
        return 0 if bit < L1 else (1 if bit < L1 + L2 else 2)

    within = {0: [], 1: [], 2: []}
    # (pa, pb, rel_j, dir) -> [(rel_i, J)];  dir=+1: bit i 1->0, bit j 0->1
    cross_specs = {}
    for b, (si, sj) in enumerate(hop_sites):
        i, j = min(si, sj), max(si, sj)
        J = float(hop_J[b])
        pa, pb = part_of(i), part_of(j)
        if pa == pb:
            within[pa].append((perms[pa][i - start[pa]],
                               perms[pa][j - start[pa]], J))
        else:
            for d in (+1, -1):
                cross_specs.setdefault(
                    (pa, pb, perms[pb][j - start[pb]], d), []
                ).append((perms[pa][i - start[pa]], J))

    pm, pl = pads

    def pdim(p, k):
        """Padded axis length of part p at part-magnetization k."""
        c = math.comb(plen[p], k)
        return c if p == 2 else _pad_up(c, pm if p == 1 else pl)

    groups = _group_list(L, nup, splits, pads)
    offsets, off = [], 0
    key_index = {}
    for gi, (k_h, k_m, k_l, ch, cm, cl, cmp, clp) in enumerate(groups):
        offsets.append(off)
        key_index[(k_h, k_m)] = gi
        off += ch * cmp * clp

    W = [{}, {}, {}]
    for p in range(3):
        if not within[p]:
            continue
        ks = sorted({g[[2, 1, 0][p]] for g in groups})
        for k in ks:
            Wk = _lo_offdiag_dense(plen[p], k, within[p], dtype=np.float64)
            if np.any(Wk):
                W[p][k] = _pad_mat(Wk, pdim(p, k), pdim(p, k))

    cross_meta = [[] for _ in groups]
    cross_pool = {}
    key_part = {}
    for si, ((pa, pb, rel_j, d), terms) in enumerate(
            sorted(cross_specs.items())):
        va = 1 if d == +1 else 0
        vb = 1 - va
        for g_src, (k_h, k_m, k_l, ch, cm, cl, cmp, clp) in enumerate(groups):
            kp = [k_l, k_m, k_h]
            a_key = (si, 0, kp[pa])
            b_key = (si, 1, kp[pb])
            if a_key not in cross_pool:
                A = None
                for (rel_i, J) in terms:
                    U = _flip_matrix(plen[pa], kp[pa], rel_i, va)
                    if U is not None:
                        A = J * U if A is None else A + J * U
                cross_pool[a_key] = (
                    None if A is None or not np.any(A)
                    else _pad_mat(A, pdim(pa, kp[pa]), pdim(pa, kp[pa] - d))
                )
            if cross_pool[a_key] is None:
                continue
            if b_key not in cross_pool:
                B = _flip_matrix(plen[pb], kp[pb], rel_j, vb)
                cross_pool[b_key] = (
                    None if B is None
                    else _pad_mat(B, pdim(pb, kp[pb]), pdim(pb, kp[pb] + d))
                )
            if cross_pool[b_key] is None:
                continue
            kp_dst = list(kp)
            kp_dst[pa] -= d
            kp_dst[pb] += d
            g_dst = key_index.get((kp_dst[2], kp_dst[1]))
            if g_dst is None:
                continue
            cross_meta[g_dst].append((g_src, pa, pb, a_key, b_key))
            key_part[a_key] = pa
            key_part[b_key] = pb
    cross_pool = {k: v for k, v in cross_pool.items() if v is not None}
    used = {k for metas in cross_meta for (_, _, _, ak, bk) in metas
            for k in (ak, bk)}
    cross_pool = {k: v for k, v in cross_pool.items() if k in used}

    # mid/hi-axis factors that are contiguous block shifts apply as slice
    # adds; lo-axis factors stay matmuls
    cross_runs = {}
    cross_shapes = {k: v.shape for k, v in cross_pool.items()}
    for k in list(cross_pool):
        if key_part[k] == 0:
            continue
        runs = _as_runs(cross_pool[k])
        if runs is not None:
            cross_runs[k] = runs
            del cross_pool[k]

    # factored diagonal:
    # diag[h, m, l] = d_hi[h] + d_mid[m] + d_lo[l]
    #                 + sum_{cross zz bonds} J * sz_i[rank_a] * sz_j[rank_b]
    field = (np.zeros(L) if not field_key
             else np.asarray(field_key, np.float64))
    zz_J = np.asarray(zz_J_key, np.float64)
    part_ks = [sorted({g[[2, 1, 0][p]] for g in groups}) for p in range(3)]

    def _sz(p, k, rel):
        S = _sector_states(plen[p], k).astype(np.int64)
        return ((S >> rel) & 1).astype(np.float64) - 0.5

    def _padvec(v, p, k):
        out = np.zeros(pdim(p, k))
        out[: v.shape[0]] = v
        return out

    within_zz = {0: [], 1: [], 2: []}
    cross_zz = []
    for b, (si, sj) in enumerate(zz_sites):
        i, j = min(si, sj), max(si, sj)
        J = float(zz_J[b])
        pa, pb = part_of(i), part_of(j)
        if pa == pb:
            within_zz[pa].append((perms[pa][i - start[pa]],
                                  perms[pa][j - start[pa]], J))
        else:
            cross_zz.append((pa, pb, perms[pa][i - start[pa]],
                             perms[pb][j - start[pb]], J))

    diag_vecs = [{}, {}, {}]
    for p in range(3):
        for k in part_ks[p]:
            d = np.zeros(math.comb(plen[p], k))
            for rel in range(plen[p]):
                h = field[start[p] + rel]
                if h != 0.0:
                    d = d + h * _sz(p, k, perms[p][rel])
            for (ri, rj, J) in within_zz[p]:
                d = d + J * _sz(p, k, ri) * _sz(p, k, rj)
            if np.any(d):
                diag_vecs[p][k] = _padvec(d, p, k)

    diag_cross = []
    for (pa, pb, ri, rj, J) in cross_zz:
        va = {k: _padvec(J * _sz(pa, k, ri), pa, k) for k in part_ks[pa]}
        vb = {k: _padvec(_sz(pb, k, rj), pb, k) for k in part_ks[pb]}
        diag_cross.append((pa, pb, va, vb))

    return SectorKronLayout(L, nup, splits, pads, groups, offsets, W,
                            cross_meta, cross_pool, diag_vecs, diag_cross,
                            cross_runs, cross_shapes)


def make_sector_kron_layout(model_or_args, splits=None, pads=DEFAULT_PADS,
                            field=None, zz_sites=(), zz_J=()
                            ) -> SectorKronLayout:
    """Layout for a SpinModel (field/zz taken from it) or an args tuple
    (L, nup, hop_sites, hop_J) with field/zz passed separately."""
    if isinstance(model_or_args, SpinModel):
        m = model_or_args
        L, nup = m.L, m.nup
        hop_sites = m.hop_sites
        hop_J = tuple(np.asarray(m.hop_J, np.float64).tolist())
        field = tuple(np.asarray(m.field, np.float64).tolist())
        zz_sites = m.zz_sites
        zz_J = tuple(np.asarray(m.zz_J, np.float64).tolist())
        if splits is None:
            splits = m.kron_splits
    else:
        L, nup, hop_sites, hop_J = model_or_args
        hop_J = tuple(hop_J)
    if splits is None:
        splits = default_kron_splits(L, nup)
    field_key = (() if field is None
                 else tuple(np.asarray(field, np.float64).tolist()))
    if field_key and not any(field_key):
        field_key = ()
    return _cached_kron_layout(L, nup, tuple(splits), tuple(hop_sites), hop_J,
                               tuple(pads), field_key, tuple(zz_sites),
                               tuple(np.asarray(zz_J, np.float64).tolist()))


def flat_to_blocks(psi: torch.Tensor, layout: SectorKronLayout) -> list:
    """Flat kron-order vector -> per-group rank-3 views."""
    out = []
    for gi, (_, _, _, ch, _, _, cmp, clp) in enumerate(layout.groups):
        o = layout.offsets[gi]
        out.append(psi[o: o + ch * cmp * clp].view(ch, cmp, clp))
    return out


def blocks_to_flat(blocks, layout: SectorKronLayout) -> torch.Tensor:
    """Inverse of flat_to_blocks."""
    return torch.cat([b.reshape(-1) for b in blocks])


def kron_apply_flops(layout: SectorKronLayout) -> int:
    """Exact matmul flop count of one apply_H_sector_kron (2*m*n*k per
    contraction), mirroring the apply's A/B ordering decision."""
    fl = 0
    for gi, (k_h, k_m, k_l, ch, cm, cl, cmp, clp) in enumerate(layout.groups):
        size = ch * cmp * clp
        for p, k in ((0, k_l), (1, k_m), (2, k_h)):
            W = layout.W[p].get(k)
            if W is not None:
                fl += 2 * size * W.shape[1]
        for (g_src, pa, pb, a_key, b_key) in layout.cross_meta[gi]:
            (_, _, _, chs, _, _, cmps, clps) = layout.groups[g_src]
            ssz = chs * cmps * clps
            runs_a = layout.cross_runs.get(a_key)
            runs_b = layout.cross_runs.get(b_key)
            if runs_a is not None and runs_b is not None:
                continue  # pure slice adds, no matmul flops
            if runs_a is not None or runs_b is not None:
                runs, pr = (runs_a, pa) if runs_a is not None else (runs_b, pb)
                m_key = b_key if runs_a is not None else a_key
                M = layout.cross_pool[m_key]
                ax = chs if pr == 2 else cmps
                for (_r0, _c0, ln, _v) in runs:
                    fl += 2 * (ssz // ax) * ln * M.shape[1]
                continue
            A = layout.cross_pool[a_key]
            B = layout.cross_pool[b_key]
            fa = ssz * A.shape[1] * (1.0 + B.shape[1] / A.shape[0])
            fb = ssz * B.shape[1] * (1.0 + A.shape[1] / B.shape[0])
            fl += int(2 * min(fa, fb))
    return fl


def default_fused_topk(layout: SectorKronLayout,
                       min_elems: int = 1 << 17) -> int:
    """Number of kernel-fused groups: every group with >= min_elems elements
    (0.5 MB f32), clamped to >= 32 so small layouts fuse every group. The
    cutoff is the JAX package's TPU rule, kept for parity; the H100's own
    rule is still to be measured (ROADMAP Queue 1, item 6)."""
    big = sum(1 for (_, _, _, ch, _, _, cmp, clp) in layout.groups
              if ch * cmp * clp >= min_elems)
    return max(32, big)


def _as_tensor(x, dtype, device, memo):
    """numpy -> torch on (dtype, device), one tensor per source array."""
    t = memo.get(id(x))
    if t is None:
        t = torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
        memo[id(x)] = t
    return t


def kron_tables(layout: SectorKronLayout, dtype=torch.float32, device="cpu",
                memo=None) -> dict:
    """The layout's matrices as torch tensors on (dtype, device):
    {"W": [{k: T}]*3, "cross": {key: T}, "dvec": [{k: T}]*3,
     "dcross": [({k: T}, {k: T}), ...]}. `memo` (id(numpy) -> tensor) lets
    several table sets share tensors built from the same array. Each set
    converted is counted in `build.kron_tables` (utils/profiling.py)."""
    from ..utils.profiling import count

    count("build.kron_tables")
    memo = {} if memo is None else memo

    def conv(d):
        return {k: _as_tensor(v, dtype, device, memo) for k, v in d.items()}

    return {
        "W": [conv(layout.W[p]) for p in range(3)],
        "cross": conv(layout.cross_pool),
        "dvec": [conv(layout.diag_vecs[p]) for p in range(3)],
        "dcross": [(conv(va), conv(vb))
                   for (_, _, va, vb) in layout.diag_cross],
    }


def _default_tables(layout, dtype, device):
    cache = layout.__dict__.setdefault("_torch_tables", {})
    key = (dtype, torch.device(device))
    if key not in cache:
        cache[key] = kron_tables(layout, dtype, device)
    return cache[key]


def _contract(T, M, part):
    """Contract the `part` axis of group tensor T [h, m, l] with M[src, dst]
    (einsum "hml,ln->hmn" | "hml,mn->hnl" | "hml,hn->nml"). A bfloat16 T is
    lifted: the result is float32."""
    T = lift_bf16(T)
    M = M.to(T.dtype)
    if part == 0:
        return torch.matmul(T, M)
    if part == 1:
        return torch.matmul(M.t(), T)
    h, m, l = T.shape
    return torch.matmul(M.t(), T.reshape(h, m * l)).reshape(M.shape[1], m, l)


def _bcast(vec, part):
    """Broadcast a padded per-part [C_pad] vector over a group tensor."""
    if part == 2:
        return vec[:, None, None]
    if part == 1:
        return vec[None, :, None]
    return vec[None, None, :]


def _sl(T, part, r0, ln):
    # part 2 (hi) = dim 0, part 1 (mid) = dim 1
    return T[r0:r0 + ln] if part == 2 else T[:, r0:r0 + ln]


def apply_H_sector_kron(psi, diag, layout: SectorKronLayout, tables=None,
                        terms: str = "all", group_filter=None,
                        lifted: dict | None = None):
    """H|psi> on a LIST of per-group tensors [C_h, C_m_pad, C_l_pad] (blocks
    mode; the flat mode of the JAX package is not ported). Returns a list.

    `diag` must be None: the layout's factored diagonal is used. `terms`
    restricts the term classes: "all" | comma-set of diag,lo,mid,hi,cross,
    plus "crossl" (lo|mid bonds, hi-axis untouched) and "crossh" (terms that
    touch the hi axis). `group_filter`: iterable of group indices to compute;
    the other groups come back as None (the JAX package returns zero leaves
    that XLA prunes; eager torch would allocate them).

    bfloat16 leaves are lifted group by group as they are read and the
    outputs are FLOAT32 (the JAX apply promotes against its float32 tables
    the same way): the caller rounds, once, where it stores. Each leaf is
    lifted once per call, for its own products and for every cross term
    that reads it; `lifted` (a dict group -> lifted leaf) shares those
    lifts with the caller's other uses of the same leaves."""
    if not isinstance(psi, (list, tuple)):
        raise TypeError("apply_H_sector_kron takes a list of per-group "
                        "tensors (blocks mode); use flat_to_blocks")
    if diag is not None:
        raise ValueError("explicit `diag` override is flat-vector-only; pass "
                         "diag=None (the factored per-part tables are used)")
    want = (frozenset(("diag", "lo", "mid", "hi", "cross"))
            if terms == "all" else frozenset(terms.split(",")))
    want_crossl = "cross" in want or "crossl" in want
    want_crossh = "cross" in want or "crossh" in want
    G = list(psi)
    rdtype = (torch.float32 if G[0].dtype == torch.bfloat16
              else G[0].dtype)
    dev = (tables if tables is not None
           else _default_tables(layout, rdtype, G[0].device))

    gset = None if group_filter is None else frozenset(group_filter)
    if lifted is None:
        lifted = {}

    def lift(g):
        if g not in lifted:
            lifted[g] = lift_bf16(G[g])
        return lifted[g]

    outs = []
    for gi, (k_h, k_m, k_l, ch, cm, cl, cmp, clp) in enumerate(layout.groups):
        if gset is not None and gi not in gset:
            outs.append(None)
            continue
        T = lift(gi)
        kp = (k_l, k_m, k_h)
        acc = None
        if "diag" in want:
            d = None
            for p in range(3):
                v = dev["dvec"][p].get(kp[p])
                if v is not None:
                    t = _bcast(v.to(rdtype), p)
                    d = t if d is None else d + t
            if d is not None:
                acc = T * d
            for (pa, pb, _, _), (va, vb) in zip(layout.diag_cross,
                                                dev["dcross"]):
                sa = _bcast(va[kp[pa]].to(rdtype), pa)
                sb = _bcast(vb[kp[pb]].to(rdtype), pb)
                term = T * (sa * sb)
                acc = term if acc is None else acc.add_(term)
        if acc is None:
            acc = torch.zeros_like(T)
        for p, k in ((0, k_l), (1, k_m), (2, k_h)):
            if ("lo", "mid", "hi")[p] in want and k in dev["W"][p]:
                acc.add_(_contract(T, dev["W"][p][k], p))

        for (g_src, pa, pb, a_key, b_key) in (layout.cross_meta[gi]
                                              if (want_crossl or want_crossh)
                                              else ()):
            touches_hi = 2 in (pa, pb)
            if touches_hi and not want_crossh:
                continue
            if not touches_hi and not want_crossl:
                continue
            runs_a = layout.cross_runs.get(a_key)
            runs_b = layout.cross_runs.get(b_key)
            if runs_a is not None and runs_b is not None:
                # both factors are block shifts on the mid/hi dims: slice
                # adds, which read a bfloat16 source as float32 themselves
                # (it is lifted only for a product by a value other than 1)
                scaled = any(va * vb != 1.0 for (*_, va) in runs_a
                             for (*_, vb) in runs_b)
                S = (lift(g_src) if scaled or g_src in lifted
                     else G[g_src])
                for (ra0, ca0, lna, va) in runs_a:
                    for (rb0, cb0, lnb, vb) in runs_b:
                        X = _sl(_sl(S, pa, ra0, lna), pb, rb0, lnb)
                        v = va * vb
                        if v != 1.0:
                            X = v * X
                        hi_c, hi_l = (ca0, lna) if pa == 2 else (cb0, lnb)
                        md_c, md_l = (cb0, lnb) if pa == 2 else (ca0, lna)
                        acc[hi_c:hi_c + hi_l, md_c:md_c + md_l].add_(X)
                continue
            S = lift(g_src)
            if runs_a is not None or runs_b is not None:
                # one shift + one matmul: slice first, then contract
                runs, pr = (runs_a, pa) if runs_a is not None else (runs_b, pb)
                m_key, pm = (b_key, pb) if runs_a is not None else (a_key, pa)
                M = dev["cross"][m_key]
                for (r0, c0, ln, val) in runs:
                    X = _contract(_sl(S, pr, r0, ln), M, pm)
                    if val != 1.0:
                        X = val * X
                    _sl(acc, pr, c0, ln).add_(X)
                continue
            A = dev["cross"][a_key]
            B = dev["cross"][b_key]
            # contract in the order that minimizes matmul flops
            ssz = S.numel()
            fa = ssz * A.shape[1] * (1.0 + B.shape[1] / A.shape[0])
            fb = ssz * B.shape[1] * (1.0 + A.shape[1] / B.shape[0])
            if fa <= fb:
                X = _contract(_contract(S, A, pa), B, pb)
            else:
                X = _contract(_contract(S, B, pb), A, pa)
            acc.add_(X)
        outs.append(acc)
    return outs
