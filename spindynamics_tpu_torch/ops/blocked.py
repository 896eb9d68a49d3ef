"""Blocked full-space matvec (port of spindynamics_tpu/ops/blocked.py): the
unfused form of H|psi> on a flat 2^L state, and the plain version that K3
(ops/fused_matvec.py) is held against.

View psi as [B, T, W] (W = 2^w low bits, T = 2^t middle bits, B the rest).
Every hopping bond XORs two index bits; by where those bits live the bond is
folded into one [W, W] matrix (both bits low), one [T, T] matrix (both bits
middle), or stays "special": a flip of major axes and/or single-bit
permutation products, times the bits-differ mask. The plan is host numpy and
identical, field by field, to the JAX package's. This is the CPU path and
the float64 path of the flat layouts; on the card float32 and complex64
states go through K3 instead.

Matrix products run in full float32 (TF32 is pinned off at import); a
complex state goes through `torch.view_as_real` so each product is real.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model import SpinModel
from ..utils.dtypes import real_dtype

__all__ = ["BlockedPlan", "make_blocked_plan", "apply_H_blocked"]


class BlockedPlan:
    """Precomputed structure for the blocked matvec of one model: only
    static structure (one-hot bases and bond classification); the coupling
    values stay in model.hop_J."""

    def __init__(self, L, w, t, cols_stack, cols_idx, rows_stack, rows_idx,
                 special):
        self.L = L
        self.w = w  # low ("lane") bits
        self.t = t  # middle ("sublane") bits
        self.cols_stack = cols_stack  # [n_cb, W, W] unweighted masked one-hots
        self.cols_idx = cols_idx      # int32 [n_cb] indices into hop_J
        self.rows_stack = rows_stack  # [n_rb, T, T]
        self.rows_idx = rows_idx
        # list of (bond_idx, m_col, m_row, m_blk, bit_i, bit_j) not folded
        self.special = special

    @property
    def W(self):
        return 1 << self.w

    @property
    def T(self):
        return 1 << self.t


def _differ_mask_1d(nbits: int, bit_a: int, bit_b: int) -> np.ndarray:
    """mask[c] = bit_a(c) != bit_b(c), both bits within an nbits index."""
    c = np.arange(1 << nbits)
    return (((c >> bit_a) ^ (c >> bit_b)) & 1).astype(np.float32)


def _onehot_flip_matrix(nbits: int, m: int, mask_bits=None) -> np.ndarray:
    """M[src, dst] = differ(dst) * [src == dst ^ m] for dst-space masks."""
    n = 1 << nbits
    dst = np.arange(n)
    src = dst ^ m
    M = np.zeros((n, n), dtype=np.float32)
    if mask_bits is not None:
        mask = _differ_mask_1d(nbits, *mask_bits)
    else:
        mask = np.ones(n, dtype=np.float32)
    M[src, dst] = mask
    return M


_PLAN_CACHE: dict = {}


def make_blocked_plan(model: SpinModel, w: int | None = None,
                      t: int | None = None) -> BlockedPlan:
    """Classify bonds into (col-matmul, row-matmul, special) for the
    [B, T, W] view. Defaults: w = min(8, L-2), t so that T <= 256 and
    B >= 2."""
    L = model.L
    if w is None:
        w = min(8, L - 2)
    if t is None:
        t = min(8, L - w - 1) if L - w - 1 > 0 else 0
    key = (model.L, model.hop_sites, w, t)
    if key in _PLAN_CACHE:
        return _PLAN_CACHE[key]

    W, T = 1 << w, 1 << t
    cols, cols_idx, rows, rows_idx = [], [], [], []
    special = []
    for b, (si, sj) in enumerate(model.hop_sites):
        i, j = min(si, sj), max(si, sj)
        if j < w:
            # both bits low: fold; the mask depends only on the column
            cols.append(_onehot_flip_matrix(w, (1 << i) | (1 << j), (i, j)))
            cols_idx.append(b)
        elif i >= w and j < w + t:
            # mid matmul is out[dst] = sum_src M[dst, src] x[src]: transpose
            # the (src, dst)-oriented one-hot build
            rows.append(
                _onehot_flip_matrix(
                    t, (1 << (i - w)) | (1 << (j - w)), (i - w, j - w)
                ).T.copy()
            )
            rows_idx.append(b)
        else:
            m = (1 << i) | (1 << j)
            m_col = m & (W - 1)
            m_row = (m >> w) & (T - 1)
            m_blk = m >> (w + t)
            special.append((b, m_col, m_row, m_blk, i, j))

    plan = BlockedPlan(
        L,
        w,
        t,
        np.stack(cols) if cols else None,
        np.asarray(cols_idx, np.int32) if cols else None,
        np.stack(rows) if rows else None,
        np.asarray(rows_idx, np.int32) if rows else None,
        special,
    )
    _PLAN_CACHE[key] = plan
    return plan


def _global_bit(bit: int, w: int, t: int, B: int, T: int, W: int, dtype,
                device):
    """0/1 broadcastable tensor reading one bit of the [B, T, W] index."""
    if bit < w:
        n, shape, sh = W, (1, 1, W), bit
    elif bit < w + t:
        n, shape, sh = T, (1, T, 1), bit - w
    else:
        n, shape, sh = B, (B, 1, 1), bit - w - t
    ar = (torch.arange(n, device=device) >> sh) & 1
    return ar.to(dtype).reshape(shape)


def _flip_axis_bits(x3: torch.Tensor, axis: int, m: int, nbits: int
                    ) -> torch.Tensor:
    """XOR the index along `axis` (length 2^nbits) by mask m, via per-bit
    reshape + flip."""
    out = x3
    for k in range(nbits):
        if not (m >> k) & 1:
            continue
        shape = out.shape
        n = shape[axis]
        lead = tuple(shape[:axis])
        trail = tuple(shape[axis + 1:])
        out = out.reshape(lead + (n // (2 << k), 2, 1 << k) + trail)
        out = torch.flip(out, dims=(len(lead) + 1,))
        out = out.reshape(shape)
    return out


_PERM_CACHE: dict = {}


def _perm_matrix(nbits: int, m: int, dtype, device):
    key = (nbits, m)
    if key not in _PERM_CACHE:
        n = 1 << nbits
        dst = np.arange(n)
        M = np.zeros((n, n), dtype=np.float32)
        M[dst ^ m, dst] = 1.0
        _PERM_CACHE[key] = M
    return torch.as_tensor(_PERM_CACHE[key], dtype=dtype, device=device)


def _matmul_last(x3, M):
    """einsum('btw,wv->btv'); a complex x3 as its (re, im) real view."""
    if x3.is_complex():
        xr = torch.view_as_real(x3)  # [B, T, W, 2]
        out = torch.einsum("btwc,wv->btvc", xr, M)
        return torch.view_as_complex(out.contiguous())
    return torch.matmul(x3, M)


def _matmul_mid(x3, M):
    """einsum('rs,bsw->brw')."""
    if x3.is_complex():
        xr = torch.view_as_real(x3)
        out = torch.einsum("rs,bswc->brwc", M, xr)
        return torch.view_as_complex(out.contiguous())
    return torch.matmul(M, x3)


def _weighted(stack, idx, hop_J, rdtype, device):
    """sum_k hop_J[idx[k]] stack[k]: the folded bond matrix, in float64 on
    the host and then rounded once to the state's real dtype."""
    M = np.einsum("k,kab->ab", np.asarray(hop_J, np.float64)[idx],
                  stack.astype(np.float64))
    return torch.as_tensor(M, dtype=rdtype, device=device)


def apply_H_blocked(psi: torch.Tensor, model: SpinModel,
                    plan: BlockedPlan | None = None,
                    diag: torch.Tensor | None = None) -> torch.Tensor:
    """H|psi> for full/embedded layouts via the blocked formulation, in
    psi's dtype (float32/float64, complex64/complex128) on psi's device.
    Reads the N-sized diagonal `diag` (psi's real dtype, psi's device);
    None builds it for this one apply (model.diag), so a caller of many
    applies passes the one it holds."""
    if model.mode not in ("full", "embedded"):
        raise ValueError("blocked backend requires a full-space layout")
    if plan is None:
        plan = make_blocked_plan(model)
    L, w, t = plan.L, plan.w, plan.t
    W, T = plan.W, plan.T
    B = 1 << (L - w - t)
    dev = psi.device
    rdtype = real_dtype(psi.dtype)

    x3 = psi.reshape(B, T, W)
    if diag is None:
        diag = model.diag(dev, rdtype)
    out = (diag * psi).reshape(B, T, W)
    hop_J = model.hop_J

    if plan.cols_stack is not None:
        out = out + _matmul_last(x3, _weighted(plan.cols_stack, plan.cols_idx,
                                               hop_J, rdtype, dev))
    if plan.rows_stack is not None:
        out = out + _matmul_mid(x3, _weighted(plan.rows_stack, plan.rows_idx,
                                              hop_J, rdtype, dev))

    for (b, m_col, m_row, m_blk, bi, bj) in plan.special:
        y = x3
        if m_blk:
            y = _flip_axis_bits(y, 0, m_blk, L - w - t)
        if m_row:
            y = _matmul_mid(y, _perm_matrix(t, m_row, rdtype, dev))
        if m_col:
            y = _matmul_last(y, _perm_matrix(w, m_col, rdtype, dev))
        mask = torch.abs(_global_bit(bi, w, t, B, T, W, rdtype, dev)
                         - _global_bit(bj, w, t, B, T, W, rdtype, dev))
        out = out + float(hop_J[b]) * (mask * y)
    return out.reshape(-1)
