"""The float64 reference of the open power-law (long-range) chain.

Written from the model's definition, with none of the port's code (torch
and reference.py only):

    H = sum_{i<j} |i - j|^-alpha [Jxy (S+_i S-_j + h.c.) + Jz Sz_i Sz_j]

on one Sz sector, in reference.BlockChain's block form (halves at L // 2,
bit j of a state is site j), so that every layout's `reference_state` and
reference.py's `energy`, `sqw_row` and `ground_state` take it unchanged.
It takes from BlockChain the block form alone: its sector tables (built
here by reference.py's `_part_tables` and `_sector`, as BlockChain builds
them) and the methods that read them (`block`, `from_kron`, `from_flat`,
`sz_q_weights`, `phi_q`). Its couplings and its apply are its own: none
of BlockChain's bonds (`Wh`, `Wl`, `diag`, `up`, `__call__`) is built or
called.
The configuration gives alpha, Jxy and Jz (Jz = 0 is the XY chain of
trapped ions; another Jz is a long-range XXZ chain, a configuration
only).

- Bonds inside a half: one weighted sparse matrix per block and axis,
  every pair of the half's sites at its distance.
- Bonds across the cut: grouped by the site i of the low half. For each i
  and block k, the high half's lowering sum_j |La + j - i|^-alpha S-_j is
  one sparse matrix from block k's rows to block k - 1's; the columns
  whose low part has site i down move to the columns with it up. Its
  transpose takes the hermitian conjugate back. So an apply makes La
  passes over each pair of neighbouring blocks, not one per pair of sites.
- The diagonal: each half's Sz Sz sums as one vector per axis, the cut's
  as a product through the [Lb, La] matrix of its couplings.
"""

from __future__ import annotations

import math
import warnings

import torch

from .. import reference

F64 = torch.float64


class _Pattern:
    """The CSR pattern of distinct COO entries (rows, cols) of a matrix of
    `shape`; `matrix(vals)` puts the entries' values (COO order) on it, so
    that matrices of one pattern share its index tensors."""

    def __init__(self, rows, cols, shape, device):
        self.order = torch.argsort(rows * shape[1] + cols)
        self.cols = cols[self.order]
        self.crow = torch.zeros(shape[0] + 1, dtype=torch.int64,
                                device=device)
        self.crow[1:] = torch.cumsum(
            torch.bincount(rows, minlength=shape[0]), 0)
        self.shape = shape

    def matrix(self, vals):
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(
                self.crow, self.cols, vals[self.order], size=self.shape,
                check_invariants=False)


def _hops(states, bits, rank, w, device):
    """sum_{a<b} w(b - a) (S+_a S-_b + h.c.) inside a part, on its sector
    `states`: entry (r, r') where state r' is state r with one antiparallel
    pair (a, b) flipped. CSR, or None where the part has no such pair."""
    rows, cols, vals = [], [], []
    for a in range(bits):
        for b in range(a + 1, bits):
            differ = ((states >> a) ^ (states >> b)) & 1
            r = torch.nonzero(differ).squeeze(1)
            rows.append(r)
            cols.append(rank[states[r] ^ ((1 << a) | (1 << b))])
            vals.append(torch.full((r.numel(),), w(b - a), dtype=F64,
                                   device=device))
    if sum(r.numel() for r in rows) == 0:
        return None
    n = states.numel()
    return _Pattern(torch.cat(rows), torch.cat(cols), (n, n),
                    device).matrix(torch.cat(vals))


def _zz(states, bits, w):
    """sum_{a<b} w(b - a) Sz_a Sz_b over the pairs inside a part."""
    z = _spins(states, bits)
    d = torch.zeros(states.numel(), dtype=F64, device=states.device)
    for a in range(bits):
        for b in range(a + 1, bits):
            d += w(b - a) * z[:, a] * z[:, b]
    return d


def _spins(states, bits):
    """[n, bits]: Sz of each site of each state (+-1/2)."""
    j = torch.arange(bits, device=states.device)
    return ((states[:, None] >> j) & 1).to(F64) - 0.5


class Chain(reference.BlockChain):
    """H of the open power-law chain on the Sz sector of L sites with nup
    up spins, on float64 states in block form."""

    def __init__(self, model: dict, device):
        L, nup = model["L"], model["nup"]
        self.L, self.nup, self.device = L, nup, device
        self.Jxy, self.Jz = float(model["Jxy"]), float(model["Jz"])
        self.alpha = float(model["alpha"])
        self.La = La = L // 2
        self.Lb = Lb = L - La
        # the block form: BlockChain's sector tables, in its order
        self.popA, self.rankA = reference._part_tables(La, device)
        self.popB, self.rankB = reference._part_tables(Lb, device)
        self.ks = [k for k in range(Lb + 1) if 0 <= nup - k <= La]
        self.hs, self.ls, self.off = {}, {}, {}
        off = 0
        for k in self.ks:
            self.hs[k] = reference._sector(Lb, k, self.popB)
            self.ls[k] = reference._sector(La, nup - k, self.popA)
            self.off[k] = off
            off += self.hs[k].numel() * self.ls[k].numel()
        self.n = off
        if off != math.comb(L, nup):
            raise AssertionError("blocks do not cover the sector")

        def w(d):
            return float(d) ** -self.alpha

        # the bonds inside each half: one weighted matrix per block and axis
        self.inside_h = {k: _hops(self.hs[k], Lb, self.rankB, w, device)
                         for k in self.ks}
        self.inside_l = {k: _hops(self.ls[k], La, self.rankA, w, device)
                         for k in self.ks}
        W = torch.tensor([[w(La + j - i) for i in range(La)]
                          for j in range(Lb)], dtype=F64, device=device)
        self.zz = torch.empty(self.n, dtype=F64, device=device)
        for k in self.ks:
            zh, zl = _spins(self.hs[k], Lb), _spins(self.ls[k], La)
            self.block(self.zz, k).copy_(
                self.Jz * (_zz(self.hs[k], Lb, w)[:, None]
                           + _zz(self.ls[k], La, w)[None, :]
                           + (zh @ W) @ zl.T))
        # across the cut, per low site i: (k, columns of block k with site
        # i down, their columns in block k - 1 with it up, the high half's
        # lowering B [rows k - 1, rows k], its transpose)
        self.cross = []
        for k in self.ks:
            if k - 1 not in self.off:
                continue
            h, lo = self.hs[k], self.ls[k]
            rows, cols, js = [], [], []
            for j in range(Lb):
                r = torch.nonzero((h >> j) & 1).squeeze(1)
                rows.append(self.rankB[h[r] ^ (1 << j)])
                cols.append(r)
                js.append(torch.full_like(r, j))
            rows, cols, js = torch.cat(rows), torch.cat(cols), torch.cat(js)
            shape = (self.hs[k - 1].numel(), h.numel())
            down = _Pattern(rows, cols, shape, device)
            back = _Pattern(cols, rows, shape[::-1], device)
            for i in range(La):
                cs = torch.nonzero(((lo >> i) & 1) == 0).squeeze(1)
                cd = self.rankA[lo[cs] | (1 << i)]
                self.cross.append((k, cs, cd, down.matrix(W[js, i]),
                                   back.matrix(W[js, i])))

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        """H v (float64, block form)."""
        out = torch.mul(v, self.zz)
        J = self.Jxy
        for k in self.ks:
            Y, O = self.block(v, k), self.block(out, k)
            if self.inside_h[k] is not None:
                O.add_(self.inside_h[k] @ Y, alpha=J)
            if self.inside_l[k] is not None:
                O.add_((self.inside_l[k] @ Y.T.contiguous()).T, alpha=J)
        for k, cs, cd, B, Bt in self.cross:
            # S+_i S-_j: block k, columns cs -> block k - 1, columns cd;
            # and its conjugate back
            self.block(out, k - 1).index_add_(
                1, cd, B @ self.block(v, k).index_select(1, cs), alpha=J)
            self.block(out, k).index_add_(
                1, cs, Bt @ self.block(v, k - 1).index_select(1, cd),
                alpha=J)
        return out
