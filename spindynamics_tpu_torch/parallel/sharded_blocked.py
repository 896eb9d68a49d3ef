"""Explicitly scheduled row-sharded blocked apply of a full or embedded
model (port of spindynamics_tpu/parallel/sharded_blocked.py).

The state is viewed as [B, T, W] (ops/blocked.py) and sharded on the block
axis over D shards of a LocalMesh or a ProcessMesh: N = 2^L and D is a
power of two, so the mesh owns the TOP block bits and each shard holds
B_loc = B / D blocks.

  - the diagonal, the folded [W, W] and [T, T] products and the bonds whose
    bits all lie below the shard boundary apply to each shard's blocks
    alone (the unsharded blocked apply's terms, unchanged);
  - a bond with a bit above the boundary pairs shard s with shard
    s XOR (m_blk / B_loc): one pairwise exchange (`permute_rows`, JAX's
    ppermute) brings the partner shard's blocks, then the residual local
    block flip, the row and column permutation products and the
    bits-differ mask.

Communication per apply: one whole-shard exchange per shard-crossing bond
(for a nearest-neighbour chain on 2^d shards, d bonds). Plain torch on
every device, as the JAX shard_map program is XLA code.
"""

from __future__ import annotations

import torch
from torch import nn

from ..model import SpinModel
from ..ops.blocked import (
    BlockedPlan, _flip_axis_bits, _matmul_last, _matmul_mid, _perm_matrix,
    _weighted, make_blocked_plan)
from ..utils.device import resolve_device
from ..utils.dtypes import real_dtype
from .mesh import ROWS

__all__ = ["sharded_blocked_matvec_fn", "ShardedBlockedHamiltonian"]


class ShardedBlockedHamiltonian(nn.Module):
    """H on the block shards of a full or embedded state over `mesh`:
    psi -> H psi on "the rows of this process's shards" (a LocalMesh: the
    whole vector [2^L]; a ProcessMesh rank: its 2^L / D rows). The
    diagonal of those rows is a buffer (`diag`, from the model's build on
    the device, in `dtype`); the folded products are built once per real
    dtype. plan=None takes the default plan, with fewer middle bits (then
    low bits) where the mesh needs more blocks than it has."""

    def __init__(self, model: SpinModel, mesh, plan: BlockedPlan | None = None,
                 device=None, dtype: torch.dtype | None = None):
        super().__init__()
        if model.mode not in ("full", "embedded"):
            raise ValueError("the sharded blocked apply requires a "
                             "full-space layout (full or embedded)")
        if plan is None:
            plan = _plan_for(model, mesh.D)
        D = mesh.D
        B = 1 << (plan.L - plan.w - plan.t)
        if D & (D - 1):
            raise ValueError(f"shard count must be a power of two, not {D}")
        if B % D:
            raise ValueError(f"B={B} blocks not divisible by {D} shards")
        device = resolve_device(device, mesh=mesh)
        self.model, self.mesh, self.plan = model.logical(), mesh, plan
        self.B_loc = B // D
        # block bits below the shard boundary (at least one, as in JAX)
        self.loc_bits = max((self.B_loc - 1).bit_length(), 1)
        self.local_specials, self.crossing = [], []
        for (bidx, m_col, m_row, m_blk, bi, bj) in plan.special:
            shard_xor, local_xor = divmod(m_blk, self.B_loc)
            if shard_xor == 0:
                self.local_specials.append((bidx, m_col, m_row, m_blk, bi,
                                            bj))
            else:
                self.crossing.append((bidx, shard_xor, local_xor, m_row,
                                      m_col, bi, bj))
        rows = mesh.row_slice(self.B_loc * plan.T * plan.W)
        diag = self.model.diag(device, real_dtype(dtype or model.dtype))
        self.register_buffer(
            "diag", diag[rows].clone() if mesh.n_local < D else diag,
            persistent=False)
        self._folded = {}

    @property
    def device(self):
        return self.diag.device

    def _products(self, rdtype):
        """The folded column and row matrices (the unsharded apply's, in
        float64 on the host, rounded once) and the permutation matrices,
        built once per real dtype."""
        if rdtype not in self._folded:
            p, J, dev = self.plan, self.model.hop_J, self.device
            perms = {}
            for (_, m_col, m_row, *_r) in self.plan.special:
                if m_row:
                    perms[(p.t, m_row)] = _perm_matrix(p.t, m_row, rdtype, dev)
                if m_col:
                    perms[(p.w, m_col)] = _perm_matrix(p.w, m_col, rdtype, dev)
            self._folded[rdtype] = (
                None if p.cols_stack is None else
                _weighted(p.cols_stack, p.cols_idx, J, rdtype, dev),
                None if p.rows_stack is None else
                _weighted(p.rows_stack, p.rows_idx, J, rdtype, dev), perms)
        return self._folded[rdtype]

    def _bit(self, bit, n, rdtype):
        """0/1 broadcastable over this process's [n, T, W] for a global
        bit (block bits read from the global block index)."""
        p = self.plan
        if bit < p.w:
            ar, shape = torch.arange(p.W, device=self.device) >> bit, (1, 1,
                                                                        p.W)
        elif bit < p.w + p.t:
            ar = torch.arange(p.T, device=self.device) >> (bit - p.w)
            shape = (1, p.T, 1)
        else:
            b0 = self.mesh.row_slice(self.B_loc).start
            ar = (torch.arange(b0, b0 + n, device=self.device)
                  >> (bit - p.w - p.t))
            shape = (n, 1, 1)
        return (ar & 1).to(rdtype).reshape(shape)

    def _term(self, out, y, bidx, m_row, m_col, bi, bj, perms, rdtype):
        p = self.plan
        if m_row:
            y = _matmul_mid(y, perms[(p.t, m_row)])
        if m_col:
            y = _matmul_last(y, perms[(p.w, m_col)])
        n = y.shape[0]
        mask = torch.abs(self._bit(bi, n, rdtype) - self._bit(bj, n, rdtype))
        return out + float(self.model.hop_J[bidx]) * (mask * y)

    def forward(self, psi: torch.Tensor) -> torch.Tensor:
        """One apply, in the span `apply.sharded_blocked` and the counter
        `applies.sharded_blocked` (utils/profiling.py)."""
        from ..utils.profiling import annotate, count

        count("applies.sharded_blocked")
        with annotate("apply.sharded_blocked"):
            return self._forward(psi)

    def _forward(self, psi: torch.Tensor) -> torch.Tensor:
        p = self.plan
        rdtype = real_dtype(psi.dtype)
        n = psi.shape[0] // (p.T * p.W)
        x3 = psi.reshape(n, p.T, p.W)
        out = (self.diag.to(rdtype) * psi).reshape(n, p.T, p.W)
        cols, rows, perms = self._products(rdtype)
        if cols is not None:
            out = out + _matmul_last(x3, cols)
        if rows is not None:
            out = out + _matmul_mid(x3, rows)
        for (bidx, m_col, m_row, m_blk, bi, bj) in self.local_specials:
            y = _flip_axis_bits(x3, 0, m_blk, self.loc_bits) if m_blk else x3
            out = self._term(out, y, bidx, m_row, m_col, bi, bj, perms,
                             rdtype)
        D = self.mesh.D
        for (bidx, shard_xor, local_xor, m_row, m_col, bi,
             bj) in self.crossing:
            # the partner shard's blocks, over the mesh
            y = self.mesh.permute_rows(
                x3, [(s, s ^ shard_xor) for s in range(D)])
            if local_xor:
                y = _flip_axis_bits(y, 0, local_xor, self.loc_bits)
            out = self._term(out, y, bidx, m_row, m_col, bi, bj, perms,
                             rdtype)
        return out.reshape(-1)


def _plan_for(model, D: int) -> BlockedPlan:
    """The default blocked plan, its t (then w) cut until the block axis
    has at least D blocks."""
    plan = make_blocked_plan(model)
    w, t = plan.w, plan.t
    while (1 << (model.L - w - t)) < D and w + t > 0:
        if t > 0:
            t -= 1
        else:
            w -= 1
    return plan if (w, t) == (plan.w, plan.t) else make_blocked_plan(
        model, w, t)


def sharded_blocked_matvec_fn(model: SpinModel, mesh, axis_name: str = ROWS,
                              plan: BlockedPlan | None = None, device=None):
    """The hand-scheduled sharded blocked H apply of a full or embedded
    model over `mesh`: a matvec on the rows of this process's shards of a
    flat state [2^L] (shard_state). The shard count must be a power of two
    that divides the block count (it owns the top block bits). `axis_name`
    is the JAX package's (the meshes have one axis); `device` defaults to
    the mesh's, else the card."""
    return ShardedBlockedHamiltonian(model, mesh, plan=plan, device=device)
