"""BlockVec: a state stored as one tensor per kron group (port of
spindynamics_tpu/solvers/blockvec.py).

A sector_kron state is a list of rank-3 group tensors [C_h, C_m_pad, C_l_pad].
BlockVec wraps that list with leaf-wise vector-space operators so the solvers
(Lanczos, Chebyshev) run on it through their inner-product call sites.
Scalars (Python numbers or 0-d tensors) broadcast to every leaf.
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device

__all__ = ["BlockVec", "bv_reduce", "bv_zeros_like", "bv_where_mask",
           "bv_random", "bv_basis_state", "bv_matvec_fn"]


class BlockVec:
    """List-of-tensors state with leaf-wise vector-space operators.

    `mesh` (optional) marks a row-sharded state (parallel/mesh.py): the
    leaves hold the rows of this process's shards, every operator hands the
    mesh on to its result, and every reduction to a scalar ends in
    `bv_reduce`, the mesh's sum over processes. A BlockVec without a mesh
    behaves as it always did."""

    __slots__ = ("leaves", "mesh")

    def __init__(self, leaves, mesh=None):
        self.leaves = list(leaves)
        self.mesh = mesh

    @property
    def dtype(self):
        return self.leaves[0].dtype

    @property
    def device(self):
        return self.leaves[0].device

    def like(self, leaves):
        """A BlockVec of `leaves` on this one's mesh."""
        return BlockVec(leaves, self.mesh)

    def map(self, f):
        """f applied to every leaf, on this one's mesh."""
        return BlockVec([f(l) for l in self.leaves], self.mesh)

    def astype(self, dtype):
        return self.map(lambda l: l.to(dtype))

    def _binop(self, other, f):
        if isinstance(other, BlockVec):
            return BlockVec([f(a, b) for a, b in zip(self.leaves,
                                                     other.leaves)],
                            self.mesh if self.mesh is not None
                            else other.mesh)
        return self.map(lambda a: f(a, other))

    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b)

    def __radd__(self, other):
        return self._binop(other, lambda a, b: b + a)

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._binop(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * _cast(b, a.dtype))

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        return self._binop(other, lambda a, b: a / _cast(b, a.dtype))

    def __neg__(self):
        return self.map(lambda a: -a)


def bv_reduce(x, *bvs):
    """Finish a reduction over BlockVec leaves: `x` (a tensor summed over
    this process's rows) summed over the processes of the first mesh found
    among `bvs`; `x` itself when none has one."""
    for bv in bvs:
        mesh = getattr(bv, "mesh", None)
        if mesh is not None:
            return mesh.all_reduce_sum(x)
    return x


def _cast(s, dtype):
    """Cast a scalar operand to the leaf dtype (x * s.astype(dtype))."""
    return s.to(dtype) if isinstance(s, torch.Tensor) else s


def bv_zeros_like(x):
    if isinstance(x, BlockVec):
        return x.map(torch.zeros_like)
    return torch.zeros_like(x)


def bv_where_mask(mask, x):
    """x where mask (leaf-wise) else 0: masking to a valid subspace."""
    if isinstance(x, BlockVec):
        return x.like([torch.where(m, l, torch.zeros_like(l))
                       for m, l in zip(mask.leaves, x.leaves)])
    return torch.where(mask, x, torch.zeros_like(x))


def _shard_rows(x, gi, shard):
    """x's rows that `shard` = (spec, mesh) gives this process: the hi axis
    zero-padded to the padded length, cut to the mesh's rows."""
    if shard is None:
        return x
    spec, mesh = shard
    x = torch.nn.functional.pad(
        x, (0, 0, 0, 0, 0, spec.ch_pad[gi] - x.shape[0]))
    rows = x[mesh.row_slice(spec.b[gi])]
    # a rank's part is copied, so that the whole group can be freed
    return rows if rows.shape[0] == x.shape[0] else rows.clone()


def bv_random(layout, generator: torch.Generator, dtype=torch.float32,
              device=None, shard=None) -> BlockVec:
    """Random normal BlockVec over a SectorKronLayout, zero in tile-pad slots
    (the pad slots are an invariant null subspace of the apply, so zeroing
    them once keeps them exactly zero). The numbers are drawn on the
    generator's device, then moved to `device` (default: the card, as for
    every state constructor, since a state decides where a solver runs; pass
    device="cpu" for a CPU state). bfloat16 leaves are float32 draws,
    rounded. `shard=(spec, mesh)` returns the sharded form of the same
    draw on that mesh: each group is drawn whole, in the unsharded order,
    and cut to this process's rows before it is moved, so every rank of a
    ProcessMesh draws the same state and keeps its part."""
    device = resolve_device(device)
    draw = torch.float32 if dtype == torch.bfloat16 else dtype
    leaves = []
    for gi, (k_h, k_m, k_l, ch, cm, cl, cmp, clp) in enumerate(
            layout.groups):
        x = _shard_rows(
            torch.randn((ch, cmp, clp), generator=generator, dtype=draw,
                        device=generator.device), gi, shard
        ).to(device=device, dtype=dtype)
        if cmp != cm or clp != cl:
            x[:, cm:, :] = 0
            x[:, :, cl:] = 0
        leaves.append(x)
    return BlockVec(leaves, None if shard is None else shard[1])


def bv_basis_state(layout, bitstring: int, dtype=torch.float32,
                   device=None, shard=None) -> BlockVec:
    """One-hot |bitstring> as a BlockVec on `device` (default: the card;
    pass device="cpu" for a CPU state). `shard=(spec, mesh)` makes the
    sharded form on that mesh directly (this process's rows only). A state
    outside the layout's sector raises ValueError."""
    from ..ops.sector_kron import kron_rank

    if bin(bitstring).count("1") != layout.nup or bitstring >> layout.L:
        raise ValueError(f"state {bitstring:#x} has wrong magnetization for "
                         f"nup={layout.nup}")
    r = kron_rank(bitstring, layout.L, layout.nup, layout.splits,
                  layout.pads)
    device = resolve_device(device)
    leaves = []
    for gi, (_, _, _, ch, cm, cl, cmp, clp) in enumerate(layout.groups):
        rows = range(ch)
        if shard is not None:
            spec, mesh = shard
            rows = range(spec.ch_pad[gi])[mesh.row_slice(spec.b[gi])]
        leaf = torch.zeros((len(rows), cmp, clp), dtype=dtype, device=device)
        o = r - layout.offsets[gi]
        if 0 <= o < ch * cmp * clp:
            h, m, l = o // (cmp * clp), (o // clp) % cmp, o % clp
            if h in rows:
                leaf[h - rows[0], m, l] = 1
        leaves.append(leaf)
    return BlockVec(leaves, None if shard is None else shard[1])


def bv_matvec_fn(layout, tables=None):
    """H-apply closure on BlockVec states (the plain blocks-mode apply)."""
    from ..ops.sector_kron import apply_H_sector_kron

    def matvec(bv):
        return BlockVec(apply_H_sector_kron(bv.leaves, None, layout, tables))

    return matvec
