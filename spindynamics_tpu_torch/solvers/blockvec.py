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

__all__ = ["BlockVec", "bv_zeros_like", "bv_random", "bv_basis_state",
           "bv_matvec_fn"]


class BlockVec:
    """List-of-tensors state with leaf-wise vector-space operators."""

    __slots__ = ("leaves",)

    def __init__(self, leaves):
        self.leaves = list(leaves)

    @property
    def dtype(self):
        return self.leaves[0].dtype

    @property
    def device(self):
        return self.leaves[0].device

    def astype(self, dtype):
        return BlockVec([l.to(dtype) for l in self.leaves])

    def _binop(self, other, f):
        if isinstance(other, BlockVec):
            return BlockVec([f(a, b) for a, b in zip(self.leaves, other.leaves)])
        return BlockVec([f(a, other) for a in self.leaves])

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
        return BlockVec([-a for a in self.leaves])


def _cast(s, dtype):
    """Cast a scalar operand to the leaf dtype (x * s.astype(dtype))."""
    return s.to(dtype) if isinstance(s, torch.Tensor) else s


def bv_zeros_like(x):
    if isinstance(x, BlockVec):
        return BlockVec([torch.zeros_like(l) for l in x.leaves])
    return torch.zeros_like(x)


def bv_random(layout, generator: torch.Generator, dtype=torch.float32,
              device=None) -> BlockVec:
    """Random normal BlockVec over a SectorKronLayout, zero in tile-pad slots
    (the pad slots are an invariant null subspace of the apply, so zeroing
    them once keeps them exactly zero). The numbers are drawn on the
    generator's device, then moved to `device` (default: the card, as for
    every state constructor, since a state decides where a solver runs; pass
    device="cpu" for a CPU state). bfloat16 leaves are float32 draws,
    rounded."""
    device = resolve_device(device)
    draw = torch.float32 if dtype == torch.bfloat16 else dtype
    leaves = []
    for (k_h, k_m, k_l, ch, cm, cl, cmp, clp) in layout.groups:
        x = torch.randn((ch, cmp, clp), generator=generator, dtype=draw,
                        device=generator.device).to(device=device,
                                                    dtype=dtype)
        if cmp != cm or clp != cl:
            x[:, cm:, :] = 0
            x[:, :, cl:] = 0
        leaves.append(x)
    return BlockVec(leaves)


def bv_basis_state(layout, bitstring: int, dtype=torch.float32,
                   device=None) -> BlockVec:
    """One-hot |bitstring> as a BlockVec on `device` (default: the card;
    pass device="cpu" for a CPU state)."""
    from .. import basis as basis_mod
    from ..ops.sector_kron import kron_part_perms

    L1, L2, L3 = layout.splits
    perms = kron_part_perms(layout.splits)

    def internal(sub, Lp, perm):
        v = 0
        for rel in range(Lp):
            v |= ((sub >> rel) & 1) << perm[rel]
        return v

    lo = internal(bitstring & ((1 << L1) - 1), L1, perms[0])
    mid = internal((bitstring >> L1) & ((1 << L2) - 1), L2, perms[1])
    hi = internal(bitstring >> (L1 + L2), L3, perms[2])
    k_h = bin(hi).count("1")
    k_m = bin(mid).count("1")
    k_l = bin(lo).count("1")
    if k_h + k_m + k_l != layout.nup:
        raise ValueError(f"state {bitstring:#x} has wrong magnetization for "
                         f"nup={layout.nup}")
    device = resolve_device(device)
    leaves = []
    for (gkh, gkm, gkl, ch, cm, cl, cmp, clp) in layout.groups:
        leaf = torch.zeros((ch, cmp, clp), dtype=dtype, device=device)
        if (gkh, gkm) == (k_h, k_m):
            leaf[basis_mod.rank_state(hi, L3, k_h),
                 basis_mod.rank_state(mid, L2, k_m),
                 basis_mod.rank_state(lo, L1, k_l)] = 1
        leaves.append(leaf)
    return BlockVec(leaves)


def bv_matvec_fn(layout, tables=None):
    """H-apply closure on BlockVec states (the plain blocks-mode apply)."""
    from ..ops.sector_kron import apply_H_sector_kron

    def matvec(bv):
        return BlockVec(apply_H_sector_kron(bv.leaves, None, layout, tables))

    return matvec
