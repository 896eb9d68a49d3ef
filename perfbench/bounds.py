"""The yardstick's rates and the least time of the operations the readers
hold to them (NVIDIA H100 SXM data sheet, dense rates, at its 700 W
limit). Copied from the legacy benchmark's benchmark/cells.py, which later
PRs may change; none of it depends on how the port implements an
operation."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = 989e12


def bytes_ms(n_bytes: float) -> float:
    """The least time to move `n_bytes` through HBM once, in ms."""
    return n_bytes / HBM_BYTES_PER_S * 1e3


def apply_bound_ms(n_basis: int, n_bonds: int, itemsize: int = 4) -> float:
    """The least time of one H apply, whatever implements it: the larger of
    the state read and H psi written once over the sector's amplitudes at
    the card's memory rate, and one multiply-add per nonzero of H (nnz =
    C(L, L/2)(1 + n_bonds/2): the diagonal and half of each bond's flips)
    at its fastest rate."""
    t_bytes = bytes_ms(2.0 * n_basis * itemsize)
    t_ops = 2.0 * n_basis * (1.0 + n_bonds / 2.0) / PEAK_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops)
