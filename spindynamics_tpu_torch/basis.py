"""Bit-encoded U(1)-sector bases on the host (port of spindynamics_tpu/basis.py).

Only the host functions the sector_kron layout needs: states are uint32 values
sorted ascending (colexicographic combinadic order), so the rank of a state is
the closed form sum_t C(p_t, t) over its ascending set-bit positions.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

__all__ = ["binomial_table", "sector_dimension", "build_sector_basis",
           "rank_state"]

MAX_L = 32  # uint32 states


def binomial_table(L: int, kmax: int | None = None) -> np.ndarray:
    """Pascal-triangle LUT C[n, k] for 0 <= n <= L, 0 <= k <= kmax (int64)."""
    if kmax is None:
        kmax = L
    C = np.zeros((L + 1, kmax + 1), dtype=np.int64)
    C[:, 0] = 1
    for n in range(1, L + 1):
        hi = min(n, kmax)
        C[n, 1: hi + 1] = C[n - 1, 1: hi + 1] + C[n - 1, 0:hi]
    return C


def sector_dimension(L: int, nup: int) -> int:
    return math.comb(L, nup)


@lru_cache(maxsize=None)
def _sector_states_cached(L: int, nup: int) -> np.ndarray:
    """Ascending L-bit states with popcount nup:
    S(L, k) = S(L-1, k) ++ (S(L-1, k-1) | 2^(L-1)), both halves ascending."""
    if nup == 0:
        return np.zeros(1, dtype=np.uint32)
    if nup == L:
        return np.array([(1 << L) - 1], dtype=np.uint32)
    lo = _sector_states_cached(L - 1, nup)
    hi = _sector_states_cached(L - 1, nup - 1) | np.uint32(1 << (L - 1))
    out = np.concatenate([lo, hi])
    out.flags.writeable = False
    return out


def build_sector_basis(L: int, nup: int) -> np.ndarray:
    """All states with exactly nup set bits, ascending."""
    if not 1 <= L <= MAX_L:
        raise ValueError(f"L must be in [1, {MAX_L}], got {L}")
    if not 0 <= nup <= L:
        raise ValueError(f"nup must be in [0, {L}], got {nup}")
    return _sector_states_cached(L, nup).copy()


def rank_state(state: int, L: int, nup: int) -> int:
    """Host scalar rank of one state in the ascending sector basis."""
    rank, cnt = 0, 0
    for p in range(L):
        if (state >> p) & 1:
            cnt += 1
            rank += math.comb(p, cnt)
    return rank
