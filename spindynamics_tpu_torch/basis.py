"""Bit-encoded spin-1/2 bases (port of spindynamics_tpu/basis.py).

Host numpy constructors: sector states are uint32 values sorted ascending
(colexicographic combinadic order), so the rank of a state is the closed
form sum_t C(p_t, t) over its ascending set-bit positions; in the full basis
a state's value is its index. The bit helpers act on numpy arrays or torch
tensors of states. `rank_states` and `unrank_states` are the vectorized
rank and unrank on torch tensors, on whatever device the tensor lies: the
compact layout enumerates a sector on the card with them. States are int64
tensors (bit 31 is set at L = 32, and the card has few uint32 kernels);
indices into a sector fit int32 (C(32, 16) < 2^31).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np

__all__ = ["binomial_table", "sector_dimension", "build_full_basis",
           "build_sector_basis", "rank_state", "rank_states", "unrank",
           "unrank_states", "bit_at", "sz_value", "flip_bits"]

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


def build_full_basis(L: int) -> np.ndarray:
    """All 2^L states; state value == basis index."""
    if not 1 <= L <= MAX_L:
        raise ValueError(f"L must be in [1, {MAX_L}], got {L}")
    if L >= 28:
        raise ValueError(
            f"full basis at L={L} has 2^{L} states; use a sector basis")
    return np.arange(1 << L, dtype=np.uint32)


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


def _binom_tensor(binom, device):
    import torch

    return torch.as_tensor(np.asarray(binom) if not isinstance(
        binom, torch.Tensor) else binom, dtype=torch.int64, device=device)


def rank_states(states, L: int, binom):
    """Vectorized combinadic rank: the index of each state (an int64 tensor)
    in the ascending sector basis, sum over set bits (ascending positions
    p, running count t) of C(p, t). `binom` is binomial_table(L, nup)
    (numpy or a tensor). Returns int64 on the states' device."""
    import torch

    b = _binom_tensor(binom, states.device)
    kmax = b.shape[1] - 1
    rank = torch.zeros_like(states, dtype=torch.int64)
    cnt = torch.zeros_like(rank)
    for p in range(L):
        bit = (states >> p) & 1
        cnt += bit
        # C(p, cnt), added where the bit is set; the count clamped as in the
        # JAX package (it never exceeds nup on states of the sector)
        rank += bit * b[p][cnt.clamp(max=kmax)]
    return rank


def unrank_states(idx, L: int, nup: int, binom):
    """Vectorized combinadic unrank: sector indices (a tensor) -> int64
    states, L passes from the top bit down. unrank_states(arange(N)) is the
    sector enumerated on the tensor's device."""
    import torch

    b = _binom_tensor(binom, idx.device)
    kmax = b.shape[1] - 1
    idx = idx.to(torch.int64, copy=True)
    state = torch.zeros_like(idx)
    k = torch.full_like(idx, nup)
    for p in range(L - 1, -1, -1):
        c = b[p][k.clamp(0, kmax)]
        take = (k > 0) & (idx >= c)
        state |= take.to(torch.int64) << p
        idx -= torch.where(take, c, 0)
        k -= take.to(torch.int64)
    return state


def unrank(idx: int, L: int, nup: int) -> int:
    """Host inverse of rank_state: idx -> state bitstring (colex
    combinadic)."""
    state, k = 0, nup
    for p in range(L - 1, -1, -1):
        if k == 0:
            break
        c = math.comb(p, k)
        if idx >= c:
            state |= 1 << p
            idx -= c
            k -= 1
    return state


def bit_at(states, i: int):
    """Value (0/1) of bit i of each state (numpy array or torch tensor)."""
    return (states >> i) & 1


def sz_value(bits, dtype=None):
    """S^z eigenvalue +-0.5 from a 0/1 bit. dtype defaults to float32 (a
    torch dtype for tensors, a numpy dtype for arrays)."""
    import torch

    if isinstance(bits, torch.Tensor):
        return bits.to(torch.float32 if dtype is None else dtype) - 0.5
    return np.asarray(bits).astype(np.float32 if dtype is None else dtype) - 0.5


def flip_bits(states, i: int, j: int):
    """XOR-flip bits i and j of each state."""
    return states ^ ((1 << i) | (1 << j))
