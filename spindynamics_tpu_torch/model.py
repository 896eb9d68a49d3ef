"""Spin model specification (port of spindynamics_tpu/model.py, sector_kron only).

The model is a frozen dataclass of host numpy couplings. Only the lean
sector_kron build exists here: the kron apply uses the layout's factored
diagonal, so no N-sized `states` or `diag` array is ever made. Site indices
are 0-based.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["SpinModel", "build_model", "nn_hopping", "long_range_hopping"]

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}
_TORCH_DTYPES = {np.dtype(v): k for k, v in _NP_DTYPES.items()}


@dataclasses.dataclass(frozen=True, eq=False)
class SpinModel:
    """XXZ-type spin-1/2 model in one U(1) sector on the sector_kron layout.

    H = sum_b Jxy_b (S+_i S-_j + S-_i S+_j) + sum_i h_i Sz_i + sum_z Jz Sz_i Sz_j

    The off-diagonal matrix element between states that differ on bits (i, j)
    is Jxy_b itself (no extra 1/2), as in the JAX package."""

    L: int
    nup: int
    field: np.ndarray   # [L]
    hop_i: np.ndarray   # int32 [nb]
    hop_j: np.ndarray   # int32 [nb]
    hop_J: np.ndarray   # [nb]
    zz_i: np.ndarray    # int32 [nz]
    zz_j: np.ndarray    # int32 [nz]
    zz_J: np.ndarray    # [nz]
    hop_sites: tuple
    zz_sites: tuple
    kron_splits: tuple
    kron_pads: tuple
    n_states_static: int        # padded kron length
    n_valid: int | None = None  # C(L, nup) when tile padding exists

    @property
    def n_states(self) -> int:
        return self.n_states_static

    @property
    def dim(self) -> int:
        return self.n_valid if self.n_valid is not None else self.n_states

    @property
    def dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.field.dtype]


def nn_hopping(L: int, J: float) -> list[tuple[int, int, float]]:
    """Nearest-neighbour open chain; 0-based sites."""
    return [(i, i + 1, float(J)) for i in range(L - 1)]


def long_range_hopping(L: int, J: Callable[[int, int], float]
                       ) -> list[tuple[int, int, float]]:
    """All-pairs coupling with user J(i, j); 0-based."""
    return [(i, j, float(J(i, j))) for i in range(L) for j in range(i + 1, L)]


def _couplings_to_arrays(couplings, L, dtype):
    if couplings is None or len(couplings) == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, dtype))
    arr = np.asarray([(int(i), int(j), float(J)) for (i, j, J) in couplings])
    i = arr[:, 0].astype(np.int32)
    j = arr[:, 1].astype(np.int32)
    if np.any(i < 0) or np.any(i >= L) or np.any(j < 0) or np.any(j >= L):
        raise ValueError("coupling site index out of range [0, L)")
    if np.any(i == j):
        raise ValueError("coupling with i == j")
    return i, j, arr[:, 2].astype(dtype)


def build_model(
    L: int,
    nup: int | None = None,
    hopping: Sequence[tuple[int, int, float]] | None = None,
    onsite_field: Sequence[float] | None = None,
    zz: Sequence[tuple[int, int, float]] | None = None,
    dtype: torch.dtype = torch.float32,
    layout: str = "sector_kron",
    kron_splits: tuple | None = None,
) -> SpinModel:
    """Create a sector_kron SpinModel (the lean build: couplings + layout
    metadata, no N-sized arrays)."""
    if layout != "sector_kron":
        raise NotImplementedError(
            f"layout={layout!r} is not ported yet: only 'sector_kron' is "
            "(ROADMAP Queue 1, item 11 for the flat path, item 12 for "
            "'embedded')")
    if nup is None:
        raise ValueError("layout='sector_kron' requires nup")
    if dtype not in _NP_DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"got {dtype}")
    from .ops.sector_kron import make_sector_kron_layout

    np_dtype = _NP_DTYPES[dtype]
    hop_i, hop_j, hop_J = _couplings_to_arrays(hopping, L, np_dtype)
    zz_i, zz_j, zz_J = _couplings_to_arrays(zz, L, np_dtype)
    field = (np.zeros(L, np_dtype) if onsite_field is None
             else np.asarray(onsite_field, dtype=np_dtype))
    if field.shape != (L,):
        raise ValueError(f"onsite_field must have shape ({L},)")
    hop_sites = tuple(zip(hop_i.tolist(), hop_j.tolist()))
    lay = make_sector_kron_layout(
        (L, nup, hop_sites, hop_J.astype(np.float64).tolist()),
        splits=kron_splits)
    return SpinModel(
        L=L, nup=nup, field=field,
        hop_i=hop_i, hop_j=hop_j, hop_J=hop_J,
        zz_i=zz_i, zz_j=zz_j, zz_J=zz_J,
        hop_sites=hop_sites,
        zz_sites=tuple(zip(zz_i.tolist(), zz_j.tolist())),
        kron_splits=lay.splits, kron_pads=lay.pads,
        n_states_static=lay.n_states,
        n_valid=(lay.n_basis if lay.n_states != lay.n_basis else None),
    )
