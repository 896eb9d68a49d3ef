"""Spin model specification (port of spindynamics_tpu/model.py).

The model is a frozen dataclass of host numpy couplings plus layout
metadata. Three layouts are ported: `sector_kron` (the lean build: the kron
apply uses the layout's factored diagonal), `embedded` (one U(1) sector run
inside the full 2^L space) and `full`. None of them stores an N-sized array:
`basis_states()` is an arange made on demand and `diag(device)` is built
lazily, in torch on the device that asks (only the plain blocked apply and
the dense oracle read it; the fused matvec kernel K3 never does). The
compact (ELL) and sector_blocked layouts are not ported. Site indices are
0-based.
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
    """XXZ-type spin-1/2 model on a bit-encoded basis.

    H = sum_b Jxy_b (S+_i S-_j + S-_i S+_j) + sum_i h_i Sz_i + sum_z Jz Sz_i Sz_j

    The off-diagonal matrix element between states that differ on bits (i, j)
    is Jxy_b itself (no extra 1/2), as in the JAX package."""

    L: int
    nup: int | None
    field: np.ndarray   # [L]
    hop_i: np.ndarray   # int32 [nb]
    hop_j: np.ndarray   # int32 [nb]
    hop_J: np.ndarray   # [nb]
    zz_i: np.ndarray    # int32 [nz]
    zz_j: np.ndarray    # int32 [nz]
    zz_J: np.ndarray    # [nz]
    hop_sites: tuple
    zz_sites: tuple
    kron_splits: tuple | None
    kron_pads: tuple | None
    n_states_static: int        # padded kron length, or 2^L
    n_valid: int | None = None  # C(L, nup) when tile padding exists
    mode: str = "sector_kron"   # 'sector_kron' | 'embedded' | 'full'

    @property
    def n_states(self) -> int:
        return self.n_states_static

    @property
    def n_bonds(self) -> int:
        return self.hop_i.shape[0]

    def _flat_only(self, what):
        if self.mode not in ("full", "embedded"):
            raise ValueError(f"{what} needs a full or embedded model, not "
                             f"mode={self.mode!r}")

    def basis_states(self, device="cpu") -> torch.Tensor:
        """The basis states of a full or embedded model: arange(2^L), int64,
        made on demand (never stored)."""
        self._flat_only("basis_states")
        return torch.arange(self.n_states, dtype=torch.int64, device=device)

    def valid_mask(self, device="cpu"):
        """Boolean [n_states] mask of logical rows: popcount(index) == nup
        for 'embedded' (the U(1) sector is an exact invariant subspace of H,
        so zeroing the complement once at state preparation keeps a whole
        computation in the sector); None for 'full'."""
        self._flat_only("valid_mask")
        if self.mode == "full":
            return None
        s = self.basis_states(device)
        cnt = torch.zeros_like(s)
        for i in range(self.L):
            cnt += (s >> i) & 1
        return cnt == self.nup

    def diag(self, device="cpu", dtype: torch.dtype | None = None
             ) -> torch.Tensor:
        """The diagonal of H, sum_i h_i sz_i + sum_z Jz sz_i sz_j, as an
        [n_states] tensor built in torch on `device` at every call: the
        model stores no N-sized array, whoever needs the diagonal more than
        once holds it (a blocked FlatHamiltonian keeps it as a buffer). The
        plain blocked apply and the dense oracle read it, K3 does not."""
        self._flat_only("diag")
        dtype = self.dtype if dtype is None else dtype
        s = self.basis_states(device)
        acc = torch.zeros(self.n_states, dtype=dtype, device=device)
        for i in np.nonzero(self.field)[0]:
            acc += float(self.field[i]) * (((s >> int(i)) & 1).to(dtype)
                                           - 0.5)
        for i, j, J in zip(self.zz_i, self.zz_j, self.zz_J):
            bi = ((s >> int(i)) & 1).to(dtype) - 0.5
            bj = ((s >> int(j)) & 1).to(dtype) - 0.5
            acc += float(J) * bi * bj
        return acc

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
    layout: str | None = None,
    kron_splits: tuple | None = None,
) -> SpinModel:
    """Create a SpinModel: couplings + layout metadata, no N-sized arrays.

    layout=None resolves by nup: the full 2^L space for nup=None, else
    'sector_kron' (the port's sector layout). layout='embedded' (with nup)
    runs the sector inside the full 2^L space, on the flat-state path whose
    H apply is K3 (ops/fused_matvec.py); layout='full' (or nup=None) is the
    full space on the same path. 'compact' with nup set (the ELL table) and
    'sector_blocked' are not ported."""
    if layout not in (None, "compact", "embedded", "full", "sector_blocked",
                      "sector_kron"):
        raise ValueError(f"unknown layout {layout!r}")
    if kron_splits is not None and layout not in (None, "sector_kron"):
        raise ValueError("kron_splits only applies to layout='sector_kron'")
    if layout is None:
        layout = "full" if nup is None else "sector_kron"
    if layout == "compact" and nup is None:
        layout = "full"  # the JAX package's nup=None: the full basis
    if layout == "compact":
        raise NotImplementedError(
            "layout='compact' with nup set (the ELL neighbour table) is not "
            "ported yet: ROADMAP Queue 1, item 1")
    if layout == "sector_blocked":
        raise NotImplementedError(
            "layout='sector_blocked' is not ported: ROADMAP Queue 1, item 10 "
            "(a candidate not to port)")
    if layout == "full" and nup is not None:
        raise ValueError("layout='full' takes nup=None; use "
                         "layout='embedded' for a sector in the full space")
    if layout in ("sector_kron", "embedded") and nup is None:
        raise ValueError(f"layout={layout!r} requires nup")
    if dtype not in _NP_DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"got {dtype}")
    if layout in ("embedded", "full") and L >= 30:
        raise ValueError(
            f"{layout} layout at L={L} needs 2^{L} amplitudes; use the "
            "sector_kron layout")

    np_dtype = _NP_DTYPES[dtype]
    hop_i, hop_j, hop_J = _couplings_to_arrays(hopping, L, np_dtype)
    zz_i, zz_j, zz_J = _couplings_to_arrays(zz, L, np_dtype)
    field = (np.zeros(L, np_dtype) if onsite_field is None
             else np.asarray(onsite_field, dtype=np_dtype))
    if field.shape != (L,):
        raise ValueError(f"onsite_field must have shape ({L},)")
    hop_sites = tuple(zip(hop_i.tolist(), hop_j.tolist()))
    if layout in ("embedded", "full"):
        return SpinModel(
            L=L, nup=nup, field=field,
            hop_i=hop_i, hop_j=hop_j, hop_J=hop_J,
            zz_i=zz_i, zz_j=zz_j, zz_J=zz_J,
            hop_sites=hop_sites,
            zz_sites=tuple(zip(zz_i.tolist(), zz_j.tolist())),
            kron_splits=None, kron_pads=None,
            n_states_static=1 << L, mode=layout)
    from .ops.sector_kron import make_sector_kron_layout

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
