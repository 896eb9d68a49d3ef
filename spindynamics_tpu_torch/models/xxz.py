"""XXZ chain constructors (port of spindynamics_tpu/models/xxz.py)."""

from __future__ import annotations

import torch

from ..model import SpinModel, build_model, long_range_hopping, nn_hopping

__all__ = ["xxz_chain", "heisenberg_chain", "xy_chain", "long_range_xy_chain"]


def xxz_chain(
    L: int,
    Jxy: float = 1.0,
    Jz: float = 0.5,
    h=None,
    nup: int | None = None,
    dtype: torch.dtype = torch.float32,
    **kwargs,
) -> SpinModel:
    """Open XXZ chain: H = sum_i Jxy (S+_i S-_{i+1} + h.c.)
    + Jz Sz_i Sz_{i+1} + sum_i h_i Sz_i."""
    zz = [(i, i + 1, float(Jz)) for i in range(L - 1)]
    return build_model(L, nup=nup, hopping=nn_hopping(L, Jxy),
                       onsite_field=h, zz=zz, dtype=dtype, **kwargs)


def heisenberg_chain(L: int, J: float = 1.0, nup: int | None = None,
                     **kwargs) -> SpinModel:
    """Isotropic Heisenberg chain (Jxy = Jz = J)."""
    return xxz_chain(L, Jxy=J, Jz=J, nup=nup, **kwargs)


def xy_chain(L: int, Jxy: float = 1.0, nup: int | None = None,
             **kwargs) -> SpinModel:
    """XY chain (Jz = 0)."""
    return xxz_chain(L, Jxy=Jxy, Jz=0.0, nup=nup, **kwargs)


def long_range_xy_chain(L: int, J, nup: int | None = None,
                        dtype: torch.dtype = torch.float32,
                        **kwargs) -> SpinModel:
    """All-pairs hopping with a user coupling J(i, j)."""
    return build_model(L, nup=nup, hopping=long_range_hopping(L, J),
                       dtype=dtype, **kwargs)
