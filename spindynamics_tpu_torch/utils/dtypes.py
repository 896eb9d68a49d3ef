"""Real and complex counterparts of a state dtype (port of
spindynamics_tpu/utils/dtypes.py)."""

from __future__ import annotations

import torch

__all__ = ["real_dtype", "complex_dtype"]

_REAL = {torch.complex64: torch.float32, torch.complex128: torch.float64}
_COMPLEX = {torch.float32: torch.complex64, torch.float64: torch.complex128}


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 for complex64, float64 for complex128; a real dtype as is."""
    return _REAL.get(dtype, dtype)


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """complex64 for float32, complex128 for float64; a complex dtype as
    is (the JAX package's result_type(dtype, complex64))."""
    if dtype in _REAL:
        return dtype
    if dtype not in _COMPLEX:
        raise TypeError(f"no complex counterpart of {dtype}")
    return _COMPLEX[dtype]
