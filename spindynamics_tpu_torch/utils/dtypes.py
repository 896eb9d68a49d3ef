"""Real and complex counterparts of a state dtype (port of
spindynamics_tpu/utils/dtypes.py)."""

from __future__ import annotations

import torch

__all__ = ["real_dtype", "complex_dtype", "lift_bf16", "err_ratio"]

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


def lift_bf16(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 -> float32, anything else as it is. bfloat16 is a storage
    type of states only: every sum over amplitudes is taken in float32 (a
    bfloat16 matmul may reduce in bfloat16 on the card and rounds after each
    chained contraction)."""
    return x.float() if x.dtype == torch.bfloat16 else x


def err_ratio(out: torch.Tensor, ref: torch.Tensor, rounded: bool = False,
              ymax: float | None = None, tol: float = 1e-5
              ) -> tuple[float, float]:
    """(max |out - ref|, the worst |out - ref| over its limit) for `out`
    held to the float32 value `ref`. The limit is tol * ymax (default
    max|ref|: the float32 reassociation of a kernel's sums, which can also
    carry a sum across a rounding boundary) plus, when `rounded` (a
    bfloat16 `out` that should be `ref` rounded once), 2^-8 |ref|: half a
    unit in the last place of 8 significand bits. A ratio above 1 is an
    indexing or ordering error, which a looser bfloat16 tolerance would
    hide."""
    if ymax is None:
        ymax = float(ref.abs().max())
    d = (out.to(ref.dtype) - ref).abs()
    lim = tol * ymax + 1e-30
    if rounded:
        lim = lim + 2.0 ** -8 * ref.abs()
    return float(d.max()), float((d / lim).max())
