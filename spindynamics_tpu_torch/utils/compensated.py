"""Compensated inner products for long Krylov/Chebyshev recurrences (port of
spindynamics_tpu/utils/compensated.py).

Ogita-Rump-Oishi Dot2 in the FMA-free form via Dekker splitting: each
product x_i * y_i = p + e exactly, and the result is sum(e) + sum(p). In f32
this gives close to twofold working precision; it is what keeps the f32
Lanczos residual at the 1e-3 band at L=28 and beyond. A complex tensor is
read as its (real, imag) planes (strided views, no copy).
"""

from __future__ import annotations

import torch

__all__ = ["two_sum", "two_prod", "dot2", "norm2", "vdot2"]

# Dekker split constant for f32: 2^ceil(24/2) + 1 (kept for f64 as well, as
# in the JAX package)
_SPLIT_F32 = 4097.0


def two_sum(a, b):
    """Error-free transform: a + b = s + e exactly (Knuth TwoSum)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    c = _SPLIT_F32 * a
    ah = c - (c - a)
    return ah, a - ah


def two_prod(a, b):
    """Error-free transform: a * b = p + e exactly (Dekker, no FMA)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dot2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Compensated real dot product (0-d tensor)."""
    p, e = two_prod(x.reshape(-1), y.reshape(-1))
    return torch.sum(e) + torch.sum(p)


def norm2(x: torch.Tensor) -> torch.Tensor:
    """Compensated 2-norm via dot2(x, x) (per plane for a complex x)."""
    if x.is_complex():
        s = dot2(x.real, x.real) + dot2(x.imag, x.imag)
    else:
        s = dot2(x, x)
    return torch.sqrt(torch.clamp(s, min=0))


def vdot2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Compensated sesquilinear <x|y>: a real 0-d tensor for real inputs, a
    complex one when either input is complex."""
    if not (x.is_complex() or y.is_complex()):
        return dot2(x, y)
    xr, xi = (x.real, x.imag) if x.is_complex() else (x, None)
    yr, yi = (y.real, y.imag) if y.is_complex() else (y, None)
    re = dot2(xr, yr)
    im = torch.zeros_like(re)
    if xi is not None and yi is not None:
        re = re + dot2(xi, yi)
    if yi is not None:
        im = im + dot2(xr, yi)
    if xi is not None:
        im = im - dot2(xi, yr)
    return torch.complex(re, im)
