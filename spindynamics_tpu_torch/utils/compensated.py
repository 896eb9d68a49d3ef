"""Compensated inner products for long Krylov/Chebyshev recurrences (port of
spindynamics_tpu/utils/compensated.py).

Ogita-Rump-Oishi Dot2 in the FMA-free form via Dekker splitting: each
product x_i * y_i = p + e exactly, and the result is sum(e) + sum(p). In f32
this gives close to twofold working precision; it is what keeps the f32
Lanczos residual at the 1e-3 band at L=28 and beyond. A complex tensor is
read as its (real, imag) planes (strided views, no copy).

Every compensated dot goes through `dot2_leaves`, the sum over a list of
leaf pairs. On CUDA tensors it launches the dot2 kernel (ops/dot2.py,
csrc/dot2.cu): one launch and one read for all leaves, each product exact
in float64 and the sum rounded once, at least as accurate as Dot2; it
raises if the kernel cannot be built or launched. On CPU tensors it runs
the plain version below, the per-leaf Dot2 in the order the solvers always
summed it, so every CPU result is what it was.
"""

from __future__ import annotations

import torch

from .dtypes import lift_bf16

__all__ = ["two_sum", "two_prod", "dot2", "dot2_leaves", "norm2", "vdot2",
           "vdot2_leaves"]

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


def _dot2_pair(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    p, e = two_prod(x.reshape(-1), y.reshape(-1))
    return torch.sum(e) + torch.sum(p)


def dot2_leaves_plain(xs, ys) -> torch.Tensor:
    """The plain version of `dot2_leaves` (any device): Dot2 leaf by leaf,
    summed in leaf order; each bfloat16 leaf lifted to float32 once."""
    s = None
    for a, b in zip(xs, ys):
        la = lift_bf16(a)
        d = _dot2_pair(la, la if b is a else lift_bf16(b))
        s = d if s is None else s + d
    return s


def dot2_leaves(xs, ys) -> torch.Tensor:
    """sum_l <xs[l]|ys[l]> over real leaf pairs as one compensated dot (a
    0-d tensor on the leaves' device): float32 for float32 and bfloat16
    leaves (bfloat16 read as float32), float64 if any leaf is float64.

    CUDA leaves: one dot2 kernel launch per ops.dot2.MAX_LEAVES (112)
    leaves, no host sync; a leaf that is not evenly strided (or has stride
    0 or wider than 2) is made contiguous first. CPU leaves:
    `dot2_leaves_plain`."""
    xs, ys = list(xs), list(ys)
    if not xs or len(xs) != len(ys):
        raise ValueError(f"dot2_leaves: {len(xs)} x leaves, {len(ys)} y "
                         "leaves")
    if xs[0].device.type == "cpu":
        return dot2_leaves_plain(xs, ys)
    from ..ops.dot2 import dot2_launch

    return dot2_launch(xs, ys)


def dot2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Compensated real dot product (0-d tensor)."""
    return dot2_leaves([x], [y])


def norm2(x: torch.Tensor) -> torch.Tensor:
    """Compensated 2-norm via dot2(x, x) (per plane for a complex x)."""
    if x.is_complex():
        r, i = x.real, x.imag
        s = dot2_leaves([r, i], [r, i])
    else:
        s = dot2(x, x)
    return torch.sqrt(torch.clamp(s, min=0))


def _planes(x):
    return (x.real, x.imag) if x.is_complex() else (x, None)


def vdot2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Compensated sesquilinear <x|y>: a real 0-d tensor for real inputs, a
    complex one when either input is complex."""
    return vdot2_leaves([x], [y])


def vdot2_leaves(xs, ys) -> torch.Tensor:
    """sum_l <xs[l]|ys[l]> (sesquilinear) over leaf pairs: real leaves are
    one `dot2_leaves` call; complex ones go per plane (the real part one
    call over the re.re and im.im planes, the imaginary part two). On CPU
    leaves with a complex one, vdot2 leaf by leaf, summed in leaf order."""
    xs, ys = list(xs), list(ys)
    if not any(t.is_complex() for t in (*xs, *ys)):
        return dot2_leaves(xs, ys)
    if xs[0].device.type == "cpu" and len(xs) > 1:  # the plain version
        return sum(vdot2(lift_bf16(a), lift_bf16(b)) for a, b in zip(xs, ys))
    re_x, re_y, ip_x, ip_y, im_x, im_y = [], [], [], [], [], []
    for a, b in zip(xs, ys):
        (ar, ai), (br, bi) = _planes(a), _planes(b)
        re_x.append(ar)
        re_y.append(br)
        if ai is not None and bi is not None:
            re_x.append(ai)
            re_y.append(bi)
        if bi is not None:
            ip_x.append(ar)
            ip_y.append(bi)
        if ai is not None:
            im_x.append(ai)
            im_y.append(br)
    re = dot2_leaves(re_x, re_y)
    im = torch.zeros_like(re)
    if ip_x:
        im = im + dot2_leaves(ip_x, ip_y)
    if im_x:
        im = im - dot2_leaves(im_x, im_y)
    return torch.complex(re, im)
