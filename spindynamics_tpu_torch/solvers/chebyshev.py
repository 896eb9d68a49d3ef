"""Chebyshev machinery: KPM moments, damping kernels, series
reconstruction, and Chebyshev-Bessel time evolution of flat states (port of
spindynamics_tpu/solvers/chebyshev.py). States are BlockVecs or flat
tensors; complex flat states are native complex64/complex128 tensors.

The two reference normalization conventions stay explicit in
`kpm_reconstruct(..., doubling=..., density_2_over_a=...)`. The series is
evaluated with T_n(x) = cos(n arccos x), exact for |x| <= 1, as one matrix
product.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils.dtypes import complex_dtype
from .lanczos import _default_compensated, _inner_c, _re

__all__ = [
    "rescaling_params",
    "chebyshev_moments",
    "chebyshev_cross_moments",
    "kpm_diagnostics",
    "chebyshev_time_evolve",
    "jackson_kernel",
    "lorentz_kernel",
    "get_kernel",
    "kpm_reconstruct",
    "chebyshev_coefficients",
]


def rescaling_params(Emin: float, Emax: float, safety: float = 1.0):
    """(a, b) with H_tilde = (H - b)/a."""
    a = (Emax - Emin) / 2.0 * safety
    b = (Emax + Emin) / 2.0
    return float(a), float(b)


def _moment_scan(matvec_rescaled: Callable, phi, M: int, chi,
                 compensated: bool = False) -> torch.Tensor:
    """mu_n = <chi| T_n(H~) |phi> for n = 0..M-1, one matvec per moment."""
    mus = [_inner_c(chi, phi, compensated)]
    v_prev, v_curr = phi, matvec_rescaled(phi)
    mus.append(_inner_c(chi, v_curr, compensated))
    for _ in range(M - 2):
        v_next = 2.0 * matvec_rescaled(v_curr) - v_prev
        mus.append(_inner_c(chi, v_next, compensated))
        v_prev, v_curr = v_curr, v_next
    return torch.stack(mus)[:M]


def _moment_scan_doubled(matvec_rescaled: Callable, phi, M: int,
                         compensated: bool = False) -> torch.Tensor:
    """mu_0..mu_{M-1} via the product identities
    mu_{2n} = 2 <T_n|T_n> - mu_0, mu_{2n+1} = 2 <T_{n+1}|T_n> - mu_1."""
    half = (M + 1) // 2  # need T_0..T_half
    mu0 = _re(_inner_c(phi, phi, compensated))
    v_prev, v_curr = phi, matvec_rescaled(phi)
    mu1 = _re(_inner_c(phi, v_curr, compensated))
    mus = [mu0, mu1]
    for _ in range(max(half, 1)):  # n = 1..half: mu_2..mu_{2 half + 1}
        v_next = 2.0 * matvec_rescaled(v_curr) - v_prev
        mus.append(2.0 * _re(_inner_c(v_curr, v_curr, compensated)) - mu0)
        mus.append(2.0 * _re(_inner_c(v_next, v_curr, compensated)) - mu1)
        v_prev, v_curr = v_curr, v_next
    return torch.stack(mus)[:M]


def chebyshev_moments(matvec_rescaled, phi, M: int,
                      doubling_trick: bool = False,
                      compensated: bool | None = None) -> torch.Tensor:
    """Diagonal KPM moments mu_n = <phi|T_n(H~)|phi> (real parts).

    doubling_trick=True produces M moments from ~M/2 matvecs through the
    product identities (see _moment_scan_doubled)."""
    if compensated is None:
        compensated = _default_compensated(phi.dtype)
    if not doubling_trick:
        return _re(_moment_scan(matvec_rescaled, phi, M, phi, compensated))
    return _moment_scan_doubled(matvec_rescaled, phi, M, compensated)


def chebyshev_cross_moments(matvec_rescaled, chi, phi, M: int,
                            normalize_phi: bool = True,
                            compensated: bool | None = None) -> torch.Tensor:
    """Cross moments mu_n = <chi|T_n(H~)|phi> ||phi|| with phi normalized
    first (ref src/TimeEvolution/KPM.jl:119-163). Returns real parts."""
    if compensated is None:
        compensated = _default_compensated(phi.dtype)
    norm_phi = torch.linalg.vector_norm(phi)
    if normalize_phi:
        phi = phi / norm_phi
    mus = _moment_scan(matvec_rescaled, phi, M, chi, compensated)
    return _re(mus) * norm_phi


def jackson_kernel(M: int) -> np.ndarray:
    """Jackson damping g_n."""
    n = np.arange(M)
    d = np.pi / (M + 1)
    return ((M - n + 1) * np.cos(d * n) + np.sin(d * n) / np.tan(d)) / (M + 1)


def lorentz_kernel(M: int, lam: float = 3.0) -> np.ndarray:
    """Lorentz damping."""
    n = np.arange(M)
    return np.sinh(lam * (1.0 - n / M)) / np.sinh(lam)


def get_kernel(M: int, kernel: str = "jackson") -> np.ndarray:
    if kernel == "jackson":
        return jackson_kernel(M)
    if kernel == "lorentz":
        return lorentz_kernel(M)
    if kernel in (None, "none"):
        return np.ones(M)
    raise ValueError(f"unknown kernel {kernel!r}")


def kpm_reconstruct(mu, omega, a: float, b: float, kernel: str = "jackson",
                    doubling: bool = True, density_2_over_a: bool = False,
                    clamp: float | None = 0.999, clip_nonneg: bool = True
                    ) -> torch.Tensor:
    """S(omega) from (damped) moments, in mu's dtype and on its device.

    Conventions: kpm_sw (doubling=True, density_2_over_a=False, x clamped to
    +-0.999) and evaluate_chebyshev_series (doubling=False,
    density_2_over_a=True, zero outside |x| >= 1). mu may be batched
    [..., M]; omega is [W]. Returns [..., W]."""
    mu = torch.as_tensor(mu)
    M = mu.shape[-1]
    dtype, dev = mu.dtype, mu.device
    g = torch.as_tensor(get_kernel(M, kernel), dtype=dtype, device=dev)
    fac = torch.ones(M, dtype=dtype, device=dev)
    if doubling:
        fac[1:] = 2.0
    mu_d = mu * g * fac
    omega = torch.as_tensor(np.asarray(omega), dtype=dtype, device=dev)
    x = (omega - b) / a
    inside = torch.abs(x) < 1.0
    if clamp is not None:
        x = torch.clamp(x, -clamp, clamp)
    theta = torch.arccos(torch.clamp(x, -1.0, 1.0))
    n = torch.arange(M, dtype=dtype, device=dev)
    T = torch.cos(torch.outer(theta, n))  # [W, M]
    S = mu_d @ T.T
    tiny = torch.finfo(dtype).tiny
    S = S / (np.pi * torch.sqrt(torch.clamp(1.0 - x * x, min=tiny)))
    if density_2_over_a:
        S = S * (2.0 / a)
    if clamp is None:
        S = torch.where(inside, S, torch.zeros_like(S))
    if clip_nonneg:
        S = torch.clamp(S, min=0.0)
    return S


def kpm_diagnostics(matvec_rescaled, phi, omega, a: float, b: float,
                    M: int = 32) -> dict:
    """Structured KPM health check: the x-range of omega against [-1, 1],
    moment magnitudes, and the growth of the iterate norms (which signals
    eigenvalues escaping the rescaled interval)."""
    x = (np.asarray(omega, np.float64) - b) / a
    mu = chebyshev_moments(matvec_rescaled, phi, M)
    v_prev, v_curr = phi, matvec_rescaled(phi)
    norms = []
    for _ in range(max(M - 2, 1)):
        v_next = 2.0 * matvec_rescaled(v_curr) - v_prev
        norms.append(torch.linalg.vector_norm(v_next))
        v_prev, v_curr = v_curr, v_next
    mu = mu.cpu().numpy()
    return {
        "x_min": float(x.min()),
        "x_max": float(x.max()),
        "x_in_range": bool(np.all(np.abs(x) <= 1.0)),
        "moments": mu,
        "max_abs_moment": float(np.abs(mu).max()),
        "iterate_norms": torch.stack(norms).cpu().numpy(),
        "moments_bounded": float(np.abs(mu).max()) < 1e3,
    }


def chebyshev_coefficients(dt: float, Emin: float, Emax: float, cheb_n: int):
    """c_k = (2 - delta_k0) (-i)^k J_k(a dt) e^{-i b dt} and (a, b) of the
    e^{-iH dt} expansion in T_k((H - b)/a), with the 0.9999 shrink of the
    reference (src/TimeEvolution/Chebyshev.jl:71-80). Host-side (scipy
    Bessel J), numpy complex128."""
    from scipy.special import jv

    a = (Emax - Emin) / (2 * 0.9999)
    b = (Emax + Emin) / 2.0
    k = np.arange(cheb_n)
    c = (2.0 - (k == 0)) * (-1j) ** k * jv(k, a * dt) * np.exp(-1j * b * dt)
    return np.asarray(c, np.complex128), float(a), float(b)



def chebyshev_time_evolve(psi: torch.Tensor, matvec, dt: float, Ebounds,
                          cheb_n: int = 100, coeffs=None) -> torch.Tensor:
    """psi(t + dt) = e^{-i H dt} psi of a flat state by the Chebyshev-Bessel
    expansion (ref src/TimeEvolution/Chebyshev.jl:62-133). `matvec` applies
    the raw H; the rescaling happens inside from Ebounds. `coeffs` (from
    chebyshev_coefficients) skips the host Bessel evaluation. The state is
    a native complex tensor (complex64 for a float32 or complex64 input)."""
    if coeffs is None:
        c, a, b = chebyshev_coefficients(dt, Ebounds[0], Ebounds[1], cheb_n)
    else:
        c, a, b = coeffs
    psi = psi.to(complex_dtype(psi.dtype))
    inv_a = 1.0 / a

    def matvec_rescaled(v):
        return (matvec(v) - b * v) * inv_a

    return _cheb_evolve_accum(matvec_rescaled, psi,
                              [complex(x) for x in c], cheb_n)


def _cheb_evolve_accum(matvec_rescaled, psi, coeffs, n: int):
    """sum_k c_k T_k(H~) psi by the three-term recurrence, accumulated as
    it goes (no [n, N] buffer). The accumulator is updated in place."""
    phi_prev = psi
    psi_t = coeffs[0] * phi_prev
    if n < 2:
        return psi_t
    phi_curr = matvec_rescaled(phi_prev)
    psi_t.add_(phi_curr, alpha=coeffs[1])
    for c_k in coeffs[2:n]:
        phi_next = 2.0 * matvec_rescaled(phi_curr) - phi_prev
        psi_t.add_(phi_next, alpha=c_k)
        phi_prev, phi_curr = phi_curr, phi_next
    return psi_t
