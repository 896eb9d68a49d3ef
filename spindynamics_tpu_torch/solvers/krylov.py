"""Krylov (Lanczos) time evolution of flat states, real and imaginary time
(port of spindynamics_tpu/solvers/krylov.py).

The Lanczos build stores the m Krylov vectors ([m, N], m ~ 30), the small
tridiagonal is diagonalized on the host in float64, and psi_t = V^T (Q f(D)
Q^T ||psi|| e_1). Breakdown needs no special casing: masked steps emit
beta = 0 and v = 0, which block-decouples the tridiagonal; the decoupled
eigenvectors have zero overlap with e_1 and contribute nothing.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..utils.dtypes import complex_dtype, real_dtype

__all__ = [
    "krylov_time_evolve",
    "krylov_expm_multiply",
    "krylov_imaginary_time_evolve",
]



def _krylov_factorize(matvec: Callable, psi: torch.Tensor, m: int):
    """Lanczos build with stored basis: (V [m, N], alphas [m], betas [m-1],
    ||psi||)."""
    dtype = psi.dtype
    rdtype = real_dtype(dtype)
    dev = psi.device
    tiny = torch.finfo(rdtype).tiny
    zero = torch.zeros((), dtype=rdtype, device=dev)
    norm0 = torch.linalg.vector_norm(psi)
    inv0 = torch.where(norm0 > 0, 1.0 / torch.clamp(norm0, min=tiny), zero)
    v_curr = psi * inv0
    v_prev = torch.zeros_like(v_curr)
    beta_prev = zero
    V = torch.empty((m, psi.shape[0]), dtype=dtype, device=dev)
    alphas, betas = [], []
    for j in range(m):
        w = matvec(v_curr)
        alpha = torch.vdot(v_curr, w).real
        w = w - alpha * v_curr - beta_prev * v_prev
        beta = torch.linalg.vector_norm(w)
        ok = beta > 1e-14
        inv = torch.where(ok, 1.0 / torch.clamp(beta, min=tiny), zero)
        beta_out = torch.where(ok, beta, zero)
        V[j] = v_curr
        alphas.append(alpha)
        betas.append(beta_out)
        v_prev, v_curr, beta_prev = v_curr, w * inv, beta_out
    return V, torch.stack(alphas), torch.stack(betas)[: m - 1], norm0


def _krylov_apply_expm(matvec, psi, m: int, z: complex, renormalize: bool):
    """psi_out ~= V^T Q e^{z D} Q^T (||psi|| e1), T = Q D Q^T the Krylov
    tridiagonal (host, float64)."""
    V, alphas, betas, norm0 = _krylov_factorize(matvec, psi, m)
    a = alphas.detach().cpu().double()
    b = betas.detach().cpu().double()
    T = torch.diag(a)
    if m > 1:
        T = T + torch.diag(b, 1) + torch.diag(b, -1)
    D, Q = torch.linalg.eigh(T)
    Qc = Q.to(torch.complex128)
    y = Qc @ (torch.exp(z * D.to(torch.complex128))
              * (Qc[0, :] * float(norm0)))
    psi_out = y.to(dtype=V.dtype, device=V.device) @ V
    if renormalize:
        nrm = torch.linalg.vector_norm(psi_out)
        psi_out = psi_out / torch.clamp(nrm, min=torch.finfo(nrm.dtype).tiny)
    return psi_out


def krylov_time_evolve(psi, matvec, dt: float, kry_m: int = 30,
                       renormalize: bool = True):
    """psi(t + dt) = e^{-i H dt} psi in an m-dimensional Krylov subspace
    (ref src/TimeEvolution/Krylov.jl:136-192). renormalize=True reproduces
    the reference's output renormalization (it masks truncation error; pass
    False to see the raw result)."""
    return _krylov_apply_expm(matvec, psi.to(complex_dtype(psi.dtype)), kry_m,
                              -1j * dt, renormalize)


def krylov_expm_multiply(psi, matvec, z, kry_m: int = 30,
                         renormalize: bool = False):
    """General e^{z H} psi (z complex) through the same Krylov core."""
    return _krylov_apply_expm(matvec, psi.to(complex_dtype(psi.dtype)), kry_m,
                              complex(z), renormalize)


def krylov_imaginary_time_evolve(psi, matvec, tau: float, kry_m: int = 30):
    """e^{-tau H} psi, unnormalized (the thermal-state half-propagator of
    quantum typicality)."""
    return _krylov_apply_expm(matvec, psi.to(complex_dtype(psi.dtype)), kry_m,
                              complex(-tau), False)
