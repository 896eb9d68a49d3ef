"""Restarted two-pass Lanczos ground state on BlockVec states (port of the
no-reorthogonalization parts of spindynamics_tpu/solvers/lanczos.py).

`lax.scan` becomes a Python loop; per-step scalars stay 0-d tensors on the
state's device, so a step never waits for the device. The seeded (axpy)
branch and the second pass are kept exactly as in the JAX package: pass 2
regenerates pass 1's Krylov basis bit for bit, which holds because every
apply and every dot is deterministic (K1 writes each output once, with no
atomics).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .blockvec import BlockVec, bv_zeros_like

__all__ = [
    "LanczosFactorization",
    "lanczos_iteration",
    "tridiag_eigh",
    "restart_cycle",
    "lanczos_groundstate_restarted",
]


class LanczosFactorization(NamedTuple):
    alphas: torch.Tensor   # [m], on the CPU
    betas: torch.Tensor    # [m] (zeros past breakdown), on the CPU
    m_eff: int             # number of valid Lanczos vectors
    v0_norm: torch.Tensor  # norm of the starting vector


def _inner_c(x, y, compensated: bool):
    """<x|y>, leaf by leaf for BlockVec states."""
    if isinstance(x, BlockVec):
        return sum(_inner_c(a, b, compensated)
                   for a, b in zip(x.leaves, y.leaves))
    if compensated:
        from ..utils.compensated import vdot2

        return vdot2(x, y)
    return torch.dot(x.reshape(-1), y.reshape(-1))


def _norm_c(x, compensated: bool):
    if isinstance(x, BlockVec):
        s = sum(_inner_c(a, a, compensated) for a in x.leaves)
        return torch.sqrt(torch.clamp(s, min=0))
    if compensated:
        from ..utils.compensated import norm2

        return norm2(x)
    return torch.linalg.vector_norm(x)


def _default_compensated(dtype) -> bool:
    """Compensated dots in f32; f64 already has the headroom."""
    return torch.finfo(dtype).bits <= 32


def _lanczos_scan(matvec: Callable, v1, m: int, tol, compensated: bool):
    """m Lanczos steps from normalized v1 (no reorthogonalization). Returns
    (alphas[m], betas[m], active[m]) as device tensors; betas[j] couples step
    j to j+1.

    With `matvec.supports_axpy` the recurrence's -beta_{j-1} v_{j-1} is
    folded into the apply's kernel seed, and alpha = <v_j|w> then carries
    -beta <v_j|v_{j-1}> (identical up to the f32 orthogonality floor, the
    standard Lanczos form). Both passes take the same branch."""
    dtype = v1.dtype
    dev = v1.device
    tol = torch.tensor(tol, dtype=dtype, device=dev)
    tiny = torch.finfo(dtype).tiny
    zero = torch.zeros((), dtype=dtype, device=dev)
    axpy_ok = getattr(matvec, "supports_axpy", False)

    v_prev, v_curr = bv_zeros_like(v1), v1
    beta_prev = zero
    active = torch.ones((), dtype=torch.bool, device=dev)
    last_alpha = zero
    alphas, betas, actives = [], [], []
    for _ in range(m):
        if axpy_ok:
            w = matvec(v_curr, -beta_prev, v_prev)
            alpha = _inner_c(v_curr, w, compensated)
            w = w - alpha * v_curr
        else:
            w = matvec(v_curr)
            alpha = _inner_c(v_curr, w, compensated)
            w = w - alpha * v_curr - beta_prev * v_prev
        beta = _norm_c(w, compensated)
        ok = torch.logical_and(active, beta > tol)
        inv = torch.where(beta > 0, 1.0 / torch.clamp(beta, min=tiny), zero)
        v_next = w * torch.where(ok, inv, zero)
        alpha_out = torch.where(active, alpha, last_alpha)
        beta_out = torch.where(ok, beta, zero)
        alphas.append(alpha_out)
        betas.append(beta_out)
        actives.append(active)
        v_prev, v_curr = v_curr, v_next
        beta_prev, active, last_alpha = beta_out, ok, alpha_out
        del w
    return torch.stack(alphas), torch.stack(betas), torch.stack(actives)


def _normalize_start(v0, donate: bool = False):
    """(v0 / ||v0||, ||v0||). donate=True scales v0's leaves in place (the
    JAX package donates the buffer; the caller must not reuse v0)."""
    nrm = _norm_c(v0, False)
    inv = 1.0 / nrm
    if donate:
        for l in v0.leaves:
            l.mul_(inv.to(l.dtype))
        return v0, nrm
    return v0 / nrm, nrm


def lanczos_iteration(matvec: Callable, v0, m: int, tol: float = 1e-12,
                      compensated: bool | None = None
                      ) -> LanczosFactorization:
    """Lanczos tridiagonalization from v0 (need not be normalized; its norm
    is returned). compensated=None resolves by dtype (True in f32)."""
    v1, v0_norm = _normalize_start(v0)
    if compensated is None:
        compensated = _default_compensated(v1.dtype)
    alphas, betas, active = _lanczos_scan(matvec, v1, m, tol, compensated)
    m_eff = int(active.sum())
    return LanczosFactorization(alphas.cpu(), betas.cpu(), m_eff, v0_norm)


def tridiag_eigh(alphas, betas, m_eff=None):
    """Host eigendecomposition of the (sliced) symmetric tridiagonal."""
    import scipy.linalg

    a = np.asarray(alphas, dtype=np.float64)
    b = np.asarray(betas, dtype=np.float64)
    if m_eff is not None:
        k = int(m_eff)
        a = a[:k]
        b = b[: max(k - 1, 0)]
    else:
        b = b[: a.shape[0] - 1]
    if a.shape[0] == 1:
        return a.copy(), np.ones((1, 1))
    return scipy.linalg.eigh_tridiagonal(a, b)


def restart_cycle(matvec, psi, lanc_m: int, tol: float = 1e-12,
                  compensated: bool | None = None, finalize=None):
    """ONE two-pass Lanczos restart cycle from `psi` (consumed: its leaves
    are normalized in place). Returns (E0, ritz_psi, info).

    finalize(matvec, psi_unnorm) -> (psi, E, resid) overrides _ritz_finalize
    (runners.groundstate_kron passes the bucketed variant)."""
    if compensated is None:
        compensated = _default_compensated(psi.dtype)
    v1, _ = _normalize_start(psi, donate=True)
    del psi
    alphas, betas, active = _lanczos_scan(matvec, v1, lanc_m, tol,
                                          compensated)
    m_eff = int(active.sum())
    evals, evecs = tridiag_eigh(alphas.cpu(), betas.cpu(), m_eff)
    idx = int(np.argmin(evals))
    y = np.zeros(lanc_m)
    y[:m_eff] = evecs[:, idx]
    psi = _second_pass_accumulate(
        matvec, v1, torch.as_tensor(y, dtype=v1.dtype, device=v1.device),
        lanc_m, compensated)
    fin = _ritz_finalize if finalize is None else finalize
    psi, E, resid = fin(matvec, psi)
    return float(E), psi, {"residual": float(resid), "m_eff": m_eff,
                           "evals": evals}


def lanczos_groundstate_restarted(matvec, v0, lanc_m: int = 40,
                                  cycles: int = 4, tol: float = 1e-12,
                                  target_residual: float | None = None,
                                  compensated: bool | None = None,
                                  finalize=None):
    """Restarted two-pass ground state: O(3N) memory, high accuracy.

    Each cycle runs the two-pass Lanczos from the previous Ritz vector; a
    Chebyshev-filter polish takes over when restarts stall at the rounding
    floor. `v0` (a BlockVec) is consumed. Stops early at `target_residual`.
    The JAX version draws v0 itself from (N, key, mask); here the caller
    passes it."""
    if compensated is None:
        compensated = _default_compensated(v0.dtype)
    E0 = None
    psi = v0
    info = {}
    info_prev_residual = None
    del v0
    for c in range(cycles):
        E0, psi, cinfo = restart_cycle(matvec, psi, lanc_m, tol=tol,
                                       compensated=compensated,
                                       finalize=finalize)
        residual = cinfo["residual"]
        info = dict(cinfo, cycles=c + 1)
        if target_residual is not None and residual < target_residual:
            break
        if cinfo["m_eff"] < lanc_m:  # invariant subspace reached
            break
        if (target_residual is not None and c >= 1
                and residual > 0.5 * info_prev_residual):
            # no-reorth restarts stall once beta_1 ~ residual: switch to
            # the Chebyshev-filter polish below
            break
        info_prev_residual = residual

    # Chebyshev-filter polish: robust at the f32 floor where restarts stall
    if (target_residual is not None
            and info.get("residual", 1.0) > target_residual):
        evals = info["evals"]
        width = float(evals[-1] - evals[0]) if len(evals) > 1 else 1.0
        # gap estimate from the first ghost-free Ritz value
        above = [float(e) for e in evals if float(e) > E0 + 0.01 * width]
        e1 = above[0] if above else E0 + 0.1 * width
        lo_cut = E0 + max(0.5 * (e1 - E0), 0.005 * width)
        hi = float(evals[-1]) + 0.05 * width
        fin = _ritz_finalize if finalize is None else finalize
        for _ in range(max(cycles, 4)):
            psi = _chebyshev_filter(matvec, psi, lo_cut, hi, lanc_m)
            psi, E, resid = fin(matvec, psi)
            E0 = float(E)
            info["residual"] = float(resid)
            info["polished"] = info.get("polished", 0) + 1
            if float(resid) < target_residual:
                break
    return E0, psi, info


def _chebyshev_filter(matvec, psi, lo_cut: float, hi: float, degree: int):
    """Amplify spectral weight below `lo_cut` by T_degree of H mapped so
    [lo_cut, hi] -> [-1, 1] (single-vector Chebyshev-filtered subspace
    iteration; needs no orthogonality). Renormalizes the pair each step."""
    dtype, dev = psi.dtype, psi.device
    c = torch.tensor((hi + lo_cut) / 2.0, dtype=dtype, device=dev)
    h = torch.tensor((hi - lo_cut) / 2.0, dtype=dtype, device=dev)
    tiny = torch.finfo(dtype).tiny

    def hmap(v):
        return (matvec(v) - v * c) / h

    t_prev = psi
    t_curr = hmap(psi)
    for _ in range(max(degree - 1, 0)):
        t_next = 2.0 * hmap(t_curr) - t_prev
        inv = 1.0 / torch.clamp(_norm_c(t_next, False), min=tiny)
        t_prev, t_curr = t_curr * inv, t_next * inv
    return t_curr


def _ritz_finalize(matvec, psi_unnorm, compensated: bool = True):
    """Normalize the Ritz vector; return (psi, E = <psi|H|psi>, residual).
    E uses the compensated dot: a naive f32 Rayleigh quotient error is the
    residual floor."""
    tiny = torch.finfo(psi_unnorm.dtype).tiny
    nrm = _norm_c(psi_unnorm, compensated)
    psi = psi_unnorm / torch.clamp(nrm, min=tiny)
    hpsi = matvec(psi)
    E = _inner_c(psi, hpsi, compensated)
    resid = _norm_c(hpsi - E * psi, compensated)
    return psi, E, resid


def _second_pass_accumulate(matvec, v1, y, m: int, compensated: bool = False):
    """Re-run the Lanczos recurrence from v1 (the same vectors) accumulating
    psi = sum_j y_j v_j without storing the basis. `compensated` and the
    axpy branch must match pass 1 so the basis is reproduced bit for bit."""
    dtype = v1.dtype
    tiny = torch.finfo(dtype).tiny
    zero = torch.zeros((), dtype=dtype, device=v1.device)
    axpy_ok = getattr(matvec, "supports_axpy", False)
    v_prev, v_curr = bv_zeros_like(v1), v1
    beta_prev = zero
    acc = bv_zeros_like(v1)
    for j in range(m):
        acc = acc + v_curr * y[j]
        if axpy_ok:
            w = matvec(v_curr, -beta_prev, v_prev)
            alpha = _inner_c(v_curr, w, compensated)
            w = w - alpha * v_curr
        else:
            w = matvec(v_curr)
            alpha = _inner_c(v_curr, w, compensated)
            w = w - alpha * v_curr - beta_prev * v_prev
        beta = _norm_c(w, compensated)
        inv = torch.where(beta > 0, 1.0 / torch.clamp(beta, min=tiny), zero)
        v_prev, v_curr = v_curr, w * inv
        beta_prev = beta
        del w
    return acc
