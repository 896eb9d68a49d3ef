"""Dynamic structure factor S(q, omega) via Lanczos on flat states (port of
spindynamics_tpu/solvers/lanczos_sqw.py).

The JAX package vmaps the q axis into one batched recurrence; here the
q-points run one after another (each holds three state vectors), and the
tridiagonals are broadened together on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model import SpinModel
from ..ops.apply import matvec_fn
from ..ops.spin_ops import sz_q_vector
from ..utils.dtypes import complex_dtype
from .lanczos import _default_compensated, _lanczos_scan, tridiag_eigh

__all__ = ["spectral_from_tridiagonal", "spectral_from_tridiagonal_batched",
           "lanczos_sqw"]



def _broaden(shifted, eta: float, broaden: str):
    if broaden == "lorentz":
        return (1.0 / np.pi) * (eta / (shifted**2 + eta**2))
    if broaden == "gauss":
        return (np.exp(-(shifted**2) / (2 * eta**2))
                / (np.sqrt(2 * np.pi) * eta))
    raise ValueError(f"unknown broadening {broaden!r}")


def spectral_from_tridiagonal(alphas, betas, norm_phi: float, E0: float,
                              omega, eta: float = 0.05,
                              broaden: str = "lorentz", m_eff=None):
    """Broadened spectral density from a Lanczos tridiagonalization (ref
    src/LanczosSqw.jl:18-45), on the host. Weights w_k = |Q[0, k]|^2
    ||phi||^2; poles at omega = theta_k - E0."""
    theta, Q = tridiag_eigh(alphas, betas, m_eff)
    w = (Q[0, :] ** 2) * (float(norm_phi) ** 2)
    omega = np.asarray(omega, dtype=np.float64)
    shifted = omega[:, None] - (theta[None, :] - float(E0))  # [W, m]
    return _broaden(shifted, eta, broaden) @ w


def spectral_from_tridiagonal_batched(alphas, betas, norms, E0: float, omega,
                                      eta: float = 0.05,
                                      broaden: str = "lorentz"):
    """Batched broadened spectra: alphas [Q, m], betas [Q, m-1], norms [Q]
    -> S [Q, W]. No per-q m_eff slicing: inactive Lanczos steps emit
    beta = 0, which block-decouples the tridiagonal, and eigenvectors of
    trailing blocks have first component exactly 0."""
    a = np.asarray(alphas, np.float64)
    b = np.asarray(betas, np.float64)
    Qn, m = a.shape
    T = np.zeros((Qn, m, m))
    ii = np.arange(m)
    T[:, ii, ii] = a
    T[:, ii[:-1], ii[1:]] = b
    T[:, ii[1:], ii[:-1]] = b
    theta, Q = np.linalg.eigh(T)  # [Q, m], [Q, m, m]
    w = (Q[:, 0, :] ** 2) * (np.asarray(norms, np.float64)[:, None] ** 2)
    omega = np.asarray(omega, dtype=np.float64)
    shifted = omega[None, :, None] - (theta[:, None, :] - float(E0))
    return np.einsum("qwm,qm->qw", _broaden(shifted, eta, broaden), w)


def lanczos_sqw(psi0: torch.Tensor, model: SpinModel, q_list, omega,
                lanc_m: int = 200, eta: float = 0.05,
                broaden: str = "lorentz", tol: float = 1e-12,
                backend: str | None = None, matvec=None):
    """S(q, omega) from the (ground) state psi0 (ref
    src/LanczosSqw.jl:49-82), on psi0's device. For each q: phi = S^z_q
    psi0 (complex), Lanczos-tridiagonalize H from phi, broaden the pole
    weights. `matvec` (default: matvec_fn(model, backend) on psi0's device)
    applies H. Returns [nq, n_omega] numpy."""
    cdtype = complex_dtype(psi0.dtype)
    psi0 = psi0.to(cdtype)
    if matvec is None:
        matvec = matvec_fn(model, backend, device=psi0.device)
    E0 = float(torch.vdot(psi0, matvec(psi0)).real)
    compensated = _default_compensated(cdtype)
    alphas, betas, norms = [], [], []
    for q in q_list:
        phi = sz_q_vector(model, psi0, float(q), dtype=cdtype)
        nrm = torch.linalg.vector_norm(phi)
        phi = phi / torch.clamp(nrm, min=torch.finfo(nrm.dtype).tiny)
        a, b, _, _ = _lanczos_scan(matvec, phi, lanc_m, tol, compensated)
        alphas.append(a.cpu().numpy())
        betas.append(b.cpu().numpy()[: lanc_m - 1])
        norms.append(float(nrm))
    return spectral_from_tridiagonal_batched(
        np.asarray(alphas), np.asarray(betas), np.asarray(norms), E0, omega,
        eta=eta, broaden=broaden)
