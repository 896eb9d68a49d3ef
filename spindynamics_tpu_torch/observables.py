"""Diagonal observables of flat states from |psi|^2 (port of
spindynamics_tpu/observables.py), for full, embedded and compact models.

Everything is one chunked pass over the probabilities: each chunk's
[chunk, L] matrix of Sz eigenvalues is made from the chunk's basis states
(its indices on a full or embedded model, the model's states on a compact
one) and contracted against the probabilities, so a state of 2^26
amplitudes never makes L state-sized temporaries. Matrix products run in
full float32.
"""

from __future__ import annotations

import numpy as np
import torch

from .model import SpinModel

__all__ = [
    "magnetization_per_site",
    "connected_correlations",
    "structure_factor_Sq",
    "structure_factor_Sq_dict",
    "szsz_matrix",
]


def _probs(psi: torch.Tensor) -> torch.Tensor:
    if psi.is_complex():
        r = torch.view_as_real(psi)
        return r[..., 0] ** 2 + r[..., 1] ** 2
    return psi * psi


def _sz_columns(s0: int, n: int, L: int, dtype, device, states=None
                ) -> torch.Tensor:
    """[n, L] matrix of Sz eigenvalues (+-1/2) of the basis states of rows
    s0 .. s0+n-1: `states[s0:s0+n]`, or the row indices themselves when
    `states` is None (a full or embedded model)."""
    chunk = (torch.arange(s0, s0 + n, device=device) if states is None
             else states[s0:s0 + n])
    site = torch.arange(L, device=device)
    return ((chunk[:, None] >> site[None, :]) & 1).to(dtype) - 0.5


def _row_states(model, device):
    """The basis states the rows stand for where they are not the row
    indices (a compact model), else None."""
    return model.basis_states(device) if model.mode == "compact" else None


def _flat_model(model, what):
    if model.mode not in ("full", "embedded", "compact"):
        raise ValueError(f"{what} needs a full, embedded or compact model; "
                         "kron states use observables_kron")


def magnetization_per_site(psi: torch.Tensor, model: SpinModel,
                           chunk: int = 1 << 18) -> torch.Tensor:
    """<Sz_i> per site, in one chunked pass over |psi|^2."""
    _flat_model(model, "magnetization_per_site")
    p = _probs(psi)
    L, N = model.L, model.n_states
    states = _row_states(model, p.device)
    si = torch.zeros(L, dtype=p.dtype, device=p.device)
    for s0 in range(0, N, chunk):
        n = min(chunk, N - s0)
        si += p[s0:s0 + n] @ _sz_columns(s0, n, L, p.dtype, p.device,
                                         states)
    return si


def szsz_matrix(psi: torch.Tensor, model: SpinModel, chunk: int = 1 << 18):
    """(SzSz[i, j], S_i) = (sum_n p_n sz_i(n) sz_j(n), sum_n p_n sz_i(n))."""
    _flat_model(model, "szsz_matrix")
    p = _probs(psi)
    L, N = model.L, model.n_states
    states = _row_states(model, p.device)
    szsz = torch.zeros((L, L), dtype=p.dtype, device=p.device)
    si = torch.zeros(L, dtype=p.dtype, device=p.device)
    for s0 in range(0, N, chunk):
        n = min(chunk, N - s0)
        sz = _sz_columns(s0, n, L, p.dtype, p.device, states)
        wsz = sz * p[s0:s0 + n, None]
        szsz += wsz.T @ sz
        si += wsz.sum(dim=0)
    return szsz, si


def _connected_from_szsz(szsz, si, L: int) -> torch.Tensor:
    """C_r from the pair-correlator matrix, periodic wrap."""
    conn = szsz - torch.outer(si, si)
    i = torch.arange(L, device=conn.device)
    return torch.stack([conn[i, (i + r) % L].mean() for r in range(L)])


def connected_correlations(psi: torch.Tensor, model: SpinModel
                           ) -> torch.Tensor:
    """C_r = (1/L) sum_i [<Sz_i Sz_{i+r}> - <Sz_i><Sz_{i+r}>], periodic
    wrap (ref src/Observables.jl:44-95)."""
    szsz, si = szsz_matrix(psi, model)
    return _connected_from_szsz(szsz, si, model.L)


def structure_factor_Sq(psi: torch.Tensor, model: SpinModel):
    """Static structure factor S(q) = FFT_r C_r at q = 2 pi n / L. Returns
    (q, S_q) tensors."""
    C_r = connected_correlations(psi, model)
    S_q = torch.fft.fft(C_r).real
    q = 2.0 * np.pi * torch.arange(model.L, device=C_r.device,
                                   dtype=C_r.dtype) / model.L
    return q, S_q


def structure_factor_Sq_dict(psi: torch.Tensor, model: SpinModel) -> dict:
    """Dict q -> S(q)."""
    q, S_q = structure_factor_Sq(psi, model)
    return {float(a): float(b) for a, b in zip(q.cpu(), S_q.cpu())}
