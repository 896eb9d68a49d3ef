"""Single-site spin operators and S^z_q vectors on flat states (port of
spindynamics_tpu/ops/spin_ops.py for the full, embedded and compact
layouts).

S^z is diagonal: a multiply by (bit - 1/2), the bit read from the basis
states (a compact model's come from model.basis_states). S^+/S^-/S^x/S^y
flip one bit: on a full or embedded model the target index is idx XOR
2^site, one flip of an axis of length 2, and on an embedded model the
result lies outside the sector, as in the JAX package; on a compact model
a single flip leaves the sector, so its projection back onto the basis is
zero (the reference's dictionary-miss semantics), as in the JAX package.
S^z_q is diagonal: phi = w_q * psi with w_q[n] = L^{-1/2} sum_r e^{iqr}
sz_r(n).
"""

from __future__ import annotations

import numpy as np
import torch

from ..model import SpinModel
from ..utils.dtypes import complex_dtype, real_dtype

__all__ = ["apply_spin_operator", "make_spin_operator", "sz_q_weights",
           "sz_q_vector"]


def _site_bits(model: SpinModel, site: int, dtype, device, states=None):
    """bit_site of every basis state, as `dtype`; `states` defaults to the
    model's (an arange for a full or embedded model)."""
    if states is None:
        states = model.basis_states(device)
    return ((states >> site) & 1).to(dtype)


def _flip_full(psi: torch.Tensor, L: int, site: int) -> torch.Tensor:
    """psi[idx XOR 2^site] via one flip of an axis of length 2."""
    return torch.flip(psi.reshape(1 << (L - 1 - site), 2, 1 << site),
                      dims=(1,)).reshape(-1)


def apply_spin_operator(psi: torch.Tensor, model: SpinModel, site: int,
                        kind: str) -> torch.Tensor:
    """Apply S^{kind}_site to psi; kind in {'z', 'plus', 'minus', 'x', 'y'}
    (S^z eigenvalues +-1/2, S^+/S^- amplitudes 1, S^x amplitude 1/2, S^y
    amplitudes -+ i/2)."""
    if model.mode not in ("full", "embedded", "compact"):
        raise ValueError("apply_spin_operator needs a full, embedded or "
                         "compact model")
    if not 0 <= site < model.L:
        raise ValueError(f"site {site} out of range [0, {model.L})")
    if kind not in ("z", "plus", "minus", "x", "y"):
        raise ValueError(f"unknown operator kind {kind!r}")
    if model.mode == "compact" and kind != "z":
        # one flip leaves the sector: the projection onto the basis is 0
        return torch.zeros_like(psi, dtype=complex_dtype(psi.dtype)
                                if kind == "y" else psi.dtype)
    rdtype = real_dtype(psi.dtype)
    bits = _site_bits(model, site, rdtype, psi.device)
    if kind == "z":
        return psi * (bits - 0.5)
    flipped = _flip_full(psi, model.L, site)
    if kind == "plus":
        # out[k] = psi[k ^ m] where bit_site(k) == 1 (the source had 0)
        return flipped * bits
    if kind == "minus":
        return flipped * (1 - bits)
    if kind == "x":
        return flipped * 0.5
    # S^y = (S+ - S-)/(2i): -i/2 psi[k^m] where bit(k) = 1, +i/2 elsewhere
    sign = 1.0 - 2.0 * bits
    return (flipped * sign).to(complex_dtype(psi.dtype)) * 0.5j


def make_spin_operator(site: int, kind: str):
    """Closure op(psi, model) applying S^{kind}_site."""
    def op(psi, model):
        return apply_spin_operator(psi, model, site, kind)

    return op


def sz_q_weights(model: SpinModel, q, dtype=torch.complex64, device="cpu"
                 ) -> torch.Tensor:
    """Per-state diagonal weight of S^z_q = L^{-1/2} sum_r e^{iqr} S^z_r,
    accumulated site by site (no N x L table) from the basis states."""
    rdtype = real_dtype(dtype)
    L = model.L
    phases = np.exp(1j * float(q) * np.arange(L))
    states = model.basis_states(device)
    w = torch.zeros(model.n_states, dtype=dtype, device=device)
    for site in range(L):
        sz = _site_bits(model, site, rdtype, device, states) - 0.5
        w += complex(phases[site]) * sz
    return w / float(np.sqrt(L))


def sz_q_vector(model: SpinModel, psi: torch.Tensor, q,
                dtype=torch.complex64) -> torch.Tensor:
    """phi = S^z_q |psi> (a diagonal multiply), on psi's device."""
    return sz_q_weights(model, q, dtype, psi.device) * psi.to(dtype)
