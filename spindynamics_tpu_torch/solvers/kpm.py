"""KPM spectral functions of flat states: S(q, omega) and T=0 dynamical
correlations (port of spindynamics_tpu/solvers/kpm.py).

Both normalization conventions of the reference stay explicit through
`kpm_reconstruct`'s flags. The JAX package vmaps the q and site axes into
batched recurrences; here they run one after another (q-points, B sites),
so memory is a few state vectors whatever their number.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model import SpinModel
from ..ops.apply import matvec_fn
from ..ops.spin_ops import apply_spin_operator, sz_q_vector
from ..utils.dtypes import complex_dtype
from .chebyshev import (
    chebyshev_cross_moments, chebyshev_moments, kpm_reconstruct,
    rescaling_params)
from .lanczos import _default_compensated, _inner_c, estimate_energy_bounds

__all__ = [
    "kpm_sw",
    "kpm_sqw",
    "kpm_dynamical_correlation",
    "kpm_correlation_matrix",
    "kpm_structure_factor",
    "run_kpm_dynamical",
]



def _rescaled(mv, a: float, b: float):
    """v -> (H v - b v) / a, the shift and scale in the span
    `kpm.rescale` beside the apply's own."""
    from ..utils.profiling import annotate

    inv_a = 1.0 / a

    def mvr(v):
        hv = mv(v)
        with annotate("kpm.rescale"):
            hv = hv - v * b  # H v dropped here, as in one expression
            return hv * inv_a

    return mvr


def _default_rescaling(model, mv, device, lanc_m=80, safety=1.0,
                       generator=None):
    lo, hi = estimate_energy_bounds(
        mv, model.n_states, lanc_m=lanc_m, generator=generator,
        mask=model.valid_mask(device), device=device)
    return rescaling_params(lo, hi, safety=safety)


def kpm_sw(phi: torch.Tensor, model: SpinModel, omega, a: float, b: float,
           kpm_m: int = 200, kernel: str = "jackson",
           backend: str | None = None, doubling_trick: bool = True,
           matvec=None) -> torch.Tensor:
    """S(omega) for one normalized phi (ref src/KPM_Sqw.jl:29-71:
    (2 - delta_n0) doubling, no 2/a density factor, x clamped)."""
    if matvec is None:
        matvec = matvec_fn(model, backend, device=phi.device)
    mu = chebyshev_moments(_rescaled(matvec, a, b), phi, kpm_m,
                           doubling_trick=doubling_trick)
    return kpm_reconstruct(mu, omega, a, b, kernel=kernel, doubling=True,
                           density_2_over_a=False)


def kpm_sqw(psi0: torch.Tensor, model: SpinModel, q_list, omega,
            a: float | None = None, b: float | None = None, kpm_m: int = 200,
            kernel: str = "jackson", backend: str | None = None,
            lanc_m: int = 80, generator: torch.Generator | None = None,
            doubling_trick: bool = True, E0: float | None = None,
            matvec=None) -> torch.Tensor:
    """S(q, omega) via KPM (ref src/KPM_Sqw.jl:172-218), on psi0's device.
    phi_q = S^z_q psi0 is normalized per q; `doubling_trick` halves the
    applies through the product identities. omega is on the absolute energy
    axis of H, as in the reference; pass `E0` (the energy of psi0) to
    evaluate at excitation energies instead, comparable with lanczos_sqw.
    Without (a, b) the rescaling comes from estimate_energy_bounds (random
    start from `generator`). Returns [nq, n_omega]. Spans `kpm.bounds`
    (the window, when drawn here), `kpm.phi` (S^z_q psi0, normalized) and
    `kpm.reconstruct`."""
    from ..utils.profiling import annotate

    if matvec is None:
        matvec = matvec_fn(model, backend, device=psi0.device)
    if a is None or b is None:
        with annotate("kpm.bounds"):
            a, b = _default_rescaling(model, matvec, psi0.device,
                                      lanc_m=lanc_m, generator=generator)
    if E0 is not None:
        omega = np.asarray(omega, np.float64) + E0
    cdtype = complex_dtype(psi0.dtype)
    psi0 = psi0.to(cdtype)
    mvr = _rescaled(matvec, a, b)
    rows = []
    for q in q_list:
        with annotate("kpm.phi"):
            phi = sz_q_vector(model, psi0, float(q), dtype=cdtype)
            nrm = torch.linalg.vector_norm(phi)
            phi = phi / torch.clamp(nrm, min=torch.finfo(nrm.dtype).tiny)
        mu = chebyshev_moments(mvr, phi, kpm_m, doubling_trick=doubling_trick)
        S = kpm_reconstruct(mu, omega, a, b, kernel=kernel, doubling=True,
                            density_2_over_a=False)
        rows.append(torch.where(nrm > 0, S, torch.zeros_like(S)))
    return torch.stack(rows)


def kpm_dynamical_correlation(psi, operator_A, operator_B, omega,
                              model: SpinModel, n: int = 300,
                              a: float | None = None, b: float | None = None,
                              kernel: str = "jackson",
                              backend: str | None = None,
                              generator: torch.Generator | None = None,
                              matvec=None) -> torch.Tensor:
    """T=0 correlation S_AB(omega) = <psi|A^dag delta(omega - H) B|psi>
    (ref src/TimeEvolution/KPM.jl:72-116). operator_X(psi, model) -> X|psi>.
    The reference's second convention: no doubling of the n >= 1 terms, the
    2/a density factor, zero outside |x| >= 1, clipped non-negative."""
    if matvec is None:
        matvec = matvec_fn(model, backend, device=psi.device)
    if a is None or b is None:
        lo, hi = estimate_energy_bounds(
            matvec, model.n_states, lanc_m=min(n, 80), generator=generator,
            device=psi.device)
        a, b = rescaling_params(lo, hi, safety=1.0)
    phi = operator_B(psi, model)
    chi = operator_A(psi, model)
    mu = chebyshev_cross_moments(_rescaled(matvec, a, b), chi, phi, n)
    return kpm_reconstruct(mu, omega, a, b, kernel=kernel, doubling=False,
                           density_2_over_a=True, clamp=None,
                           clip_nonneg=True)


def kpm_correlation_matrix(psi, omega, model: SpinModel, n: int = 300,
                           opA_kind: str = "z", opB_kind: str = "z",
                           a: float | None = None, b: float | None = None,
                           kernel: str = "jackson",
                           backend: str | None = None,
                           generator: torch.Generator | None = None,
                           matvec=None, chunk_B: int | None = None
                           ) -> torch.Tensor:
    """C[i, j, omega] = |S_{A_i B_j}(omega)| for all L x L site pairs (ref
    src/TimeEvolution/KPM.jl:214-235), shared (a, b). One recurrence per B
    site; the moments against every A site come from each iterate at once.
    For the diagonal opA_kind='z' the A-operator stack is never made:
    mu_i = Re(conj(psi) v) . sz_i, through a chunked [N, L] Sz product.

    `chunk_B` is the JAX package's batch of B sites run as one stacked
    recurrence (memory chunk_B x N); it changes the memory, not the
    result. The port always runs one B site at a time (the memory of
    chunk_B = 1), so any chunk_B >= 1 gives this same result."""
    if chunk_B is not None and int(chunk_B) < 1:
        raise ValueError(f"chunk_B must be >= 1, got {chunk_B}")
    from ..observables import _row_states, _sz_columns

    if matvec is None:
        matvec = matvec_fn(model, backend, device=psi.device)
    if a is None or b is None:
        a, b = _default_rescaling(model, matvec, psi.device,
                                  generator=generator)
    L = model.L
    cdtype = complex_dtype(psi.dtype)
    psi = psi.to(cdtype)
    N = psi.shape[0]
    mvr = _rescaled(matvec, a, b)
    compensated = _default_compensated(cdtype)

    if opA_kind == "z":
        chunk = 1 << 18
        states = _row_states(model, psi.device)

        def mu_vs_all_A(v):
            w = (psi.conj() * v).real
            out = torch.zeros(L, dtype=w.dtype, device=w.device)
            for s0 in range(0, N, chunk):
                m = min(chunk, N - s0)
                out += w[s0:s0 + m] @ _sz_columns(s0, m, L, w.dtype,
                                                  w.device, states)
            return out
    else:
        ops_A = [apply_spin_operator(psi, model, i, opA_kind).to(cdtype)
                 for i in range(L)]

        def mu_vs_all_A(v):
            return torch.stack([_inner_c(x, v, compensated).real
                                for x in ops_A])

    rows = []
    for j in range(L):
        phi = apply_spin_operator(psi, model, j, opB_kind).to(cdtype)
        nrm = torch.linalg.vector_norm(phi)
        phi = phi / torch.clamp(nrm, min=torch.finfo(nrm.dtype).tiny)
        mus = [mu_vs_all_A(phi)]
        v_prev, v_curr = phi, mvr(phi)
        mus.append(mu_vs_all_A(v_curr))
        for _ in range(n - 2):
            v_next = 2.0 * mvr(v_curr) - v_prev
            mus.append(mu_vs_all_A(v_next))
            v_prev, v_curr = v_curr, v_next
        rows.append(torch.stack(mus, dim=1) * nrm)  # [L_A, n]
    mu_all = torch.stack(rows)  # [L_B, L_A, n]
    S = kpm_reconstruct(mu_all, omega, a, b, kernel=kernel, doubling=False,
                        density_2_over_a=True, clamp=None, clip_nonneg=True)
    return torch.abs(S.transpose(0, 1))  # [i = A, j = B, W]


def kpm_structure_factor(C, q: float, positions) -> torch.Tensor:
    """S(q, omega) = (1/N) sum_ij e^{-i q (r_i - r_j)} C[i, j, omega] (ref
    src/TimeEvolution/KPM.jl:239-248)."""
    C = torch.as_tensor(C)
    pos = np.asarray(positions, np.float64)
    phase = torch.as_tensor(np.exp(-1j * q * (pos[:, None] - pos[None, :])),
                            device=C.device)
    return torch.einsum("ij,ijw->w", phase,
                        C.to(phase.dtype)).real / pos.shape[0]


def run_kpm_dynamical(model: SpinModel, omega, opA_kind: str = "z",
                      opB_kind: str = "z", n: int = 300,
                      backend: str | None = None, device=None, **kw):
    """Domain-wall start, normalized, full correlation matrix (a working
    version of the reference's wrapper, src/TimeEvolution/KPM.jl:254-267).
    `device` defaults to the card."""
    from ..models.initial_states import domain_wall_state
    from ..utils.device import resolve_device

    device = resolve_device(device)
    psi0 = domain_wall_state(model, dtype=torch.complex64, device=device)
    return kpm_correlation_matrix(psi0, omega, model, n=n, opA_kind=opA_kind,
                                  opB_kind=opB_kind, backend=backend, **kw)
