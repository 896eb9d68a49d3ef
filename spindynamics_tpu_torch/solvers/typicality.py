"""Quantum typicality on flat states: finite-temperature correlation
functions, plus an RK4 stepper (port of spindynamics_tpu/solvers/
typicality.py).

  <A(t) B(0)>_beta  ~=  <psi_beta| e^{iHt} A e^{-iHt} B |psi_beta>

with |psi_beta> = e^{-beta H / 2}|r> / ||e^{-beta H / 2}|r>|| for a random
|r> (one typicality sample; average over generator seeds for error bars).
Time evolution by Krylov, Chebyshev or RK4, every H apply through the
model's FlatHamiltonian (K3 on the card for an embedded model, the ell
apply for a compact one). A torch.Generator replaces the JAX key: the
random start is drawn from it on its device, the real plane first, then
the imaginary plane (`random_start`), so a caller holding the same seed
redraws the same vector.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..model import SpinModel
from ..ops.apply import matvec_fn
from ..utils.device import resolve_device
from ..utils.dtypes import complex_dtype, real_dtype
from .chebyshev import chebyshev_time_evolve
from .krylov import krylov_imaginary_time_evolve, krylov_time_evolve
from .lanczos import estimate_energy_bounds

__all__ = ["rk4_time_step", "thermal_state", "typicality_correlation_function"]


def rk4_time_step(psi: torch.Tensor, matvec, dt: float) -> torch.Tensor:
    """One RK4 step of i d|psi>/dt = H|psi> (ref
    src/TimeEvolution/QuantumTypicality.jl:122-146), in psi's complex
    dtype."""
    psi = psi.to(complex_dtype(psi.dtype))
    z = -1j * dt
    k1 = z * matvec(psi)
    k2 = z * matvec(psi + 0.5 * k1)
    k3 = z * matvec(psi + 0.5 * k2)
    k4 = z * matvec(psi + k3)
    return psi + (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0


def random_start(model: SpinModel, generator: torch.Generator,
                 dtype=torch.complex64, device=None) -> torch.Tensor:
    """The normalized random |r> of one typicality sample: N normal draws
    of the real plane, then N of the imaginary plane, from `generator` on
    its device, in the real dtype of `dtype`; zero outside an embedded
    sector (valid_mask); normalized; moved to `device`."""
    rdtype = real_dtype(dtype)
    N = model.n_states
    re = torch.randn(N, generator=generator, dtype=rdtype,
                     device=generator.device)
    im = torch.randn(N, generator=generator, dtype=rdtype,
                     device=generator.device)
    r = torch.complex(re, im).to(device)
    mask = model.valid_mask(r.device)
    if mask is not None:
        r = torch.where(mask, r, torch.zeros_like(r))
    return (r / torch.linalg.vector_norm(r)).to(dtype)


def thermal_state(model: SpinModel, beta: float,
                  generator: torch.Generator | None = None, kry_m: int = 30,
                  backend: str | None = None, dtype=torch.complex64,
                  device=None, matvec=None):
    """|psi_beta> = e^{-beta H / 2}|r> normalized, plus the squared thermal
    norm Z_r = ||e^{-beta H / 2} r||^2 (one typicality sample of the
    partition function). |r> is `random_start` from `generator` (default
    seed 0 on `device`); e^{-beta H / 2} is one Krylov imaginary-time step
    of kry_m vectors. `device` defaults to the generator's, else the card;
    `matvec` defaults to matvec_fn(model, backend) there."""
    device = resolve_device(device, generator)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    r = random_start(model, generator, dtype, device)
    if matvec is None:
        matvec = matvec_fn(model, backend, device=device)
    psi_b = krylov_imaginary_time_evolve(r, matvec, beta / 2.0, kry_m=kry_m)
    Z = float(torch.vdot(psi_b, psi_b).real)
    return psi_b / float(np.sqrt(Z)), Z


def typicality_correlation_function(
        model: SpinModel, beta: float, operator_A: Callable,
        operator_B: Callable, t_points, method: str = "krylov",
        generator: torch.Generator | None = None, kry_m: int = 30,
        cheb_n: int = 100, rk4_substeps: int = 1,
        backend: str | None = None,
        Ebounds: tuple[float, float] | None = None, device=None,
        dtype=torch.complex64):
    """C(t) = <A(t) B(0)>_beta from one typicality sample (thermal_state
    from `generator`): |phi(t)> = e^{-iHt} B|psi_beta>, |xi(t)> =
    e^{-iHt}|psi_beta>, C(t) = <xi(t)|A|phi(t)>. operator_X(psi, model) ->
    X|psi>. `t_points` must be increasing: the two states are evolved from
    one point to the next, as the reference did
    (src/TimeEvolution/QuantumTypicality.jl:83-96). method: "krylov"
    (unrenormalized), "chebyshev" (bounds from estimate_energy_bounds, start
    seed 7 masked to an embedded sector, unless `Ebounds` is given) or "rk4"
    (rk4_substeps per interval). The states are `dtype` (complex64, as in
    the JAX package; complex128 for validation). `device` defaults to the
    generator's, else the card. Returns a complex128 numpy array [T]."""
    if method not in ("krylov", "chebyshev", "rk4"):
        raise ValueError(f"unknown method {method!r}")
    device = resolve_device(device, generator)
    matvec = matvec_fn(model, backend, device=device)
    psi_b, _ = thermal_state(model, beta, generator=generator, kry_m=kry_m,
                             dtype=dtype, device=device, matvec=matvec)
    phi = operator_B(psi_b, model)
    xi = psi_b
    if method == "chebyshev" and Ebounds is None:
        Ebounds = estimate_energy_bounds(
            matvec, model.n_states, mask=model.valid_mask(device),
            generator=torch.Generator(device=device).manual_seed(7),
            device=device)

    def evolve(v, dt):
        if abs(dt) < 1e-15:
            return v
        if method == "krylov":
            return krylov_time_evolve(v, matvec, dt, kry_m=kry_m,
                                      renormalize=False)
        if method == "chebyshev":
            return chebyshev_time_evolve(v, matvec, dt, Ebounds,
                                         cheb_n=cheb_n)
        h = dt / rk4_substeps
        for _ in range(rk4_substeps):
            v = rk4_time_step(v, matvec, h)
        return v

    t_points = np.asarray(t_points, dtype=np.float64)
    out = np.zeros(t_points.shape[0], dtype=np.complex128)
    prev_t = 0.0
    for k, t in enumerate(t_points):
        dt = float(t - prev_t)
        phi = evolve(phi, dt)
        xi = evolve(xi, dt)
        prev_t = float(t)
        out[k] = complex(torch.vdot(xi, operator_A(phi, model)))
    return out
