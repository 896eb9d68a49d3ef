"""Finite-T spin correlations at L=28 on one card by quantum typicality
(port of examples/example_kron_typicality.py).

C(t) = <Sz_a(t) Sz_b(0)>_beta from one random BlockVec plane pair: the
imaginary-time thermal state, then the Chebyshev co-evolution, every apply
through K1 and every Chebyshev term k >= 2 through K2
(typicality_correlation_kron).

    python -m spindynamics_tpu_torch.examples.example_kron_typicality \\
        [L] [beta] [n_t] [t_max]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import _common


def run(L: int = 28, beta: float = 1.0, n_t: int = 6, t_max: float = 2.0,
        device=None, dtype=torch.float32, seed: int = 0, r0=None,
        Ebounds=None, emit=_common.quiet) -> dict:
    """C(t) at n_t times in [0, t_max] for a = b = L/2 (kry_m 14, cheb_n
    30), from the random pair `r0` or one drawn from `seed`; `Ebounds`
    fixes the spectral bounds. The JAX script's checks hold or this
    raises AssertionError: 0 < C(0) <= 1/4 and |C(t)| <= C(0).
    Returns {"t", "C" (complex [n_t])}."""
    import spindynamics_tpu_torch as pt

    device = pt.resolve_device(device, r0)
    t0 = time.perf_counter()
    model = pt.xxz_chain(L, Jxy=1.0, Jz=1.0, nup=L // 2, dtype=dtype,
                         layout="sector_kron")
    emit({"stage": "model", "L": L, "N": int(pt.sector_dimension(L, L // 2)),
          "beta": beta, "s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    ts = np.linspace(0.0, t_max, n_t)
    site = L // 2
    C = pt.typicality_correlation_kron(
        model, beta, site, site, ts, kry_m=14, cheb_n=30, Ebounds=Ebounds,
        generator=_common.generator(device, seed), r0=r0, device=device)
    emit({"stage": "typicality", "site": site, "t": ts.tolist(),
          "C_real": C.real.tolist(), "C_imag": C.imag.tolist(),
          "s": _common.elapsed(t0, device)})
    # C(0) = <Sz^2>_beta must be positive and <= 1/4; |C(t)| <= C(0)
    if not 0.0 < C[0].real <= 0.2500001:
        raise AssertionError(C[0])
    if not all(abs(c) <= C[0].real + 1e-6 for c in C):
        raise AssertionError(C)
    emit({"stage": "checks", "ok": True})
    return {"t": ts, "C": C}


def main(argv=None) -> dict:
    ap = _common.parser(__doc__, "example_kron_typicality")
    ap.add_argument("L", type=int, nargs="?", default=28)
    ap.add_argument("beta", type=float, nargs="?", default=1.0)
    ap.add_argument("n_t", type=int, nargs="?", default=6)
    ap.add_argument("t_max", type=float, nargs="?", default=2.0)
    args = ap.parse_args(argv)
    device, dtype = _common.resolve(ap, args, kron=True)
    return run(args.L, args.beta, args.n_t, args.t_max, device=device,
               dtype=dtype, seed=args.seed, emit=_common.emit)


if __name__ == "__main__":
    main()
