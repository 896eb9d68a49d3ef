"""KPM density of states of the Neel state with 1024 Chebyshev moments,
cross-validated against the Lanczos spectrum from the same state (port of
examples/example_kpm_dos.py: L=16 Sz=0 Heisenberg).

The model is built on the JAX package's default layout, compact.

    python -m spindynamics_tpu_torch.examples.example_kpm_dos \\
        [--L 16] [--kpm-m 1024]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import _common


def run(L: int = 16, kpm_m: int = 1024, lanc_m: int = 200,
        n_omega: int = 3000, device=None, dtype=torch.float32, seed: int = 0,
        bounds=None, emit=_common.quiet) -> dict:
    """rho(w) = <Neel| delta(w - H) |Neel> by KPM (doubling: kpm_m / 2
    applies, Jackson kernel) and by a lanc_m-step Lanczos spectrum with
    Gaussian poles of the KPM width; `bounds` fixes the spectral bounds
    (default: a 100-step Lanczos estimate). n_omega must resolve the
    Jackson width pi a / kpm_m (>= 2 points a width). Returns {"mode",
    "bounds", "omega", "rho_kpm", "rho_lanc", "integral_kpm",
    "integral_lanc", "ks", "corr"}."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.utils.dtypes import complex_dtype

    device = pt.resolve_device(device)
    model = pt.xxz_chain(L, Jxy=1.0, Jz=1.0, nup=L // 2, dtype=dtype,
                         layout="compact")
    mv = pt.matvec_fn(model, device=device)
    emit({"stage": "model", "L": L, "N": model.n_states, "mode": model.mode})
    if bounds is None:
        bounds = pt.estimate_energy_bounds(
            mv, model.n_states, lanc_m=100, dtype=dtype,
            generator=_common.generator(device, seed), device=device)
    a, b = pt.rescaling_params(*bounds)

    # local DOS of the Neel state: rho(w) = <Neel| delta(w - H) |Neel>
    psi = pt.neel_state(model, dtype=complex_dtype(dtype), device=device)
    t0 = time.perf_counter()
    mu = pt.chebyshev_moments(lambda v: (mv(v) - v * b) * (1.0 / a), psi,
                              kpm_m, doubling_trick=True)
    omega = np.linspace(bounds[0], bounds[1], n_omega)
    rho_kpm = pt.kpm_reconstruct(
        mu, omega, a, b, kernel="jackson", doubling=True, clamp=None,
        density_2_over_a=False).cpu().double().numpy() / a
    emit({"stage": "kpm", "kpm_m": kpm_m, "matvecs": kpm_m // 2,
          "s": _common.elapsed(t0, device)})

    # the Lanczos spectrum of the same state: with 1024 moments the KPM
    # resolution (pi a / M ~ 0.04) is finer than lanc_m poles represent
    # pointwise, so the cross-check is the cumulative distribution
    t0 = time.perf_counter()
    alphas, betas, nrm = pt.lanczos_tridiag(mv, psi, lanc_m=lanc_m)
    rho_lanc = pt.spectral_from_tridiagonal(
        alphas, betas, float(nrm), 0.0, omega, eta=np.pi * a / kpm_m,
        broaden="gauss")
    emit({"stage": "lanczos", "lanc_m": lanc_m,
          "s": _common.elapsed(t0, device)})

    i_kpm = float(np.trapezoid(rho_kpm, omega))
    i_lanc = float(np.trapezoid(rho_lanc, omega))
    dw = omega[1] - omega[0]
    ks = float(np.abs(np.cumsum(rho_kpm) * dw
                      - np.cumsum(rho_lanc) * dw).max())
    corr = float(np.corrcoef(rho_kpm, rho_lanc)[0, 1])
    emit({"stage": "compare", "integral_kpm": i_kpm,
          "integral_lanczos": i_lanc, "ks": ks, "pointwise_corr": corr})
    return {"mode": model.mode, "bounds": tuple(bounds), "omega": omega,
            "rho_kpm": rho_kpm, "rho_lanc": rho_lanc,
            "integral_kpm": i_kpm, "integral_lanc": i_lanc, "ks": ks,
            "corr": corr}


def main(argv=None) -> dict:
    ap = _common.parser(__doc__, "example_kpm_dos")
    ap.add_argument("--L", type=int, default=16)
    ap.add_argument("--kpm-m", type=int, default=1024, dest="kpm_m")
    args = ap.parse_args(argv)
    device, dtype = _common.resolve(ap, args)
    out = run(args.L, args.kpm_m, device=device, dtype=dtype,
              seed=args.seed, emit=_common.emit)

    def draw(plt):
        fig = plt.figure(figsize=(7, 4))
        plt.plot(out["omega"], out["rho_kpm"],
                 label=f"KPM ({args.kpm_m} moments, Jackson)")
        plt.plot(out["omega"], out["rho_lanc"], "--",
                 label="Lanczos (m=200, Gauss)")
        plt.xlabel("E")
        plt.ylabel("local DOS of |Neel>")
        plt.legend()
        fig.tight_layout()
        return fig

    _common.save_plot(args.out_dir, f"example_kpm_dos_L{args.L}.png", draw)
    return out


if __name__ == "__main__":
    main()
