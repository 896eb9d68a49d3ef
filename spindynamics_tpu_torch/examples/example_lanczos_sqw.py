"""Lanczos dynamic structure factor S(q, omega) (port of
examples/example_lanczos_sqw.py: L=16 Sz=0 Heisenberg, lanc_m=100,
eta=0.05).

The model is built on the JAX package's default layout, compact.

    python -m spindynamics_tpu_torch.examples.example_lanczos_sqw \\
        [--L 16] [--lanc-m 100]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import _common


def run(L: int = 16, lanc_m: int = 100, eta: float = 0.05,
        n_omega: int = 200, omega_max: float = 4.0, device=None,
        dtype=torch.float32, seed: int = 0, psi0=None,
        emit=_common.quiet) -> dict:
    """Ground state (lanc_m, stored basis) unless `psi0` is given, then
    S(q, omega) at every q = 2 pi k / L. Returns {"mode", "E0",
    "residual", "qs", "omega", "S" [L, n_omega]}."""
    import spindynamics_tpu_torch as pt

    device = pt.resolve_device(device, psi0)
    model = pt.heisenberg_chain(L, J=1.0, nup=L // 2, dtype=dtype,
                                layout="compact")
    mv = pt.matvec_fn(model, device=device)
    emit({"stage": "model", "L": L, "N": model.n_states, "mode": model.mode})
    E0 = residual = None
    if psi0 is None:
        t0 = time.perf_counter()
        E0, psi0, info = pt.lanczos_groundstate(
            mv, model.n_states, lanc_m=lanc_m, dtype=dtype,
            generator=_common.generator(device, seed), device=device)
        residual = info["residual"]
        emit({"stage": "groundstate", "E0": E0, "residual": residual,
              "s": _common.elapsed(t0, device)})
    qs = [2 * np.pi * k / L for k in range(L)]
    omega = np.linspace(0.0, omega_max, n_omega)
    t0 = time.perf_counter()
    S = pt.lanczos_sqw(psi0, model, qs, omega, lanc_m=lanc_m, eta=eta,
                       matvec=mv)
    emit({"stage": "lanczos_sqw", "nq": len(qs), "S_max": float(S.max()),
          "s": _common.elapsed(t0, device)})
    return {"mode": model.mode, "E0": E0, "residual": residual, "qs": qs,
            "omega": omega, "S": S}


def main(argv=None) -> dict:
    ap = _common.parser(__doc__, "example_lanczos_sqw")
    ap.add_argument("--L", type=int, default=16)
    ap.add_argument("--lanc-m", type=int, default=100, dest="lanc_m")
    args = ap.parse_args(argv)
    device, dtype = _common.resolve(ap, args)
    out = run(args.L, args.lanc_m, device=device, dtype=dtype,
              seed=args.seed, emit=_common.emit)

    def draw(plt):
        fig = plt.figure(figsize=(6, 4))
        plt.imshow(out["S"].T, aspect="auto", origin="lower",
                   extent=[0, 2 * np.pi, 0, 4.0], cmap="inferno")
        plt.xlabel("q")
        plt.ylabel("omega")
        plt.title(f"Lanczos S(q,w)  L={args.L} Sz=0 Heisenberg")
        plt.colorbar()
        fig.tight_layout()
        return fig

    _common.save_plot(args.out_dir, f"example_lanczos_sqw_L{args.L}.png",
                      draw)
    return out


if __name__ == "__main__":
    main()
