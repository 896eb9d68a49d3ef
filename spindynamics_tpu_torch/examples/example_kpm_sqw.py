"""KPM dynamic structure factor (port of examples/example_kpm_sqw.py: L=20
Sz=0 Heisenberg, kpm_m=100, Jackson kernel, omega in [0, 5]).

The model is built on the JAX package's default layout, compact. S is
evaluated at excitation energies (E0 shift), comparable with Lanczos.

    python -m spindynamics_tpu_torch.examples.example_kpm_sqw \\
        [--L 20] [--kpm-m 100] [--nq NQ]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import _common


def run(L: int = 20, kpm_m: int = 100, n_omega: int = 50,
        omega_max: float = 5.0, lanc_m: int = 100, nq=None, device=None,
        dtype=torch.float32, seed: int = 0, psi0=None, E0=None, bounds=None,
        emit=_common.quiet) -> dict:
    """Ground state (lanc_m, stored basis) unless `psi0` and `E0` are
    given, bounds (an 80-step Lanczos estimate unless `bounds` is given),
    then S(q, omega) at q = 2 pi k / L for k < nq (default: all L).
    Returns {"mode", "E0", "psi0", "a", "b", "qs", "omega",
    "S" [nq, n_omega]}."""
    import spindynamics_tpu_torch as pt

    device = pt.resolve_device(device, psi0)
    g = _common.generator(device, seed)
    model = pt.heisenberg_chain(L, J=1.0, nup=L // 2, dtype=dtype,
                                layout="compact")
    mv = pt.matvec_fn(model, device=device)
    emit({"stage": "model", "L": L, "N": model.n_states, "mode": model.mode})
    if psi0 is None or E0 is None:
        t0 = time.perf_counter()
        E0, psi0, _ = pt.lanczos_groundstate(mv, model.n_states,
                                             lanc_m=lanc_m, dtype=dtype,
                                             generator=g, device=device)
        emit({"stage": "groundstate", "E0": E0,
              "s": _common.elapsed(t0, device)})
    if bounds is None:
        bounds = pt.estimate_energy_bounds(mv, model.n_states, lanc_m=80,
                                           dtype=dtype, generator=g,
                                           device=device)
    a, b = pt.rescaling_params(*bounds)
    qs = [2 * np.pi * k / L for k in range(L if nq is None else nq)]
    omega = np.linspace(0.0, omega_max, n_omega)
    t0 = time.perf_counter()
    # E0 shift: evaluate at excitation energies
    S = pt.kpm_sqw(psi0, model, qs, omega, a=a, b=b, kpm_m=kpm_m, E0=E0,
                   matvec=mv).cpu().double().numpy()
    emit({"stage": "kpm_sqw", "nq": len(qs), "kpm_m": kpm_m,
          "S_max": float(S.max()), "s": _common.elapsed(t0, device)})
    return {"mode": model.mode, "E0": E0, "psi0": psi0, "a": a, "b": b,
            "qs": qs, "omega": omega, "S": S}


def main(argv=None) -> dict:
    ap = _common.parser(__doc__, "example_kpm_sqw")
    ap.add_argument("--L", type=int, default=20)
    ap.add_argument("--kpm-m", type=int, default=100, dest="kpm_m")
    ap.add_argument("--nq", type=int, default=None,
                    help="the first NQ q-points only (default: all L)")
    args = ap.parse_args(argv)
    device, dtype = _common.resolve(ap, args)
    out = run(args.L, args.kpm_m, nq=args.nq, device=device, dtype=dtype,
              seed=args.seed, emit=_common.emit)

    def draw(plt):
        fig = plt.figure(figsize=(6, 4))
        plt.imshow(out["S"].T, aspect="auto", origin="lower",
                   extent=[0, 2 * np.pi * len(out["qs"]) / args.L, 0, 5.0],
                   cmap="inferno")
        plt.xlabel("q")
        plt.ylabel("omega")
        plt.title(f"KPM S(q,w)  L={args.L} Sz=0 Heisenberg")
        plt.colorbar()
        fig.tight_layout()
        return fig

    _common.save_plot(args.out_dir, f"example_kpm_sqw_L{args.L}.png", draw)
    return out


if __name__ == "__main__":
    main()
