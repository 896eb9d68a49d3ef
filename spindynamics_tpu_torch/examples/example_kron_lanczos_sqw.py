"""L=28 Sz=0 Heisenberg S(q, omega) via Lanczos on one card (kron
BlockVec; port of examples/example_kron_lanczos_sqw.py).

Restarted two-pass Lanczos ground state, then per q a basis-free Lanczos
tridiagonalization of phi_q = S^z_q|psi0> held as (re, im) planes
(lanczos_sqw_kron, the port's default plane_mode "pair", the reference's
complex recurrence; the JAX run on the TPU took "split") and pole
broadening on the host. Every H apply through K1 on the card.

    python -m spindynamics_tpu_torch.examples.example_kron_lanczos_sqw \\
        [L] [lanc_m] [nq]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import _common


def run(L: int = 28, lanc_m: int = 100, nq: int = 8, device=None,
        dtype=torch.float32, seed: int = 0, psi0=None, E0=None,
        emit=_common.quiet) -> dict:
    """The ground state (40 x 8 cycles), unless `psi0` and `E0` are given,
    then S(q, omega) at q = 2 pi k / L, k = 1..nq, omega in [0, 4] (100
    points), eta = 0.05. Returns {"E0", "residual", "qs", "omega", "S"}."""
    import spindynamics_tpu_torch as pt

    device = pt.resolve_device(device, psi0)
    info = None
    if psi0 is None or E0 is None:
        model, E0, psi0, info, _ = _common.kron_ground_state(
            L, 40, 8, 1e-3, device, dtype, seed, emit)
    else:
        model = pt.xxz_chain(L, Jxy=1.0, Jz=1.0, nup=L // 2, dtype=dtype,
                             layout="sector_kron")
    qs = [2 * np.pi * k / L for k in range(1, nq + 1)]
    omega = np.linspace(0.0, 4.0, 100)
    t0 = time.perf_counter()
    S, _ = pt.lanczos_sqw_kron(model, qs, omega, lanc_m=lanc_m, eta=0.05,
                               psi0=psi0, E0=E0, info=info, device=device)
    emit({"stage": "lanczos_sqw", "lanc_m": lanc_m, "nq": nq,
          "S_max": float(S.max()), "wall_s": _common.elapsed(t0, device)})
    return {"E0": E0, "residual": None if info is None else info["residual"],
            "qs": qs, "omega": omega, "S": S}


def main(argv=None) -> dict:
    ap = _common.parser(__doc__, "example_kron_lanczos_sqw")
    ap.add_argument("L", type=int, nargs="?", default=28)
    ap.add_argument("lanc_m", type=int, nargs="?", default=100)
    ap.add_argument("nq", type=int, nargs="?", default=8)
    args = ap.parse_args(argv)
    device, dtype = _common.resolve(ap, args, kron=True)
    out = run(args.L, args.lanc_m, args.nq, device=device, dtype=dtype,
              seed=args.seed, emit=_common.emit)

    def draw(plt):
        fig, ax = plt.subplots(figsize=(6, 4))
        im = ax.pcolormesh(np.asarray(out["qs"]), out["omega"], out["S"].T,
                           shading="auto", cmap="inferno")
        ax.set_xlabel("q")
        ax.set_ylabel("omega")
        ax.set_title(f"Lanczos S(q, omega), L={args.L} Sz=0 Heisenberg, "
                     "one card")
        fig.colorbar(im, ax=ax, label="S(q, omega)")
        return fig

    _common.save_plot(args.out_dir, f"example_kron_lanczos_sqw_L{args.L}.png",
                      draw)
    return out


if __name__ == "__main__":
    main()
