"""L=28 Sz=0 domain-wall magnetization dynamics on one card (BlockVec kron;
port of examples/example_kron_evolve.py).

The reference's flagship demo, domain-wall melting with <Sz_i> per step,
at N = C(28,14) = 40,116,600: the state is a (re, im) BlockVec plane pair,
each step one Chebyshev-Bessel expansion whose terms k >= 2 run through K2
and whose bounds come from a Lanczos run through K1.

    python -m spindynamics_tpu_torch.examples.example_kron_evolve \\
        [L] [n_steps] [dt] [cheb_n]

Writes the magnetization and the norms as example_kron_evolve_L{L}.npz
(the keys of the JAX package's file) and the plot under --out-dir.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from . import _common


def run(L: int = 28, n_steps: int = 60, dt: float = 0.1, cheb_n: int = 30,
        device=None, dtype=torch.float32, seed: int = 0,
        emit=_common.quiet) -> dict:
    """evolve_trajectory_kron from the domain wall of the Heisenberg chain
    (Jxy = Jz = 1); the bounds' Lanczos start from `seed`. Returns
    {"magnetization" [n_steps, L], "norms" [n_steps], "Ebounds", "N"}."""
    import spindynamics_tpu_torch as pt

    device = pt.resolve_device(device)
    t0 = time.perf_counter()
    model = pt.xxz_chain(L, Jxy=1.0, Jz=1.0, nup=L // 2, dtype=dtype,
                         layout="sector_kron")
    N = int(pt.sector_dimension(L, L // 2))
    emit({"stage": "model", "L": L, "nup": L // 2, "N": N,
          "n_states_padded": model.n_states, "s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    _, obs, info = pt.evolve_trajectory_kron(
        model, pt.domain_wall_bitstring(model), dt, n_steps, cheb_n=cheb_n,
        generator=_common.generator(device, seed), device=device)
    s = _common.elapsed(t0, device)
    emit({"stage": "trajectory", "steps": n_steps, "dt": dt,
          "cheb_n": cheb_n, "s": s, "steps_per_s": n_steps / s,
          "norm_drift_total": float(abs(info["norms"][-1] - 1.0)),
          "sz_conservation_max_abs": float(np.abs(obs.sum(axis=1)).max()),
          "Ebounds": list(info["Ebounds"])})
    return {"magnetization": obs, "norms": info["norms"],
            "Ebounds": info["Ebounds"], "N": N}


def main(argv=None) -> dict:
    ap = _common.parser(__doc__, "example_kron_evolve")
    ap.add_argument("L", type=int, nargs="?", default=28)
    ap.add_argument("n_steps", type=int, nargs="?", default=60)
    ap.add_argument("dt", type=float, nargs="?", default=0.1)
    ap.add_argument("cheb_n", type=int, nargs="?", default=30)
    args = ap.parse_args(argv)
    device, dtype = _common.resolve(ap, args, kron=True)
    out = run(args.L, args.n_steps, args.dt, args.cheb_n, device=device,
              dtype=dtype, seed=args.seed, emit=_common.emit)
    npz = Path(args.out_dir) / f"example_kron_evolve_L{args.L}.npz"
    npz.parent.mkdir(parents=True, exist_ok=True)
    np.savez(npz, magnetization=out["magnetization"], norms=out["norms"])
    _common.emit({"stage": "data", "file": str(npz)})

    def draw(plt):
        fig, ax = plt.subplots(figsize=(7, 4.2), constrained_layout=True)
        t = (1 + np.arange(args.n_steps)) * args.dt
        im = ax.imshow(out["magnetization"].T, aspect="auto", origin="lower",
                       cmap="RdBu_r", vmin=-0.5, vmax=0.5,
                       extent=[t[0], t[-1], -0.5, args.L - 0.5])
        ax.set_xlabel("t")
        ax.set_ylabel("site i")
        ax.set_title(f"domain-wall melting, L={args.L} Sz=0 Heisenberg "
                     f"(N={out['N']:,}), one card")
        fig.colorbar(im, ax=ax, label=r"$\langle S^z_i \rangle$")
        return fig

    _common.save_plot(args.out_dir, f"example_kron_evolve_L{args.L}.png",
                      draw)
    return out


if __name__ == "__main__":
    main()
