"""L=24 Sz=0 T=0 site-pair correlation matrix C[i, j, omega] on one card
(port of examples/example_kron_corr.py).

Per B site one Chebyshev recurrence through K1 with the moments against
all A sites in one pass over the state (kpm_correlation_matrix_kron), B
sites around the chain centre.

    python -m spindynamics_tpu_torch.examples.example_kron_corr \\
        [L] [n_moments] [n_sites]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import _common


def run(L: int = 24, n: int = 150, n_sites: int = 6, device=None,
        dtype=torch.float32, seed: int = 0, psi0=None, E0=None, a=None,
        b=None, emit=_common.quiet) -> dict:
    """The ground state (40 x 8 cycles), unless `psi0` and `E0` are given,
    then C[i, j, omega] for the n_sites B sites around L/2, omega in
    [E0 - 1, E0 + 5] (120 points); (a, b) fix the rescaling. Returns
    {"E0", "residual", "sites", "omega", "C" [L, n_sites, 120], "a", "b"}."""
    import spindynamics_tpu_torch as pt

    device = pt.resolve_device(device, psi0)
    info = None
    if psi0 is None or E0 is None:
        model, E0, psi0, info, _ = _common.kron_ground_state(
            L, 40, 8, 1e-3, device, dtype, seed, emit)
    else:
        model = pt.xxz_chain(L, Jxy=1.0, Jz=1.0, nup=L // 2, dtype=dtype,
                             layout="sector_kron")
    # B sites around the chain centre; A runs over all L sites in one pass
    sites = list(range(L // 2 - n_sites // 2, L // 2 + (n_sites + 1) // 2))
    omega = np.linspace(float(E0) - 1.0, float(E0) + 5.0, 120)
    t0 = time.perf_counter()
    C, cinfo = pt.kpm_correlation_matrix_kron(
        model, omega, n=n, psi0=psi0, E0=E0, info=info, sites=sites, a=a,
        b=b, device=device)
    emit({"stage": "corr_matrix", "n": n, "sites": sites,
          "C_max": float(C.max()), "wall_s": _common.elapsed(t0, device)})
    return {"E0": E0, "residual": None if info is None else info["residual"],
            "sites": sites, "omega": omega, "C": C, "a": cinfo["a"],
            "b": cinfo["b"]}


def main(argv=None) -> dict:
    ap = _common.parser(__doc__, "example_kron_corr")
    ap.add_argument("L", type=int, nargs="?", default=24)
    ap.add_argument("n", type=int, nargs="?", default=150)
    ap.add_argument("n_sites", type=int, nargs="?", default=6)
    args = ap.parse_args(argv)
    device, dtype = _common.resolve(ap, args, kron=True)
    out = run(args.L, args.n, args.n_sites, device=device, dtype=dtype,
              seed=args.seed, emit=_common.emit)
    L, C, sites, E0 = args.L, out["C"], out["sites"], float(out["E0"])
    w = out["omega"] - E0

    def draw(plt):
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        j0 = sites.index(L // 2)
        im = axes[0].pcolormesh(np.arange(L), w, C[:, j0, :].T,
                                shading="auto", cmap="inferno")
        axes[0].set_xlabel("site i")
        axes[0].set_ylabel("omega - E0")
        axes[0].set_title(f"|S_ij(omega)|, j={L // 2}, L={L}")
        fig.colorbar(im, ax=axes[0])
        axes[1].plot(w, C[L // 2, j0, :], label="i=j (local)")
        # odd separations carry negative (staggered) SzSz weight, which
        # the clamp-nonnegative convention zeroes: i = j+2 shows the
        # off-site spectrum
        if L // 2 + 2 < L:
            axes[1].plot(w, C[L // 2 + 2, j0, :], label="i=j+2")
        axes[1].set_xlabel("omega - E0")
        axes[1].set_ylabel("|S_ij(omega)|")
        axes[1].legend()
        fig.tight_layout()
        return fig

    _common.save_plot(args.out_dir, f"example_kron_corr_L{L}.png", draw)
    return out


if __name__ == "__main__":
    main()
