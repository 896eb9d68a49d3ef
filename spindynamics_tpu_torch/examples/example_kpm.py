"""Local KPM autocorrelations C_ii(omega) and the site-averaged spectral
density (port of examples/example_kpm.py: L=8 Sz=0 XXZ, Jz=0.5), with the
sparse eigensolver cross-check of the ground state and the bounds.

The model is built on the JAX package's default layout, compact.

    python -m spindynamics_tpu_torch.examples.example_kpm \\
        [--L 8] [--n-moments 200]
"""

from __future__ import annotations

import numpy as np
import torch

from . import _common


def run(L: int = 8, n_moments: int = 200, n_omega: int = 300, device=None,
        dtype=torch.float32, seed: int = 0, bounds=None,
        emit=_common.quiet) -> dict:
    """Ground state (lanc_m 80), bounds (lanc_m 60, unless `bounds` is
    given), the scipy eigsh
    cross-check of E0 and Emax on H built column by column from the same
    apply (raises AssertionError when E0 differs by 1e-6 max(1, |E0|) or
    Emax lies above the bounds), then C_ii(omega) for every site.
    Returns {"mode", "E0", "Ebounds", "eigsh", "omega",
    "C_auto" [L, n_omega], "weight"}."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.utils.dtypes import complex_dtype

    device = pt.resolve_device(device)
    g = _common.generator(device, seed)
    model = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2, dtype=dtype,
                         layout="compact")
    N = model.n_states
    mv = pt.matvec_fn(model, device=device)
    E0, psi0, _ = pt.lanczos_groundstate(mv, N, lanc_m=80, dtype=dtype,
                                         generator=g, device=device)
    Emin, Emax = bounds or pt.estimate_energy_bounds(
        mv, N, lanc_m=60, dtype=dtype, generator=g, device=device)
    a, b = pt.rescaling_params(Emin, Emax)
    emit({"stage": "groundstate", "L": L, "N": N, "mode": model.mode,
          "E0": E0, "Ebounds": [Emin, Emax]})

    # the sparse eigensolver cross-check (examples/example_kpm.jl:29-65):
    # H column by column from the same apply, against scipy's implicitly
    # restarted Lanczos
    eye = torch.eye(N, dtype=dtype, device=device)
    H = sp.csr_matrix(np.stack([mv(eye[j]).cpu().numpy() for j in range(N)],
                               axis=1))
    e_lo = float(spla.eigsh(H, k=1, which="SA",
                            return_eigenvectors=False)[0])
    e_hi = float(spla.eigsh(H, k=1, which="LA",
                            return_eigenvectors=False)[0])
    emit({"stage": "eigsh", "E0": e_lo, "diff": abs(e_lo - E0),
          "Emax": e_hi})
    if not abs(e_lo - E0) < 1e-6 * max(1.0, abs(E0)):
        raise AssertionError((e_lo, E0))
    if not e_hi <= Emax + 1e-8:  # the bounds must enclose the spectrum
        raise AssertionError((e_hi, Emax))

    omega = np.linspace(Emin, Emax, n_omega)
    psi0c = psi0.to(complex_dtype(dtype))
    C_auto = []
    for i in range(L):
        op = pt.make_spin_operator(i, "z")
        C_auto.append(pt.kpm_dynamical_correlation(
            psi0c, op, op, omega, model, n=n_moments, a=a, b=b,
            matvec=mv).cpu().double().numpy())
    C_auto = np.asarray(C_auto)
    weight = float(np.trapezoid(C_auto.mean(axis=0), omega))
    emit({"stage": "kpm", "n_moments": n_moments,
          "site_averaged_weight": weight})
    return {"mode": model.mode, "E0": E0, "Ebounds": (Emin, Emax),
            "eigsh": (e_lo, e_hi), "omega": omega, "C_auto": C_auto,
            "weight": weight}


def main(argv=None) -> dict:
    ap = _common.parser(__doc__, "example_kpm")
    ap.add_argument("--L", type=int, default=8)
    ap.add_argument("--n-moments", type=int, default=200, dest="n_moments")
    args = ap.parse_args(argv)
    device, dtype = _common.resolve(ap, args)
    out = run(args.L, args.n_moments, device=device, dtype=dtype,
              seed=args.seed, emit=_common.emit)

    def draw(plt):
        fig = plt.figure(figsize=(6, 4))
        w = out["omega"] - out["E0"]
        for row in out["C_auto"]:
            plt.plot(w, row, alpha=0.4)
        plt.plot(w, out["C_auto"].mean(axis=0), "k-", lw=2,
                 label="site average")
        plt.xlabel("omega - E0")
        plt.ylabel("C_ii(omega)")
        plt.legend()
        fig.tight_layout()
        return fig

    _common.save_plot(args.out_dir, f"example_kpm_L{args.L}.png", draw)
    return out


if __name__ == "__main__":
    main()
