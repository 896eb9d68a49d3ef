"""Magnetization dynamics: exact expm against Chebyshev against Krylov
(port of examples/example.py: L=14 nup=12 XXZ, Jxy=1, Jz=0.5, 200 steps
to t=5).

The model is built on the JAX package's default layout, compact (the
ascending Sz sector with its ELL neighbour table; the apply is plain
torch). The exact evolution is a dense expm on the host, in float64.

    python -m spindynamics_tpu_torch.examples.example \\
        [--L 14] [--nup 12] [--n-steps 200]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import _common


def run(L: int = 14, nup: int = 12, Jxy: float = 1.0, Jz: float = 0.5,
        t_max: float = 5.0, n_steps: int = 200, cheb_n: int = 10,
        kry_m: int = 50, exact=None, device=None, dtype=torch.float32,
        seed: int = 0, emit=_common.quiet) -> dict:
    """Both engines step the domain wall n_steps times by dt = t_max /
    n_steps; `exact` (default: N <= 4096) adds the dense expm evolution and
    the fidelities to it. Returns {"mode", "N", "Ebounds", "mags_cheb",
    "mags_kry", "mags_exact" ([n_steps, L] numpy each; mags_exact empty
    without exact), "fid_cheb", "fid_kry"}."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.utils.dtypes import complex_dtype

    device = pt.resolve_device(device)
    dt = t_max / n_steps
    model = pt.xxz_chain(L, Jxy=Jxy, Jz=Jz, nup=nup, dtype=dtype,
                         layout="compact")
    N = model.n_states
    emit({"stage": "model", "L": L, "nup": nup, "N": N, "mode": model.mode})
    mv = pt.matvec_fn(model, device=device)
    psi0 = pt.domain_wall_state(model, dtype=complex_dtype(dtype),
                                device=device)
    Emin, Emax = pt.estimate_energy_bounds(
        mv, N, lanc_m=60, dtype=dtype,
        generator=_common.generator(device, seed), device=device)
    emit({"stage": "bounds", "Ebounds": [Emin, Emax]})
    coeffs = pt.chebyshev_coefficients(dt, Emin, Emax, cheb_n)

    if exact is None:
        exact = N <= 4096
    psi_exact = U = None
    if exact:
        import scipy.linalg

        U = scipy.linalg.expm(-1j * dt * pt.build_dense_H(model))
        psi_exact = psi0.cpu().numpy().astype(np.complex128)

    mags_cheb, mags_kry, mags_exact, fid_cheb, fid_kry = [], [], [], [], []
    psi_c = psi_k = psi0
    t0 = time.perf_counter()
    for _ in range(n_steps):
        psi_c = pt.chebyshev_time_evolve(psi_c, mv, dt, (Emin, Emax),
                                         cheb_n=cheb_n, coeffs=coeffs)
        psi_k = pt.krylov_time_evolve(psi_k, mv, dt, kry_m=kry_m)
        mags_cheb.append(pt.magnetization_per_site(psi_c, model).cpu())
        mags_kry.append(pt.magnetization_per_site(psi_k, model).cpu())
        if psi_exact is not None:
            psi_exact = U @ psi_exact
            mags_exact.append(pt.magnetization_per_site(
                torch.from_numpy(psi_exact), model))
            fid_cheb.append(abs(np.vdot(psi_exact, psi_c.cpu().numpy())))
            fid_kry.append(abs(np.vdot(psi_exact, psi_k.cpu().numpy())))
    rec = {"stage": "evolution", "steps": n_steps, "engines": 2,
           "s": _common.elapsed(t0, device)}
    if fid_cheb:
        rec.update(fidelity_chebyshev=float(fid_cheb[-1]),
                   fidelity_krylov=float(fid_kry[-1]))
    emit(rec)

    def stack(mags):
        return (torch.stack(mags).double().numpy() if mags
                else np.zeros((0, L)))

    return {"mode": model.mode, "N": N, "Ebounds": (Emin, Emax),
            "mags_cheb": stack(mags_cheb), "mags_kry": stack(mags_kry),
            "mags_exact": stack(mags_exact),
            "fid_cheb": np.asarray(fid_cheb), "fid_kry": np.asarray(fid_kry)}


def main(argv=None) -> dict:
    ap = _common.parser(__doc__, "example")
    ap.add_argument("--L", type=int, default=14)
    ap.add_argument("--nup", type=int, default=12)
    ap.add_argument("--n-steps", type=int, default=200, dest="n_steps")
    args = ap.parse_args(argv)
    device, dtype = _common.resolve(ap, args)
    out = run(args.L, args.nup, n_steps=args.n_steps,
              device=device, dtype=dtype, seed=args.seed, emit=_common.emit)

    def draw(plt):
        panels = [("chebyshev", out["mags_cheb"]), ("krylov", out["mags_kry"])]
        if len(out["mags_exact"]):
            panels.append(("exact", out["mags_exact"]))
        fig, axes = plt.subplots(1, len(panels), figsize=(12, 4))
        for ax, (name, data) in zip(np.atleast_1d(axes), panels):
            im = ax.imshow(data.T, aspect="auto", origin="lower",
                           extent=[0, 5.0, 0, args.L], cmap="RdBu_r")
            ax.set_title(name)
            ax.set_xlabel("t")
            ax.set_ylabel("site")
            fig.colorbar(im, ax=ax)
        fig.tight_layout()
        return fig

    _common.save_plot(args.out_dir, f"example_L{args.L}_nup{args.nup}.png",
                      draw)
    return out


if __name__ == "__main__":
    main()
