"""L=32 Sz=0 Heisenberg ground state on one card via the sector_kron layout
(port of scripts/l32_groundstate.py).

N = C(32,16) = 601,080,390. Restarted two-pass Lanczos + Chebyshev-filter
polish (O(3N) memory) over BlockVec states, every H apply through K1.
The JAX script's FUSED environment switch is not carried: K1 runs on the
card, its plain version on the CPU.

    python -m spindynamics_tpu_torch.examples.l32_groundstate \\
        [lanc_m] [cycles] [target_residual] [--L 32]
"""

from __future__ import annotations

import torch

from . import _common


def run(lanc_m: int = 30, cycles: int = 4, target_residual: float = 1e-3,
        L: int = 32, device=None, dtype=torch.float32, seed: int = 0,
        emit=_common.quiet) -> dict:
    """`L` is 32 as published (--L); a smaller L runs the script small.
    Returns {"E0", "E0_per_site", "residual", "cycles", "n_basis"}."""
    _, E0, _, info, lay = _common.kron_ground_state(
        L, lanc_m, cycles, target_residual, device, dtype, seed, emit)
    return {"E0": E0, "E0_per_site": E0 / L, "residual": info["residual"],
            "cycles": info.get("cycles"), "n_basis": lay.n_basis}


def main(argv=None) -> dict:
    ap = _common.parser(__doc__, "l32_groundstate")
    ap.add_argument("lanc_m", type=int, nargs="?", default=30)
    ap.add_argument("cycles", type=int, nargs="?", default=4)
    ap.add_argument("target", type=float, nargs="?", default=1e-3)
    ap.add_argument("--L", type=int, default=32,
                    help="chain length (default 32, as published)")
    args = ap.parse_args(argv)
    device, dtype = _common.resolve(ap, args, kron=True)
    return run(args.lanc_m, args.cycles, args.target, L=args.L,
               device=device, dtype=dtype, seed=args.seed, emit=_common.emit)


if __name__ == "__main__":
    main()
