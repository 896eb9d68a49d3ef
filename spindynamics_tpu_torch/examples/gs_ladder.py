"""float32 residual ladder: Heisenberg-chain ground states at increasing L
on one card (port of scripts/gs_ladder.py).

For each L: XXZ chain Jxy = Jz = 1, Sz=0, sector_kron layout, restarted
two-pass Lanczos + Chebyshev-filter polish to the target residual
(groundstate_kron, K1 on the card). One JSON line per L as it completes.
The JAX script's environment settings LANC_M, CYCLES and TARGET are the
flags --lanc-m, --cycles and --target here.

    python -m spindynamics_tpu_torch.examples.gs_ladder [L ...]   # 16 24 28
"""

from __future__ import annotations

import torch

from . import _common


def run(Ls=(16, 24, 28), lanc_m: int = 40, cycles: int = 8,
        target_residual: float = 1e-3, device=None, dtype=torch.float32,
        seed: int = 0, emit=_common.quiet) -> dict:
    """Returns {L: {"E0", "E0_per_site", "residual", "cycles"}}."""
    out = {}
    for L in Ls:
        _, E0, _, info, _ = _common.kron_ground_state(
            L, lanc_m, cycles, target_residual, device, dtype, seed, emit)
        out[L] = {"E0": E0, "E0_per_site": E0 / L,
                  "residual": info["residual"], "cycles": info.get("cycles")}
    return out


def main(argv=None) -> dict:
    ap = _common.parser(__doc__, "gs_ladder")
    ap.add_argument("L", type=int, nargs="*", default=[16, 24, 28])
    ap.add_argument("--lanc-m", type=int, default=40, dest="lanc_m")
    ap.add_argument("--cycles", type=int, default=8)
    ap.add_argument("--target", type=float, default=1e-3)
    args = ap.parse_args(argv)
    device, dtype = _common.resolve(ap, args, kron=True)
    return run(args.L, args.lanc_m, args.cycles, args.target, device=device,
               dtype=dtype, seed=args.seed, emit=_common.emit)


if __name__ == "__main__":
    main()
