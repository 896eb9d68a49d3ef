"""Large-L ground states via the sector_kron layout (port of
examples/example_large_L.py).

Open Heisenberg chain (Jxy = Jz = 1), Sz=0, restarted two-pass Lanczos +
Chebyshev-filter polish on BlockVec states, every H apply through K1 on
the card.

    python -m spindynamics_tpu_torch.examples.example_large_L        # L=24
    python -m spindynamics_tpu_torch.examples.example_large_L 28
    python -m spindynamics_tpu_torch.examples.example_large_L 32
"""

from __future__ import annotations

import torch

from . import _common


def run(L: int = 24, lanc_m: int = 30, cycles: int = 4,
        target_residual: float = 1e-3, device=None, dtype=torch.float32,
        seed: int = 0, emit=_common.quiet) -> dict:
    """Returns {"E0", "E0_per_site", "residual", "cycles", "n_basis"}."""
    _, E0, _, info, lay = _common.kron_ground_state(
        L, lanc_m, cycles, target_residual, device, dtype, seed, emit)
    return {"E0": E0, "E0_per_site": E0 / L, "residual": info["residual"],
            "cycles": info.get("cycles"), "n_basis": lay.n_basis}


def main(argv=None) -> dict:
    ap = _common.parser(__doc__, "example_large_L")
    ap.add_argument("L", type=int, nargs="?", default=24)
    args = ap.parse_args(argv)
    device, dtype = _common.resolve(ap, args, kron=True)
    return run(args.L, device=device, dtype=dtype, seed=args.seed,
               emit=_common.emit)


if __name__ == "__main__":
    main()
