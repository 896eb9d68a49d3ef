"""The compact layout (the sector in ascending order, the JAX package's
default) through the port's flat entry points, as its tests and the chip
smoke's compact phase call them: the chain from
`heisenberg_chain(layout="compact")` or `xxz_chain`, its apply from
`matvec_fn` (the `ell` gather over the neighbour table, plain torch), a
ground state from `lanczos_groundstate_restarted` (the dot2 kernel in the
compensated dots) and S(q, omega) rows from `kpm_sqw(matvec=...)` in the
window that set-up draws once (`estimate_energy_bounds`, as kpm_sqw's own
default draws it)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import bounds, reference
from ..trace import event_ms


class System:
    def __init__(self, cfg: dict, device):
        import spindynamics_tpu_torch as pt
        from spindynamics_tpu_torch.ops.apply import FlatHamiltonian

        mo = cfg["model"]
        self.cfg, self.device = cfg, torch.device(device)
        self.dtype = getattr(torch, mo["state_dtype"])
        self.model = pt.xxz_chain(mo["L"], Jxy=mo["Jxy"], Jz=mo["Jz"],
                                  nup=mo["nup"], dtype=self.dtype,
                                  layout="compact")
        self.N = self.model.n_states
        self.apply_type = FlatHamiltonian
        self.mv = None
        self.a = self.b = None
        self._calls = 0
        self._hook = None

    def _count(self, mod, args, out) -> None:
        if type(mod) is self.apply_type:
            self._calls += 1

    def setup(self) -> dict:
        """The neighbour table and the apply module, the dot2 kernel, one
        real and one complex apply, the KPM window, a 4-step ground state
        and a 4-moment row at the cell's L."""
        import spindynamics_tpu_torch as pt

        nvcc = {}
        if self.device.type == "cuda":
            from spindynamics_tpu_torch.ops import dot2

            nvcc["dot2"] = dot2.build_kernel()["seconds"]
        self.mv = pt.matvec_fn(self.model, device=self.device)
        # the program's applies: a forward hook on every module of its type
        self._hook = torch.nn.modules.module.register_module_forward_hook(
            self._count)
        x = self._random(1)
        self.mv(x)
        self.mv(x.to(torch.complex64 if self.dtype == torch.float32
                     else torch.complex128))
        lo, hi = pt.estimate_energy_bounds(
            self.mv, self.N, lanc_m=80,
            generator=torch.Generator(device=self.device).manual_seed(7),
            mask=self.model.valid_mask(self.device), device=self.device)
        self.a, self.b = pt.rescaling_params(lo, hi, safety=1.0)
        gs = self.groundstate(torch.Generator(device=self.device)
                              .manual_seed(2), lanc_m=4, cycles=1)
        self.row(gs, 2 * math.pi / self.cfg["model"]["L"], kpm_m=4)
        return {"nvcc_s": nvcc, "window": (self.b - self.a, self.b + self.a)}

    def _random(self, seed: int) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn(self.N, generator=g, device=self.device,
                           dtype=self.dtype)

    def omega(self):
        lo, hi, n = self.cfg["sqw"]["omega"]
        return np.linspace(lo, hi, n)

    # ---- the units --------------------------------------------------------

    def groundstate(self, generator, lanc_m=None, cycles=None) -> dict:
        import spindynamics_tpu_torch as pt

        g = self.cfg["groundstate"]
        E0, psi, info = pt.lanczos_groundstate_restarted(
            self.mv, N=self.N, lanc_m=lanc_m or g["lanc_m"],
            cycles=cycles or g["cycles"],
            target_residual=None if cycles else g["target_residual"],
            dtype=self.dtype, generator=generator, device=self.device)
        return {"E0": float(E0), "psi": psi, "info": dict(info)}

    def row(self, gs: dict, q: float, kpm_m=None) -> tuple:
        """(S row on the omega grid above E0, a, b)."""
        import spindynamics_tpu_torch as pt

        sq = self.cfg["sqw"]
        S = pt.kpm_sqw(gs["psi"], self.model, [q], self.omega(), a=self.a,
                       b=self.b, kpm_m=kpm_m or sq["kpm_m"],
                       kernel=sq["kernel"], E0=gs["E0"], matvec=self.mv)
        return S[0].cpu().numpy(), self.a, self.b

    def applies(self) -> float:
        """Forward calls of the program's apply module so far."""
        return float(self._calls)

    @staticmethod
    def to_host(psi):
        return psi.detach().to("cpu", copy=True)

    # ---- the per-layer probes (CUDA events, after the window) -------------

    def probes(self) -> dict:
        from spindynamics_tpu_torch.utils.compensated import dot2

        x = self._random(3)
        y = self.mv(x)
        item = x.element_size()
        table = self.mv.nbr.numel() * self.mv.nbr.element_size()
        # the table read once, the state and the diagonal read, the result
        # written (the chip smoke's count)
        return {"apply_ms": event_ms(lambda: self.mv(x)),
                "apply_bound_ms": bounds.bytes_ms(table + self.N * (2 * item
                                                                    + 4)),
                "dot_ms": event_ms(lambda: dot2(x, y)),
                "dot_bound_ms": bounds.bytes_ms(2 * self.N * item)}

    def close(self) -> None:
        if self._hook is not None:
            self._hook.remove()
            self._hook = None


def reference_state(H: reference.BlockChain, host) -> tuple:
    """(the host copy of a ground state in the reference's block form, the
    largest |pad slot|)."""
    return H.from_flat(host), 0.0
