"""The sector_kron layout through the port's kron entry points, as
examples/l32_groundstate.py and example_kron_sqw.py call them: the chain
from `xxz_chain(layout="sector_kron")`, a ground state from
`groundstate_kron` (K1, the dot2 kernel, the restarted two-pass Lanczos)
and S(q, omega) rows from `kpm_sqw_kron` (K1, the KPM recurrence, dot2)
in the spectral window that set-up draws once."""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import bounds, reference
from ..trace import event_ms


def build_kernels() -> dict:
    """Compile (once per source hash, into the checkout's build/) and load
    K1 and dot2, one nvcc each, started together: {kernel: nvcc seconds,
    0 when already built}."""
    from spindynamics_tpu_torch.ops import dot2, kron_group

    with ThreadPoolExecutor(2) as ex:
        futs = {"K1": ex.submit(kron_group.build_kernel),
                "dot2": ex.submit(dot2.build_kernel)}
        return {k: f.result()["seconds"] for k, f in futs.items()}


class System:
    def __init__(self, cfg: dict, device):
        from spindynamics_tpu_torch.ops.kron_group import KronHamiltonian
        from spindynamics_tpu_torch.ops.sector_kron import (
            make_sector_kron_layout)

        self.cfg, self.device = cfg, torch.device(device)
        self.dtype = getattr(torch, cfg["model"]["state_dtype"])
        self.model = self.chain(cfg["model"], self.dtype)
        self.layout = make_sector_kron_layout(
            self.model, self.model.kron_splits, self.model.kron_pads)
        self.apply_type = KronHamiltonian
        self.window = None
        self._k1_per_apply = None

    @staticmethod
    def chain(mo: dict, dtype):
        """The port's model of the configuration's chain (a layout for
        another chain replaces this alone)."""
        import spindynamics_tpu_torch as pt

        return pt.xxz_chain(mo["L"], Jxy=mo["Jxy"], Jz=mo["Jz"],
                            nup=mo["nup"], dtype=dtype, layout="sector_kron")

    # ---- set-up -----------------------------------------------------------

    def _random(self, seed: int):
        from spindynamics_tpu_torch.solvers.blockvec import bv_random

        g = torch.Generator(device=self.device).manual_seed(seed)
        return bv_random(self.layout, g, self.dtype, self.device)

    def setup(self) -> dict:
        """One apply, the KPM window (the entry point's own bounds Lanczos,
        its seed 7), a 4-step ground state and a 4-moment row at the
        cell's L: every shape the window runs."""
        import spindynamics_tpu_torch as pt
        from spindynamics_tpu_torch.ops import kron_group

        nvcc = build_kernels() if self.device.type == "cuda" else {}
        v = self._random(1)
        H = self.apply_type(self.layout, dtype=self.dtype, device=self.device)
        n0 = kron_group.kernel_launch_count()
        H(v)
        self._k1_per_apply = kron_group.kernel_launch_count() - n0
        sq = self.cfg["sqw"]
        omega = self.omega()
        # no E0 yet: the window's lower end is the bounds Lanczos' own
        _, kinfo = pt.kpm_sqw_kron(self.model, [], omega, kpm_m=sq["kpm_m"],
                                   psi0=v, E0=math.inf, info={},
                                   device=self.device)
        self.window = tuple(kinfo["bounds"])
        gs = self.groundstate(torch.Generator(device=self.device)
                              .manual_seed(2), lanc_m=4, cycles=1)
        self.row(gs, 2 * math.pi / self.cfg["model"]["L"], kpm_m=4)
        return {"nvcc_s": nvcc, "k1_launches_per_apply": self._k1_per_apply,
                "window": self.window}

    def omega(self):
        import numpy as np

        lo, hi, n = self.cfg["sqw"]["omega"]
        return np.linspace(lo, hi, n)

    # ---- the units --------------------------------------------------------

    def groundstate(self, generator, lanc_m=None, cycles=None) -> dict:
        import spindynamics_tpu_torch as pt

        g = self.cfg["groundstate"]
        E0, psi, info, _ = pt.groundstate_kron(
            self.model, lanc_m=lanc_m or g["lanc_m"],
            cycles=cycles or g["cycles"],
            target_residual=None if cycles else g["target_residual"],
            generator=generator, device=self.device)
        return {"E0": float(E0), "psi": psi, "info": dict(info)}

    def row(self, gs: dict, q: float, kpm_m=None) -> tuple:
        """(S row on the omega grid above E0, a, b)."""
        import spindynamics_tpu_torch as pt

        sq = self.cfg["sqw"]
        S, kinfo = pt.kpm_sqw_kron(
            self.model, [q], self.omega(), kpm_m=kpm_m or sq["kpm_m"],
            kernel=sq["kernel"], psi0=gs["psi"], E0=gs["E0"],
            info=gs["info"], bounds=self.window, device=self.device)
        return S[0], float(kinfo["a"]), float(kinfo["b"])

    def applies(self) -> float:
        """H applies so far, counted by K1's launches (the program's
        counter) over K1's launches in one apply."""
        from spindynamics_tpu_torch.ops import kron_group

        if not self._k1_per_apply:  # a CPU run: no kernel, no count
            return None
        return kron_group.kernel_launch_count() / self._k1_per_apply

    def close(self) -> None:
        pass

    @staticmethod
    def to_host(psi):
        return [x.detach().to("cpu", copy=True) for x in psi.leaves]

    # ---- the per-layer probes (CUDA events, after the window) -------------

    def probes(self) -> dict:
        from spindynamics_tpu_torch.utils.compensated import dot2_leaves

        v = self._random(3)
        H = self.apply_type(self.layout, dtype=self.dtype, device=self.device)
        w = H(v)
        mo = self.cfg["model"]
        elems = sum(x.numel() for x in v.leaves)
        return {
            "apply_ms": event_ms(lambda: H(v)),
            "apply_bound_ms": bounds.apply_bound_ms(
                mo["n_basis"], len(self.model.hop_sites),
                v.leaves[0].element_size()),
            "dot_ms": event_ms(lambda: dot2_leaves(v.leaves, w.leaves)),
            "dot_bound_ms": bounds.bytes_ms(
                2 * elems * v.leaves[0].element_size())}


def reference_state(H: reference.BlockChain, host) -> tuple:
    """(the host copy of a ground state in the reference's block form, the
    largest |pad slot|)."""
    return H.from_kron(host)
