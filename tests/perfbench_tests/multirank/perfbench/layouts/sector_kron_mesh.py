"""The sector_kron layout over a ProcessMesh: each rank holds one block of
every group's rows on its own device, and the port's block-distributed
apply (K1 with its crossw windows on cards, its plain version on the CPU)
runs the ground state, as `torchrun --nproc-per-node C -m
spindynamics_tpu_torch.cli groundstate ... --mesh C` runs it:
`groundstate_kron(model, mesh=ProcessMesh())`. The harness builds a System
on every rank and makes every call on every rank (perfbench/ranks.py);
`to_host` gathers a state's blocks on rank 0's host over a gloo group of
its own (a first NCCL `gather` of the blocks, on 4 H100s at L=32, hung in
the set-up of a new communicator on ranks 1-3)."""

from __future__ import annotations

import torch
import torch.distributed

from .sector_kron import build_kernels, reference_state  # noqa: F401


class System:
    def __init__(self, cfg: dict, device):
        import spindynamics_tpu_torch as pt
        from spindynamics_tpu_torch.ops.sector_kron import (
            make_sector_kron_layout)
        from spindynamics_tpu_torch.parallel.sharded_kron_scaling import (
            ShardedKronHamiltonian)

        mo = cfg["model"]
        self.cfg, self.device = cfg, torch.device(device)
        self.dtype = getattr(torch, mo["state_dtype"])
        self.model = pt.xxz_chain(mo["L"], Jxy=mo["Jxy"], Jz=mo["Jz"],
                                  nup=mo["nup"], dtype=self.dtype,
                                  layout="sector_kron")
        self.layout = make_sector_kron_layout(
            self.model, self.model.kron_splits, self.model.kron_pads)
        self.mesh = pt.ProcessMesh()
        self.apply_type = ShardedKronHamiltonian
        self.host_group = torch.distributed.new_group(backend="gloo")

    def setup(self) -> dict:
        """A 4-step ground state on the mesh: every shape the window
        runs."""
        nvcc = build_kernels() if self.device.type == "cuda" else {}
        self.groundstate(torch.Generator(device=self.device).manual_seed(2),
                         lanc_m=4, cycles=1)
        return {"nvcc_s": nvcc, "rank": self.mesh.rank, "ranks": self.mesh.D}

    def groundstate(self, generator, lanc_m=None, cycles=None) -> dict:
        import spindynamics_tpu_torch as pt

        g = self.cfg["groundstate"]
        E0, psi, info, _ = pt.groundstate_kron(
            self.model, lanc_m=lanc_m or g["lanc_m"],
            cycles=cycles or g["cycles"],
            target_residual=None if cycles else g["target_residual"],
            generator=generator, mesh=self.mesh, device=self.device)
        return {"E0": float(E0), "psi": psi, "info": dict(info)}

    def applies(self):
        return None

    def counters(self) -> dict:
        """The mesh's collective counters so far (this rank's)."""
        return dict(self.mesh.counters())

    def to_host(self, psi):
        """Rank 0: the state's leaves [ch, cmp, clp] on the host, each
        gathered from every rank's block; the other ranks: None."""
        import torch.distributed as dist

        out = []
        for leaf, grp in zip(psi.leaves, self.layout.groups):
            host = leaf.to("cpu")
            blocks = ([torch.empty_like(host) for _ in range(self.mesh.D)]
                      if self.mesh.rank == 0 else None)
            dist.gather(host, blocks, dst=0, group=self.host_group)
            if blocks is not None:
                out.append(torch.cat(blocks)[:grp[3]])
        return out if self.mesh.rank == 0 else None

    def probes(self) -> dict:
        return {}

    def close(self) -> None:
        pass
