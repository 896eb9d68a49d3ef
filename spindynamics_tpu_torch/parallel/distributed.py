"""Multi-process runtime glue (port of
spindynamics_tpu/parallel/distributed.py): torch.distributed init with
env-var autodetection, the mesh of the running topology, and which shards
this process owns.

One process per card: scaling past one card means N processes coordinated
by torch.distributed (NCCL between cards, gloo between CPU processes),
each holding one shard (`ProcessMesh`). A single process holds all D shards
of a `LocalMesh` on its one device.

- `initialize_distributed()` wraps init_process_group; a no-op when
  single-process or already initialized, so library code can call it
  unconditionally.
- `mesh_from_topology()` returns the ProcessMesh of the world when
  multi-process, else a LocalMesh. Ranks are host-major by construction
  (a launcher numbers the processes of host 0 first), so neighbouring
  shards sit on the same host and the hi-axis window exchanges between
  adjacent shards stay inside it.
- `local_shard_info(mesh)` reports the shards this process owns: the unit
  of per-host checkpoint IO.
"""

from __future__ import annotations

import os

import torch

from .mesh import LocalMesh, ProcessMesh

__all__ = ["initialize_distributed", "is_multiprocess", "mesh_from_topology",
           "local_shard_info"]


def _dist():
    import torch.distributed as dist

    return dist


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None,
                           timeout_s: float | None = None) -> bool:
    """Initialize torch.distributed when running multi-process; a no-op
    otherwise. Autodetects from the standard env vars (MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE, RANK) unless the arguments say otherwise;
    `backend` defaults to nccl with CUDA, else gloo. Returns True when a
    process group is (already) up. Safe to call repeatedly."""
    dist = _dist()
    if not dist.is_available():
        return False
    if dist.is_initialized():
        return True
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "0") or 0)
    if rank is None:
        rank = int(os.environ.get("RANK", "-1") or -1)
    if not init_method or world_size <= 1 or rank < 0:
        return False  # single-process: nothing to do
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if timeout_s is not None:
        import datetime

        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    return True


def is_multiprocess() -> bool:
    dist = _dist()
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def mesh_from_topology(n_devices: int | None = None, device=None):
    """The mesh of the running topology: the world's ProcessMesh when
    multi-process (one shard per rank, rank order host-major; `n_devices`
    must then be the world size or None), else a LocalMesh of `n_devices`
    shards (default 1) on `device`."""
    if is_multiprocess():
        mesh = ProcessMesh()
        if n_devices is not None and n_devices != mesh.D:
            raise ValueError(f"n_devices={n_devices}, but the process group "
                             f"has {mesh.D} ranks")
        return mesh
    return LocalMesh(1 if n_devices is None else n_devices, device)


def local_shard_info(mesh) -> dict:
    """Which shards of the row axis this process owns (for per-host IO)."""
    multi = is_multiprocess()
    dist = _dist()
    return {
        "n_shards": mesh.D,
        "local_shard_ids": list(mesh.local_shards),
        "process_index": dist.get_rank() if multi else 0,
        "process_count": dist.get_world_size() if multi else 1,
    }
