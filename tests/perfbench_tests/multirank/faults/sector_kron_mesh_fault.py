"""The mesh layout with a fault planted on one rank, for the drills of a
multi-rank run: the configuration's `fault` = {"rank": r, "at": "setup" |
"groundstate", "after": n, "how": "raise" | "kill"} raises, or kills the
rank's process, in set-up or in ground state n + 1 (set-up runs one)."""

import os
import signal

import torch.distributed as dist

from .sector_kron_mesh import System as _Mesh
from .sector_kron_mesh import build_kernels, reference_state  # noqa: F401


class System(_Mesh):
    calls = 0

    def _strike(self, at: str) -> None:
        f = self.cfg["fault"]
        if f["at"] != at or dist.get_rank() != f["rank"]:
            return
        if at == "groundstate" and self.calls <= f.get("after", 0):
            return
        if f["how"] == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        raise RuntimeError(f"a fault planted on rank {f['rank']} ({at})")

    def setup(self) -> dict:
        self._strike("setup")
        return super().setup()

    def groundstate(self, generator, **kw) -> dict:
        self.calls += 1
        self._strike("groundstate")
        return super().groundstate(generator, **kw)
