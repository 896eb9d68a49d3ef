"""Build a kernel source of `spindynamics_tpu_torch/csrc/` into a shared
library with a plain C interface, for ctypes.

nvcc compiles for sm_90a into `build/spindynamics_tpu_torch/` of the
checkout (listed in .gitignore), once per content hash of the source and the
headers it includes, on first use. Nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "build_shared_library"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
              / "spindynamics_tpu_torch")


def build_shared_library(src: Path, headers=(), what: str = "kernel"
                         ) -> dict:
    """Compile `src` unless a library of the same content hash (source and
    `headers`) exists. Returns {"path", "seconds" (0 when it was already
    built), "log" (nvcc's -Xptxas -v report: registers, shared memory,
    spills)}. Raises if nvcc is missing or fails."""
    h = hashlib.sha256()
    for p in (src, *headers):
        h.update(p.read_bytes())
    so = _BUILD_DIR / f"{src.stem}_{h.hexdigest()[:16]}.so"
    info = {"path": str(so), "seconds": 0.0, "log": ""}
    if so.exists():
        return info
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError(f"nvcc not found: {what} is compiled on the "
                           "machine that runs it")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{time.monotonic_ns()}.so")
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    info["seconds"] = time.perf_counter() - t0
    info["log"] = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what} ({res.returncode}):\n"
                           f"{info['log']}")
    tmp.replace(so)
    return info
