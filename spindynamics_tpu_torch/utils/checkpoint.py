"""Checkpoint / resume for long runs (port of
spindynamics_tpu/utils/checkpoint.py).

A checkpoint is a directory: `arrays.pt` holds the state and the extra
arrays as tensors (torch.save; read back with torch.load(weights_only=
True)), `meta.json` the solver's metadata with `"_format": "torch"`. The
state is a flat tensor or a BlockVec, whose leaves are saved as a list (a
BlockVec on a mesh saves the rows this process holds; give each process of
a ProcessMesh a directory of its own). Tensors are saved bit for bit, so a
resumed run continues from exactly the saved state. The JAX package writes
orbax trees where orbax is installed; the port writes no orbax format.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from ..solvers.blockvec import BlockVec

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path: str, psi, meta: dict[str, Any] | None = None,
                    extra_arrays: dict[str, Any] | None = None) -> None:
    """Persist a state (a tensor or a BlockVec) plus metadata (e.g. a step
    count, a Lanczos history) and extra arrays (numpy or tensors) to the
    directory `path`. The arrays are written before meta.json, so a
    directory with a meta.json holds a whole checkpoint."""
    os.makedirs(path, exist_ok=True)
    meta = dict(meta or {}, _format="torch")
    if isinstance(psi, BlockVec):
        state = {"leaves": [l.detach() for l in psi.leaves]}
    else:
        state = {"psi": psi.detach()}
    state["extra"] = {k: torch.as_tensor(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v.detach() for k, v in
        (extra_arrays or {}).items()}
    torch.save(state, os.path.join(path, "arrays.pt"))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, device=None, mesh=None):
    """Returns (psi, meta, extra_arrays): psi a tensor or a BlockVec (on
    `mesh` when given) on `device` (default: the device it was saved
    from), the extra arrays as numpy."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("_format") != "torch":
        raise ValueError(f"{path} holds a {meta.get('_format')!r} checkpoint "
                         "of the JAX package, not one of the port")
    state = torch.load(os.path.join(path, "arrays.pt"), map_location=device,
                       weights_only=True)
    extra = {k: v.cpu().numpy() for k, v in state["extra"].items()}
    if "leaves" in state:
        return BlockVec(state["leaves"], mesh), meta, extra
    return state["psi"], meta, extra
