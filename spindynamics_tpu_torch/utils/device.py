"""The port's one rule for where an entry point runs.

`device=None` means the card. A state the caller passes in decides the
device when `device` is None, then the device of a `mesh=` argument that
names one; with none of them the entry point runs on
`torch.device("cuda")`, and raises when there is none: a CPU run is always
asked for (`device="cpu"`, a CPU state or a CPU mesh), never fallen into.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def _device_of(like):
    """Device of a tensor, a BlockVec, or a (re, im) pair of either."""
    if like is None:
        return None
    if isinstance(like, (tuple, list)):
        return _device_of(like[0]) if like else None
    return getattr(like, "device", None)


def resolve_device(device=None, like=None, mesh=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    device of `like` (a state the caller passed), else that of `mesh` (a
    LocalMesh made with one), else the card. Raises RuntimeError when the
    card is wanted and CUDA is not available."""
    if device is not None:
        return torch.device(device)
    dev = _device_of(like)
    if dev is None:
        dev = getattr(mesh, "device", None)
    if dev is not None:
        return torch.device(dev)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card by "
            "default; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
