"""Matrix-free H|psi> on flat states (port of the full/embedded parts of
spindynamics_tpu/ops/apply.py).

Backends of `apply_H` for a full or embedded model:

  - 'dense'   : explicit H @ psi with `build_dense_H` (the float64 oracle at
                small L).
  - 'blocked' : ops/blocked.apply_H_blocked, plain torch: the CPU path and
                the float64 path.
  - 'fused'   : K3, the hand-written CUDA kernel (ops/fused_matvec.py). It
                is the counterpart of the JAX package's 'pallas' backend,
                which is the TPU's name.

backend=None routes as the JAX package does: a CUDA float32/complex64 state
goes to K3, a CPU state to 'blocked'. One rule sends a CUDA state elsewhere:
below K3's floor (`fused_supported`: L < 6) it goes to 'blocked'. Nothing
else does: a CUDA float64/complex128 state with backend=None raises and
names backend="blocked" (the JAX kernel computes such a state in float32 and
casts back, which the port does not copy), and so does a model with more
bonds than K3's lists hold (`make_fused_plan`). The 'ell' and 'tensor'
backends wait (ROADMAP Queue 1, items 11 and 14).

The functional `apply_H` builds what its backend needs (K3's tables, the
N-sized diagonal, the dense matrix) for that one apply; `FlatHamiltonian`
builds them once and owns them as buffers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..model import SpinModel
from ..utils.device import resolve_device
from ..utils.dtypes import real_dtype
from .blocked import apply_H_blocked, make_blocked_plan
from .fused_matvec import (
    FusedCall, fused_matvec_apply, fused_supported, fused_tables,
    make_fused_plan)

__all__ = [
    "apply_H",
    "apply_rescaled_H",
    "build_dense_H",
    "apply_H_dense",
    "matvec_fn",
    "FlatHamiltonian",
]

_BACKENDS = ("dense", "blocked", "fused")
# FlatHamiltonian's buffer prefixes of K3's tables: float32, complex64 plan
_K3_PREFIX = {False: "k3_", True: "k3c_"}


def build_dense_H(model: SpinModel) -> np.ndarray:
    """Explicit dense H over the model's 2^L basis (host numpy, float64):
    the validation oracle."""
    if model.mode not in ("full", "embedded"):
        raise ValueError("build_dense_H needs a full or embedded model")
    N = model.n_states
    states = np.arange(N, dtype=np.int64)
    H = np.zeros((N, N), dtype=np.float64)
    H[states, states] = model.diag("cpu", torch.float64).numpy()
    hop_J = np.asarray(model.hop_J, dtype=np.float64)
    for b in range(model.n_bonds):
        i, j = int(model.hop_i[b]), int(model.hop_j[b])
        differ = (((states >> i) ^ (states >> j)) & 1).astype(bool)
        rows = states[differ]
        H[rows, rows ^ ((1 << i) | (1 << j))] += hop_J[b]
    return H


def apply_H_dense(psi: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """H @ psi with an explicit real matrix."""
    if psi.is_complex():
        return torch.complex(H @ psi.real, H @ psi.imag).to(psi.dtype)
    return H @ psi


def _resolve_backend(psi: torch.Tensor, model: SpinModel,
                     backend: str | None) -> str:
    if model.mode not in ("full", "embedded"):
        raise ValueError(
            f"apply_H runs full and embedded models; mode={model.mode!r} "
            "goes through KronHamiltonian")
    if backend is not None:
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; the port has "
                             f"{_BACKENDS}")
        return backend
    if psi.device.type != "cuda" or not fused_supported(model):
        return "blocked"
    if psi.dtype not in (torch.float32, torch.complex64):
        raise TypeError(
            f"a CUDA {psi.dtype} state has no default backend: K3 takes "
            "float32 and complex64; pass backend=\"blocked\"")
    return "fused"


def apply_H(psi: torch.Tensor, model: SpinModel, backend: str | None = None
            ) -> torch.Tensor:
    """H|psi> for a full or embedded model; dispatches by backend (see the
    module docstring). Every backend builds its tables for this one call:
    keep a FlatHamiltonian (matvec_fn) for repeated applies."""
    backend = _resolve_backend(psi, model, backend)
    if backend == "blocked":
        return apply_H_blocked(psi, model)
    if backend == "fused":
        return fused_matvec_apply(psi, model)
    H = torch.as_tensor(build_dense_H(model), dtype=real_dtype(psi.dtype),
                        device=psi.device)
    return apply_H_dense(psi, H)


def apply_rescaled_H(psi: torch.Tensor, model: SpinModel, a, b,
                     backend: str | None = None) -> torch.Tensor:
    """(H psi - b psi) / a for Chebyshev methods."""
    hpsi = apply_H(psi, model, backend=backend)
    return (hpsi - psi * b) * (1.0 / a)


class FlatHamiltonian(nn.Module):
    """H on flat states of one full or embedded model: psi -> H psi.

    Routing is fixed at construction, in the field `backend` ('fused',
    'blocked' or 'dense'; None resolves by `device`: the card gives
    'fused', or 'blocked' below K3's floor of L = 6; the CPU gives
    'blocked'). K3's plan tables, the blocked apply's N-sized diagonal or
    the dense matrix are registered buffers, so `.to(device)` moves them;
    the last two are stored in `dtype` (default the model's), and a blocked
    module applied to a state of another precision rebuilds its diagonal
    in that one. A 'fused' module takes float32 and complex64 CUDA states,
    with one K3 plan per element type (the default tile is 32 KB: 2^13
    float32, 2^12 complex64 amplitudes), its tables buffers `k3_*` and
    `k3c_*`; on a CPU state it runs K3's plain version, as the wrapper
    does."""

    def __init__(self, model: SpinModel, backend: str | None = None,
                 device=None, dtype: torch.dtype | None = None):
        super().__init__()
        if model.mode not in ("full", "embedded"):
            raise ValueError("FlatHamiltonian needs a full or embedded "
                             f"model, not mode={model.mode!r}")
        device = resolve_device(device)
        if backend is None:
            backend = ("fused" if device.type == "cuda"
                       and fused_supported(model) else "blocked")
        if backend not in _BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; the port has "
                             f"{_BACKENDS}")
        self.model = model
        self.backend = backend
        self.supports_axpy = False
        self.plans = None
        self._calls = {}
        self.register_buffer("_anchor", torch.empty(0, device=device),
                             persistent=False)
        if backend == "fused":
            self.plans = {c: make_fused_plan(model, is_complex=c)
                          for c in (False, True)}
            for c, plan in self.plans.items():
                for name, t in fused_tables(plan, device).items():
                    self.register_buffer(_K3_PREFIX[c] + name, t,
                                         persistent=False)
        elif backend == "dense":
            self.register_buffer(
                "H", torch.as_tensor(build_dense_H(model),
                                     dtype=dtype or model.dtype,
                                     device=device), persistent=False)
        else:
            self.blocked_plan = make_blocked_plan(model)
            self.register_buffer(
                "diag", model.diag(device, real_dtype(dtype or model.dtype)),
                persistent=False)

    def _apply(self, fn, recurse=True):
        self._calls = {}  # tensors move: rebuild the descriptors
        return super()._apply(fn, recurse)

    @property
    def device(self):
        return self._anchor.device

    def forward(self, psi: torch.Tensor) -> torch.Tensor:
        if self.backend == "fused":
            c = psi.is_complex()
            call = self._calls.get(c)
            if psi.device.type == "cuda" and call is None:
                pre = _K3_PREFIX[c]
                call = self._calls[c] = FusedCall(self.plans[c], {
                    n[len(pre):]: b for n, b in self.named_buffers()
                    if n.startswith(pre)})
            return fused_matvec_apply(psi, self.model, call)
        if self.backend == "dense":
            return apply_H_dense(psi, self.H.to(real_dtype(psi.dtype)))
        if self.diag.dtype != real_dtype(psi.dtype):
            self.diag = self.model.diag(self.device, real_dtype(psi.dtype))
        return apply_H_blocked(psi, self.model, self.blocked_plan, self.diag)


def matvec_fn(model: SpinModel, backend: str | None = None, device=None
              ) -> FlatHamiltonian:
    """The H apply of a full or embedded model for the solver layer: an
    nn.Module whose plan tables are buffers and whose backend is a field.
    `device` defaults to the card (pass device="cpu" for a CPU module)."""
    return FlatHamiltonian(model, backend=backend, device=device)
