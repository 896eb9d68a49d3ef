"""Matrix-free H|psi> on flat states (port of the flat parts of
spindynamics_tpu/ops/apply.py): full, embedded and compact models.

Backends of `apply_H`:

  - 'dense'   : explicit H @ psi with `build_dense_H` (the float64 oracle at
                small L).
  - 'blocked' : ops/blocked.apply_H_blocked, plain torch: the CPU path and
                the float64 path of a full or embedded model.
  - 'fused'   : K3, the hand-written CUDA kernel (ops/fused_matvec.py). It
                is the counterpart of the JAX package's 'pallas' backend,
                which is the TPU's name.
  - 'ell'     : `apply_H_ell`, the gather over the ELL neighbour table of a
                compact model (or a full one built with a table), plain
                torch on every device: the JAX package computes it with an
                XLA gather, not a Pallas kernel.

backend=None routes as the JAX package does: a compact model, and a full
one with a neighbour table, go to 'ell' on any device and in any dtype
(float64 on the card included: no kernel is involved). Otherwise a CUDA
float32/complex64 state goes to K3, a CPU state to 'blocked'. One rule
sends a CUDA state elsewhere: below K3's floor (`fused_supported`: L < 6)
it goes to 'blocked'. Nothing else does: a CUDA float64/complex128 state of
a full or embedded model with backend=None raises and names
backend="blocked" (the JAX kernel computes such a state in float32 and
casts back, which the port does not copy), and so does a model with more
bonds than K3's lists hold (`make_fused_plan`). The 'tensor' backend is not
ported (the package's NOT_PORTED says why).

The functional `apply_H` builds what its backend needs (K3's tables, the
N-sized diagonal, the dense matrix) for that one apply; `FlatHamiltonian`
builds them once and owns them as buffers.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..model import SpinModel, sector_setup
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
    "apply_H_ell",
    "matvec_fn",
    "FlatHamiltonian",
]

_BACKENDS = ("dense", "blocked", "fused", "ell")
_FLAT_MODES = ("full", "embedded", "compact")
# rows of the ELL table gathered at once: the [rows, n_bonds] temporary
# stays ~0.1 GB (float32) whatever N, where the JAX package gathers the
# whole [N, n_bonds] matrix (4 GiB in float32 at L=28)
ELL_CHUNK = 1 << 20
# FlatHamiltonian's buffer prefixes of K3's tables: float32, complex64 plan
_K3_PREFIX = {False: "k3_", True: "k3c_"}


def build_dense_H(model: SpinModel) -> np.ndarray:
    """Explicit dense H over the model's basis (host numpy, float64): the
    validation oracle. The column of a flipped state is its searchsorted
    position among the ascending basis states (its value for a full or
    embedded model)."""
    if model.mode not in _FLAT_MODES:
        raise ValueError("build_dense_H needs a full, embedded or compact "
                         "model")
    states = model.basis_states("cpu").numpy()
    N = states.shape[0]
    H = np.zeros((N, N), dtype=np.float64)
    H[np.arange(N), np.arange(N)] = model.diag("cpu", torch.float64).numpy()
    hop_J = np.asarray(model.hop_J, dtype=np.float64)
    for b in range(model.n_bonds):
        i, j = int(model.hop_i[b]), int(model.hop_j[b])
        differ = (((states >> i) ^ (states >> j)) & 1).astype(bool)
        cols = np.searchsorted(states, states ^ ((1 << i) | (1 << j)))
        H[np.arange(N)[differ], cols[differ]] += hop_J[b]
    return H


def apply_H_dense(psi: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """H @ psi with an explicit real matrix."""
    if psi.is_complex():
        return torch.complex(H @ psi.real, H @ psi.imag).to(psi.dtype)
    return H @ psi


def apply_H_ell(psi: torch.Tensor, model: SpinModel,
                nbr: torch.Tensor | None = None,
                diag: torch.Tensor | None = None,
                chunk: int = ELL_CHUNK) -> torch.Tensor:
    """Gather matvec over the ELL neighbour table:
    out[n] = diag[n] psi[n] + sum_b Jxy_b psi[nbr[n, b]] (nbr = -1: no
    bond). Plain torch on psi's device, in psi's dtype.

    Where the JAX package gathers the whole [N, n_bonds] matrix and
    multiplies by hop_J, this gathers ELL_CHUNK rows of the table at a time
    from psi with one zero appended (an index of -1 reads it: indexing
    wraps negative indices) and adds that block times hop_J into the rows
    (addmv). The bonds are summed in another order than the JAX package's,
    so the two agree to rounding. `nbr` and `diag` default to the model's
    (sector_setup on psi's device, built for this one apply: keep a
    FlatHamiltonian for repeated applies)."""
    want_table = nbr is None and model.n_bonds > 0
    if want_table and not model.neighbor_table:
        raise ValueError("model has no ELL neighbour table "
                         "(build_neighbor_table=True)")
    if diag is None or want_table:
        _, diag_m, nbr_m = sector_setup(model, psi.device,
                                        real_dtype(psi.dtype), want_table)
        diag = diag_m if diag is None else diag
        nbr = nbr_m if want_table else nbr
    out = psi * diag.to(real_dtype(psi.dtype))
    if nbr is None or nbr.shape[1] == 0:
        return out
    ext = torch.cat([psi, psi.new_zeros(1)])
    J = torch.as_tensor(model.hop_J, device=psi.device).to(psi.dtype)
    for s0 in range(0, psi.shape[0], chunk):
        rows = out[s0:s0 + chunk]
        rows.addmv_(ext[nbr[s0:s0 + chunk]], J)
    return out


def _flat_backend(model: SpinModel, backend: str | None,
                  on_card: bool) -> str:
    """`backend` checked against the model, or the model's default: 'ell'
    for a compact model or one with a neighbour table, else 'fused' on the
    card (above K3's floor) and 'blocked' elsewhere."""
    if backend is None:
        if model.mode == "compact" or model.neighbor_table:
            return "ell"
        return "fused" if on_card and fused_supported(model) else "blocked"
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port has "
                         f"{_BACKENDS}")
    if model.mode == "compact" and backend in ("blocked", "fused"):
        raise ValueError(f"backend {backend!r} runs full and embedded "
                         "models; a compact model takes 'ell' or 'dense'")
    return backend


def _resolve_backend(psi: torch.Tensor, model: SpinModel,
                     backend: str | None) -> str:
    if model.mode not in _FLAT_MODES:
        raise ValueError(
            f"apply_H runs full, embedded and compact models; "
            f"mode={model.mode!r} goes through KronHamiltonian")
    resolved = _flat_backend(model, backend, psi.device.type == "cuda")
    if backend is not None or resolved != "fused":
        return resolved
    if psi.dtype not in (torch.float32, torch.complex64):
        raise TypeError(
            f"a CUDA {psi.dtype} state has no default backend: K3 takes "
            "float32 and complex64; pass backend=\"blocked\"")
    return "fused"


def apply_H(psi: torch.Tensor, model: SpinModel, backend: str | None = None
            ) -> torch.Tensor:
    """H|psi> for a full, embedded or compact model; dispatches by backend
    (see the module docstring). Every backend builds its tables for this
    one call: keep a FlatHamiltonian (matvec_fn) for repeated applies."""
    backend = _resolve_backend(psi, model, backend)
    if backend == "ell":
        return apply_H_ell(psi, model)
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
    """H on flat states of one full, embedded or compact model: psi -> H psi.

    Routing is fixed at construction, in the field `backend` ('fused',
    'blocked', 'ell' or 'dense'; None resolves by the model, then by
    `device`: a compact model, or a full one with a neighbour table, gives
    'ell' on every device; otherwise the card gives 'fused', or 'blocked'
    below K3's floor of L = 6, and the CPU gives 'blocked'). K3's plan
    tables, the blocked apply's N-sized diagonal, the ell apply's states,
    diagonal and int32 ELL table (sector_setup: the torch build on the
    card, the host build on the CPU) or the dense matrix are registered
    buffers, so `.to(device)` moves them; the diagonal and the dense matrix
    are stored in `dtype` (default the model's). A blocked module applied
    to a state of another precision rebuilds its diagonal in that one; an
    ell module casts its diagonal and couplings to the state's dtype, as
    the JAX package does. A 'fused' module takes float32 and complex64 CUDA
    states, with one K3 plan per element type (the default tile is 32 KB:
    2^13 float32, 2^12 complex64 amplitudes), its tables buffers `k3_*` and
    `k3c_*`; on a CPU state it runs K3's plain version, as the wrapper
    does."""

    def __init__(self, model: SpinModel, backend: str | None = None,
                 device=None, dtype: torch.dtype | None = None):
        super().__init__()
        if model.mode not in _FLAT_MODES:
            raise ValueError("FlatHamiltonian needs a full, embedded or "
                             f"compact model, not mode={model.mode!r}")
        device = resolve_device(device)
        backend = _flat_backend(model, backend, device.type == "cuda")
        if (backend == "ell" and not model.neighbor_table
                and model.n_bonds > 0):
            raise ValueError("model has no ELL neighbour table "
                             "(build_neighbor_table=True)")
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
        elif backend == "ell":
            states, diag, nbr = sector_setup(
                model, device, real_dtype(dtype or model.dtype),
                want_table=model.n_bonds > 0)
            self.register_buffer("states", states, persistent=False)
            self.register_buffer("diag", diag, persistent=False)
            self.register_buffer("nbr", nbr, persistent=False)
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
        if self.backend == "ell":
            return apply_H_ell(psi, self.model, self.nbr, self.diag)
        if self.diag.dtype != real_dtype(psi.dtype):
            self.diag = self.model.diag(self.device, real_dtype(psi.dtype))
        return apply_H_blocked(psi, self.model, self.blocked_plan, self.diag)


def matvec_fn(model: SpinModel, backend: str | None = None, device=None
              ) -> FlatHamiltonian:
    """The H apply of a full, embedded or compact model for the solver
    layer: an nn.Module whose tables are buffers and whose backend is a
    field. `device` defaults to the card (pass device="cpu" for a CPU
    module)."""
    return FlatHamiltonian(model, backend=backend, device=device)
