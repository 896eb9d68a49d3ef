"""Matrix-free H|psi> on flat states (port of the flat parts of
spindynamics_tpu/ops/apply.py): full, embedded, compact and sector_blocked
models.

Backends of `apply_H`:

  - 'dense'   : explicit H @ psi with `build_dense_H` (the float64 oracle at
                small L).
  - 'blocked' : ops/blocked.apply_H_blocked, plain torch: the CPU path and
                the float64 path of a full or embedded model.
  - 'fused'   : K3, the hand-written CUDA kernel (ops/fused_matvec.py). It
                is the counterpart of the JAX package's 'pallas' backend,
                which is the TPU's name.
  - 'ell'     : `apply_H_ell`, the gather over the ELL neighbour table of a
                compact model (or a full one built with a table): on a
                CUDA state the hand-written kernel of ops/ell_apply.py
                (csrc/ell_apply.cu), on a CPU state its plain torch
                version. The JAX package computes it with an XLA gather,
                not a Pallas kernel.
  - 'sector_blocked' : ops/sector_blocked.apply_H_sector_blocked, the
                matrix products and row gathers of a sector_blocked model,
                plain torch on every device (XLA code in the JAX package).
  - 'tensor'  : `apply_H_tensor`, a full or embedded model's bonds as
                double flips of a 5-D view, plain torch on every device
                (XLA code in the JAX package).

backend=None routes as the JAX package does: a compact model, and a full
one with a neighbour table, go to 'ell' on any device and in any dtype (the
ell kernel takes float32, complex64, float64 and complex128 states), a
sector_blocked model to 'sector_blocked' likewise. Otherwise a CUDA
float32/complex64 state goes to K3, a CPU state to 'blocked'. One rule
sends a CUDA state elsewhere: below K3's floor (`fused_supported`: L < 6)
it goes to 'blocked'. Nothing else does: a CUDA float64/complex128 state of
a full or embedded model with backend=None raises and names
backend="blocked" (the JAX kernel computes such a state in float32 and
casts back, which the port does not copy), and so does a model with more
bonds than K3's lists hold (`make_fused_plan`).

The functional `apply_H` builds what its backend needs (K3's tables, the
N-sized diagonal, the dense matrix) for that one apply; `FlatHamiltonian`
builds them once and owns them as buffers.

Row-sharded states (`mesh=`, or a model placed on a mesh by
parallel/mesh.shard_model: the JAX package's "same code, sharded inputs")
take the sharded applies of parallel/: a compact model (or a full one with
a neighbour table) the halo-exchange ELL apply
(sharded_apply.sharded_matvec_halo_fn), a full or embedded model the
pairwise-exchange blocked apply (sharded_blocked), for backend None,
'blocked' and 'tensor' alike: the two backends compute the same H, and the
JAX package's SPMD form of each is derived from the same flips. Every
other backend raises with a mesh, so no sharded state on the card falls
back to an unsharded apply.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..model import FLAT_MODES, SpinModel, sector_setup
from ..utils.device import resolve_device
from ..utils.dtypes import real_dtype
from .blocked import apply_H_blocked, make_blocked_plan
from .ell_apply import ELL_CHUNK, ell_apply, ell_apply_plain
from .fused_matvec import (
    FusedCall, fused_matvec_apply, fused_supported, fused_tables,
    make_fused_plan)
from .sector_blocked import (
    apply_H_sector_blocked, make_sector_blocked_layout, sector_blocked_tables)

__all__ = [
    "apply_H",
    "apply_rescaled_H",
    "build_dense_H",
    "apply_H_dense",
    "apply_H_ell",
    "apply_H_tensor",
    "matvec_fn",
    "FlatHamiltonian",
]

_BACKENDS = ("dense", "blocked", "fused", "ell", "sector_blocked", "tensor")
# the backends each mode takes ('dense' takes every flat mode; 'ell' every
# model built with a neighbour table, and a model without one says so)
_MODE_BACKENDS = {
    "full": ("dense", "blocked", "fused", "ell", "tensor"),
    "embedded": ("dense", "blocked", "fused", "ell", "tensor"),
    "compact": ("dense", "ell"),
    "sector_blocked": ("dense", "ell", "sector_blocked"),
}
# FlatHamiltonian's buffer prefixes of K3's tables: float32, complex64 plan
_K3_PREFIX = {False: "k3_", True: "k3c_"}
# ... and of the sector_blocked tables
_SB_PREFIX = "sb_"


def build_dense_H(model: SpinModel) -> np.ndarray:
    """Explicit dense H over the model's basis (host numpy, float64): the
    validation oracle. The column of a flipped state is its position among
    the basis states (its value for a full or embedded model), found by a
    searchsorted in the states sorted once."""
    if model.mode not in FLAT_MODES:
        raise ValueError("build_dense_H needs a full, embedded, compact or "
                         "sector_blocked model")
    states = model.basis_states("cpu").numpy()
    N = states.shape[0]
    order = np.argsort(states, kind="stable")
    H = np.zeros((N, N), dtype=np.float64)
    H[np.arange(N), np.arange(N)] = model.diag("cpu", torch.float64).numpy()
    hop_J = np.asarray(model.hop_J, dtype=np.float64)
    for b in range(model.n_bonds):
        i, j = int(model.hop_i[b]), int(model.hop_j[b])
        differ = (((states >> i) ^ (states >> j)) & 1).astype(bool)
        cols = order[np.searchsorted(
            states[order], states[differ] ^ ((1 << i) | (1 << j)))]
        H[np.arange(N)[differ], cols] += hop_J[b]
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
    bond), on psi's device, in psi's dtype: the ell kernel on a CUDA state
    (one launch, one read of the table), its plain version on a CPU state
    (ops/ell_apply.py).

    Where the JAX package gathers the whole [N, n_bonds] matrix and
    multiplies by hop_J, the plain version gathers `chunk` rows of the
    table at a time and adds each block times hop_J into its rows (addmv);
    the kernel sums each row in a fixed order. Either sums the bonds in
    another order than the JAX package's, so they agree to rounding.
    `nbr` and `diag` default to the model's (sector_setup on psi's device)
    and the couplings are copied to psi's device, all for this one apply:
    keep a FlatHamiltonian for repeated applies."""
    want_table = nbr is None and model.n_bonds > 0
    if want_table and not model.neighbor_table:
        raise ValueError("model has no ELL neighbour table "
                         "(build_neighbor_table=True)")
    if diag is None or want_table:
        _, diag_m, nbr_m = sector_setup(model, psi.device,
                                        real_dtype(psi.dtype), want_table)
        diag = diag_m if diag is None else diag
        nbr = nbr_m if want_table else nbr
    J = torch.as_tensor(model.hop_J, dtype=real_dtype(psi.dtype),
                        device=psi.device)
    return _ell(psi, nbr, diag, J, chunk)


def _ell(psi, nbr, diag, J, chunk: int = ELL_CHUNK) -> torch.Tensor:
    """The ell apply's route: the kernel on a CUDA state (a table of no
    columns where `nbr` is None, the diagonal and couplings in the state's
    real dtype), the plain version elsewhere."""
    if psi.device.type != "cuda":
        return ell_apply_plain(psi, nbr, diag, J, chunk)
    rdt = real_dtype(psi.dtype)
    if nbr is None:
        nbr = torch.empty((psi.shape[0], 0), dtype=torch.int32,
                          device=psi.device)
    return ell_apply(psi.contiguous(), nbr, diag.to(rdt), J.to(rdt))


def _flat_backend(model: SpinModel, backend: str | None,
                  on_card: bool) -> str:
    """`backend` checked against the model, or the model's default: 'ell'
    for a compact model or one with a neighbour table, 'sector_blocked'
    for a sector_blocked model, else 'fused' on the card (above K3's
    floor) and 'blocked' elsewhere."""
    if backend is None:
        if model.mode == "compact" or model.neighbor_table:
            return "ell"
        if model.mode == "sector_blocked":
            return "sector_blocked"
        return "fused" if on_card and fused_supported(model) else "blocked"
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; the port has "
                         f"{_BACKENDS}")
    if backend not in _MODE_BACKENDS[model.mode]:
        raise ValueError(
            f"backend {backend!r} does not run this model: the {model.mode} "
            f"model takes {' or '.join(map(repr, _MODE_BACKENDS[model.mode]))}")
    return backend


def _resolve_backend(psi: torch.Tensor, model: SpinModel,
                     backend: str | None) -> str:
    if model.mode not in FLAT_MODES:
        raise ValueError(
            f"apply_H runs full, embedded, compact and sector_blocked "
            f"models; mode={model.mode!r} goes through KronHamiltonian")
    resolved = _flat_backend(model, backend, psi.device.type == "cuda")
    if backend is not None or resolved != "fused":
        return resolved
    if psi.dtype not in (torch.float32, torch.complex64):
        raise TypeError(
            f"a CUDA {psi.dtype} state has no default backend: K3 takes "
            "float32 and complex64; pass backend=\"blocked\"")
    return "fused"


def apply_H_tensor(psi: torch.Tensor, model: SpinModel,
                   diag: torch.Tensor | None = None) -> torch.Tensor:
    """Full or embedded H|psi> with no gathers: psi[idx ^ mask] as a double
    flip. For each bond on bits (i < j) psi is viewed as a 5-D tensor
    (hi, 2, mid, 2, lo) with the two length-2 axes at bits j and i; XOR-ing
    both bits of the index is a flip of those two axes, and the
    bits-differ condition broadcasts from a (2, 2) pattern. Plain torch on
    psi's device, in psi's dtype; `diag` defaults to the model's."""
    if model.mode not in ("full", "embedded"):
        raise ValueError("the tensor backend needs a full or embedded model")
    rdtype = real_dtype(psi.dtype)
    if diag is None:
        diag = model.diag(psi.device, rdtype)
    L = model.L
    out = diag.to(rdtype) * psi
    ax = torch.arange(2, device=psi.device)
    mask22 = (ax[:, None, None] != ax[None, None, :]).to(rdtype)[None, ...,
                                                                  None]
    for b, (si, sj) in enumerate(model.hop_sites):
        lo_bit, hi_bit = min(si, sj), max(si, sj)
        t = psi.reshape(1 << (L - 1 - hi_bit), 2, 1 << (hi_bit - lo_bit - 1),
                        2, 1 << lo_bit)
        flipped = torch.flip(t, dims=(1, 3))
        out = out + (float(model.hop_J[b]) * (mask22 * flipped)).reshape(-1)
    return out


def apply_H(psi: torch.Tensor, model: SpinModel, backend: str | None = None,
            exact_J: bool | None = None) -> torch.Tensor:
    """H|psi> for a full, embedded, compact or sector_blocked model;
    dispatches by backend (see the module docstring). Every backend builds
    its tables for this one call: keep a FlatHamiltonian (matvec_fn) for
    repeated applies. A model placed on a mesh (shard_model) applies to
    the rows of this process's shards through the sharded apply.

    `exact_J` is the JAX package's switch of its Pallas kernel's two-pass
    bf16 dots; K3 has no such route (it sums in the state's precision), so
    it has no effect here."""
    if model.mesh is not None:
        return FlatHamiltonian(model, backend, device=psi.device,
                               dtype=real_dtype(psi.dtype))(psi)
    backend = _resolve_backend(psi, model, backend)
    if backend == "ell":
        return apply_H_ell(psi, model)
    if backend == "sector_blocked":
        return apply_H_sector_blocked(
            psi, model.diag(psi.device, real_dtype(psi.dtype)),
            make_sector_blocked_layout(model))
    if backend == "tensor":
        return apply_H_tensor(psi, model)
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
    """H on flat states of one full, embedded, compact or sector_blocked
    model: psi -> H psi.

    Routing is fixed at construction, in the field `backend` ('fused',
    'blocked', 'ell', 'sector_blocked', 'tensor' or 'dense'; None resolves
    by the model, then by `device`: a compact model, or a full one with a
    neighbour table, gives 'ell' on every device, a sector_blocked model
    'sector_blocked'; otherwise the card gives 'fused', or 'blocked' below
    K3's floor of L = 6, and the CPU gives 'blocked'). K3's plan tables,
    the blocked and tensor applies' N-sized diagonal, the ell apply's
    states, diagonal, int32 ELL table (sector_setup: the torch build on
    the card, the host build on the CPU) and couplings (`hop_J`, made once
    here, so that no apply copies them from the host), the sector_blocked
    apply's states, diagonal and tables (buffers `sb_*`) or the dense
    matrix are registered buffers, so `.to(device)` moves them; the
    diagonal, the real tables, the couplings and the dense matrix are
    stored in `dtype` (default the model's). A blocked or tensor module
    applied to a state of another precision rebuilds its diagonal in that
    one; an ell or sector_blocked module casts its diagonal and couplings
    to the state's dtype, as the JAX package does. An 'ell' module
    launches the ell kernel once per apply on a CUDA state of any of its
    four dtypes, and runs its plain version on a CPU state. A 'fused'
    module takes float32 and complex64 CUDA states, with one K3 plan per
    element type (the default tile is 32 KB:
    2^13 float32, 2^12 complex64 amplitudes), its tables buffers `k3_*` and
    `k3c_*`; on a CPU state it runs K3's plain version, as the wrapper
    does.

    With `mesh` (default: the model's, set by shard_model) the module
    applies H to the rows of this process's shards of a padded state
    (module docstring): its `model` is the padded one, `sharded` the
    sharded apply, `mesh` the mesh, and the solvers end their dots in the
    mesh's all-reduce. `device` then defaults to the mesh's."""

    def __init__(self, model: SpinModel, backend: str | None = None,
                 device=None, dtype: torch.dtype | None = None, mesh=None):
        super().__init__()
        if model.mode not in FLAT_MODES:
            raise ValueError("FlatHamiltonian needs a full, embedded, "
                             "compact or sector_blocked model, not "
                             f"mode={model.mode!r}")
        self.mesh = model.mesh if mesh is None else mesh
        self.sharded = None
        device = resolve_device(device, mesh=self.mesh)
        if self.mesh is not None:
            self._init_sharded(model, backend, device, dtype)
            return
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
            rdt = real_dtype(dtype or model.dtype)
            states, diag, nbr = sector_setup(model, device, rdt,
                                             want_table=model.n_bonds > 0)
            self.register_buffer("states", states, persistent=False)
            self.register_buffer("diag", diag, persistent=False)
            self.register_buffer("nbr", nbr, persistent=False)
            self.register_buffer(
                "hop_J", torch.as_tensor(model.hop_J, dtype=rdt,
                                         device=device), persistent=False)
        elif backend == "sector_blocked":
            rdt = real_dtype(dtype or model.dtype)
            self.layout = make_sector_blocked_layout(model)
            states, diag, _ = sector_setup(model, device, rdt)
            self.register_buffer("states", states, persistent=False)
            self.register_buffer("diag", diag, persistent=False)
            for name, t in sector_blocked_tables(self.layout, device,
                                                 rdt).items():
                self.register_buffer(_SB_PREFIX + name, t, persistent=False)
        else:
            self.blocked_plan = (make_blocked_plan(model)
                                 if backend == "blocked" else None)
            self.register_buffer(
                "diag", model.diag(device, real_dtype(dtype or model.dtype)),
                persistent=False)

    def _init_sharded(self, model, backend, device, dtype):
        """The mesh route: the halo ELL apply or the sharded blocked one."""
        from ..parallel.mesh import shard_model
        from ..parallel.sharded_apply import ShardedEllHamiltonian
        from ..parallel.sharded_blocked import ShardedBlockedHamiltonian

        model = shard_model(model, self.mesh)
        ell = model.mode == "compact" or model.neighbor_table
        takes = (("ell",) if ell else ("blocked", "tensor")
                 if model.mode in ("full", "embedded") else ())
        if not takes or backend not in (None,) + takes:
            raise ValueError(
                f"backend {backend!r} of a {model.mode} model has no sharded "
                "form: with a mesh, compact models take 'ell' (the halo "
                "apply), full and embedded ones 'blocked' or 'tensor' (the "
                "sharded blocked apply)")
        backend = backend or takes[0]
        sharded = (ShardedEllHamiltonian(model, self.mesh, halo=True,
                                         device=device, dtype=dtype) if ell
                   else ShardedBlockedHamiltonian(model, self.mesh,
                                                  device=device, dtype=dtype))
        self.model, self.backend, self.sharded = model, backend, sharded
        self.supports_axpy = False
        self.plans = None
        self._calls = {}
        self.register_buffer("_anchor", torch.empty(0, device=device),
                             persistent=False)

    def _apply(self, fn, recurse=True):
        self._calls = {}  # tensors move: rebuild the descriptors
        return super()._apply(fn, recurse)

    @property
    def device(self):
        return self._anchor.device

    def forward(self, psi: torch.Tensor) -> torch.Tensor:
        """One apply, in the span and counter `apply.<backend>` /
        `applies.<backend>` (utils/profiling.py); a sharded one in those of
        its sharded module."""
        if self.sharded is not None:
            return self.sharded(psi)
        from ..utils.profiling import annotate, count

        count("applies." + self.backend)
        with annotate("apply." + self.backend):
            return self._forward(psi)

    def _forward(self, psi: torch.Tensor) -> torch.Tensor:
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
            return _ell(psi, self.nbr, self.diag, self.hop_J)
        if self.backend == "sector_blocked":
            n = len(_SB_PREFIX)
            return apply_H_sector_blocked(
                psi, self.diag, self.layout,
                {name[n:]: b for name, b in self.named_buffers()
                 if name.startswith(_SB_PREFIX)})
        if self.diag.dtype != real_dtype(psi.dtype):
            self.diag = self.model.diag(self.device, real_dtype(psi.dtype))
        if self.backend == "tensor":
            return apply_H_tensor(psi, self.model, self.diag)
        return apply_H_blocked(psi, self.model, self.blocked_plan, self.diag)


def matvec_fn(model: SpinModel, backend: str | None = None, device=None,
              mesh=None) -> FlatHamiltonian:
    """The H apply of a full, embedded, compact or sector_blocked model
    for the solver layer: an nn.Module whose tables are buffers and whose
    backend is a field. `device` defaults to the card (pass device="cpu"
    for a CPU module), or to `mesh`'s. With `mesh` (or a model placed on
    one by shard_model) it is the sharded apply of the model padded to the
    mesh (FlatHamiltonian)."""
    return FlatHamiltonian(model, backend=backend, device=device, mesh=mesh)
