"""Spin model specification (port of spindynamics_tpu/model.py).

The model is a frozen dataclass of host numpy couplings plus layout
metadata. Five layouts are ported: `sector_kron` (the lean build: the kron
apply uses the layout's factored diagonal), `compact` (the U(1) sector in
ascending order, the JAX package's `sector` mode, applied through the ELL
neighbour table), `sector_blocked` (the U(1) sector in (k_hi, rank_hi,
rank_lo) order, the JAX package's `sector` mode with `lo_bits`, applied
by ops/sector_blocked.py), `embedded` (one U(1) sector run inside the full
2^L space) and `full`. None of them stores an N-sized array: the basis
states, the diagonal and the ELL table are built on demand on the device
that asks (`basis_states(device)`, `diag(device)`, `sector_setup`), and the
module that applies H holds what it needs (ops/apply.FlatHamiltonian). A
flat model padded for row sharding (parallel/sharded_apply.pad_model, the
JAX package's) keeps its logical size in `n_valid`: its pad rows have
state 0, diagonal 0 and no neighbour (-1), so they stay exactly zero; a
model placed on a mesh (parallel/mesh.shard_model) names it in `mesh`. A
compact or sector_blocked build follows the JAX package's choice: on the
card a torch build (compact: L unrank passes, then one combinadic-rank pass
per bond; sector_blocked: the per-group outer products of the hi and lo
enumerations), on the CPU the host numpy build; the two give the same
states, table and diagonal, bit for bit. Site indices are 0-based.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from . import basis as basis_mod

__all__ = ["SpinModel", "build_model", "nn_hopping", "long_range_hopping",
           "sector_setup"]

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}
# the modes whose states are flat vectors, and those of them whose rows
# stand for sector states other than their indices
FLAT_MODES = ("full", "embedded", "compact", "sector_blocked")
SECTOR_MODES = ("compact", "sector_blocked")
_TORCH_DTYPES = {np.dtype(v): k for k, v in _NP_DTYPES.items()}


@dataclasses.dataclass(frozen=True, eq=False)
class SpinModel:
    """XXZ-type spin-1/2 model on a bit-encoded basis.

    H = sum_b Jxy_b (S+_i S-_j + S-_i S+_j) + sum_i h_i Sz_i + sum_z Jz Sz_i Sz_j

    The off-diagonal matrix element between states that differ on bits (i, j)
    is Jxy_b itself (no extra 1/2), as in the JAX package."""

    L: int
    nup: int | None
    field: np.ndarray   # [L]
    hop_i: np.ndarray   # int32 [nb]
    hop_j: np.ndarray   # int32 [nb]
    hop_J: np.ndarray   # [nb]
    zz_i: np.ndarray    # int32 [nz]
    zz_j: np.ndarray    # int32 [nz]
    zz_J: np.ndarray    # [nz]
    hop_sites: tuple
    zz_sites: tuple
    kron_splits: tuple | None
    kron_pads: tuple | None
    n_states_static: int        # padded kron length, C(L, nup), or 2^L
    n_valid: int | None = None  # C(L, nup) when tile padding exists
    # 'sector_kron' | 'compact' | 'sector_blocked' | 'embedded' | 'full'
    mode: str = "sector_kron"
    # the ELL neighbour table (build_neighbor_table): a compact model, or a
    # full one, with it is applied by the 'ell' backend
    neighbor_table: bool = False
    # the lo part's bit count Ll of a sector_blocked model
    lo_bits: int | None = None
    # the LocalMesh or ProcessMesh a flat model's rows are sharded over
    # (parallel/mesh.shard_model): its applies, dots and observables
    # then run on the mesh's row shards
    mesh: object = dataclasses.field(default=None, repr=False)

    @property
    def n_states(self) -> int:
        return self.n_states_static

    @property
    def n_bonds(self) -> int:
        return self.hop_i.shape[0]

    def _flat_only(self, what):
        if self.mode not in FLAT_MODES:
            raise ValueError(f"{what} needs a full, embedded, compact or "
                             f"sector_blocked model, not mode={self.mode!r}")

    @property
    def padded(self) -> bool:
        """True for a flat model padded to a multiple of a shard count:
        rows n_valid..n_states-1 are pad rows."""
        return self.mode in FLAT_MODES and self.n_valid is not None

    def logical(self) -> "SpinModel":
        """The model without its sharding pad rows and mesh."""
        if not self.padded and self.mesh is None:
            return self
        return dataclasses.replace(self, n_states_static=self.dim,
                                   n_valid=None, mesh=None)

    def _pad_rows(self, x: torch.Tensor, value=0) -> torch.Tensor:
        """x [dim, ...] extended by the pad rows, filled with `value`."""
        pad = x.new_full((self.n_states - x.shape[0],) + tuple(x.shape[1:]),
                         value)
        return torch.cat([x, pad])

    @property
    def stores_states(self) -> bool:
        """True where the rows stand for basis states other than their
        indices (compact, sector_blocked)."""
        return self.mode in SECTOR_MODES

    def basis_states(self, device="cpu") -> torch.Tensor:
        """The basis states, int64, made on demand (never stored):
        arange(2^L) for a full or embedded model; for a compact model the
        ascending sector, unranked on the card or enumerated on the host;
        for a sector_blocked model the blocked order (sector_setup). Pad
        rows of a padded model hold state 0."""
        self._flat_only("basis_states")
        if self.padded:
            return self._pad_rows(self.logical().basis_states(device))
        if self.mode == "compact":
            return _sector_states(self.L, self.nup, torch.device(device))
        if self.mode == "sector_blocked":
            return sector_setup(self, device, want_table=False)[0]
        return torch.arange(self.n_states, dtype=torch.int64, device=device)

    def valid_mask(self, device="cpu"):
        """Boolean [n_states] mask of logical rows: popcount(index) == nup
        for 'embedded' (the U(1) sector is an exact invariant subspace of H,
        so zeroing the complement once at state preparation keeps a whole
        computation in the sector); None for 'full', 'compact' and
        'sector_blocked', where every row is logical. A padded model's
        mask also excludes its pad rows (index >= n_valid), as in the JAX
        package; it covers every row of the padded model, whichever
        process holds them."""
        self._flat_only("valid_mask")
        if self.padded:
            m = self.logical().valid_mask(device)
            if m is None:
                m = torch.ones(self.dim, dtype=torch.bool, device=device)
            return self._pad_rows(m, False)
        if self.mode != "embedded":
            return None
        s = self.basis_states(device)
        cnt = torch.zeros_like(s)
        for i in range(self.L):
            cnt += (s >> i) & 1
        return cnt == self.nup

    def diag(self, device="cpu", dtype: torch.dtype | None = None
             ) -> torch.Tensor:
        """The diagonal of H, sum_i h_i sz_i + sum_z Jz sz_i sz_j, as an
        [n_states] tensor built on `device` at every call: the model stores
        no N-sized array, whoever needs the diagonal more than once holds it
        (a blocked, ell or sector_blocked FlatHamiltonian keeps it as a
        buffer). The plain blocked apply, the ell and sector_blocked applies
        and the dense oracle read it, K3 does not. A compact or
        sector_blocked model's comes from sector_setup (the host build on
        the CPU, the torch build elsewhere). Pad rows of a padded model have
        diagonal 0."""
        self._flat_only("diag")
        dtype = self.dtype if dtype is None else dtype
        if self.padded:
            return self._pad_rows(self.logical().diag(device, dtype))
        if self.stores_states:
            return sector_setup(self, device, dtype, want_table=False)[1]
        s = self.basis_states(device)
        acc = torch.zeros(self.n_states, dtype=dtype, device=device)
        for i in np.nonzero(self.field)[0]:
            acc += float(self.field[i]) * (((s >> int(i)) & 1).to(dtype)
                                           - 0.5)
        for i, j, J in zip(self.zz_i, self.zz_j, self.zz_J):
            bi = ((s >> int(i)) & 1).to(dtype) - 0.5
            bj = ((s >> int(j)) & 1).to(dtype) - 0.5
            acc += float(J) * bi * bj
        return acc

    @property
    def dim(self) -> int:
        return self.n_valid if self.n_valid is not None else self.n_states

    @property
    def dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.field.dtype]


def nn_hopping(L: int, J: float) -> list[tuple[int, int, float]]:
    """Nearest-neighbour open chain; 0-based sites."""
    return [(i, i + 1, float(J)) for i in range(L - 1)]


def long_range_hopping(L: int, J: Callable[[int, int], float]
                       ) -> list[tuple[int, int, float]]:
    """All-pairs coupling with user J(i, j); 0-based."""
    return [(i, j, float(J(i, j))) for i in range(L) for j in range(i + 1, L)]


def _couplings_to_arrays(couplings, L, dtype):
    if couplings is None or len(couplings) == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, dtype))
    arr = np.asarray([(int(i), int(j), float(J)) for (i, j, J) in couplings])
    i = arr[:, 0].astype(np.int32)
    j = arr[:, 1].astype(np.int32)
    if np.any(i < 0) or np.any(i >= L) or np.any(j < 0) or np.any(j >= L):
        raise ValueError("coupling site index out of range [0, L)")
    if np.any(i == j):
        raise ValueError("coupling with i == j")
    return i, j, arr[:, 2].astype(dtype)


def build_model(
    L: int,
    nup: int | None = None,
    hopping: Sequence[tuple[int, int, float]] | None = None,
    onsite_field: Sequence[float] | None = None,
    zz: Sequence[tuple[int, int, float]] | None = None,
    dtype: torch.dtype = torch.float32,
    layout: str | None = None,
    kron_splits: tuple | None = None,
    build_neighbor_table: bool | None = None,
    device_build: bool | None = None,
    lean: bool | None = None,
) -> SpinModel:
    """Create a SpinModel: couplings + layout metadata, no N-sized arrays.

    layout=None resolves by nup: the full 2^L space for nup=None, else
    'sector_kron' (the port's sector layout; the JAX package's default is
    'compact', a deliberate difference). layout='compact' with nup set is
    the ascending U(1) sector (the JAX package's mode 'sector') applied
    through the ELL neighbour table on any device and dtype;
    layout='embedded' (with nup) runs the sector inside the full 2^L space,
    on the flat-state path whose H apply is K3 (ops/fused_matvec.py);
    layout='full' (or nup=None) is the full space on the same path.
    `build_neighbor_table` is the JAX package's: on by default for a
    compact sector, off for the full basis, where a table routes the apply
    to 'ell' as in the JAX package. layout='sector_blocked' (with nup) is
    the sector in (k_hi, rank_hi, rank_lo) order with lo_bits Ll from the
    JAX package's rule (ops/sector_blocked.default_lo_bits), applied by
    ops/sector_blocked.apply_H_sector_blocked on any device and dtype; a
    hopping bond across the lo/hi cut must be the nearest-neighbour one
    (Ll-1, Ll), as in the JAX package.

    `device_build` and `lean` are the JAX package's switches and have no
    effect here: the port's model is always lean (no N-sized array is
    stored, the JAX package's `lean=True`), and what is N-sized is built on
    the device that asks for it (the torch build on the card, numpy on the
    CPU: the JAX package's `device_build` choice, made per call)."""
    if layout not in (None, "compact", "embedded", "full", "sector_blocked",
                      "sector_kron"):
        raise ValueError(f"unknown layout {layout!r}")
    if kron_splits is not None and layout not in (None, "sector_kron"):
        raise ValueError("kron_splits only applies to layout='sector_kron'")
    if layout is None:
        layout = "full" if nup is None else "sector_kron"
    if layout == "compact" and nup is None:
        layout = "full"  # the JAX package's nup=None: the full basis
    if build_neighbor_table is None:
        build_neighbor_table = layout == "compact"
    if build_neighbor_table and layout not in ("compact", "full"):
        raise ValueError("build_neighbor_table applies to the compact and "
                         f"full layouts, not {layout!r}")
    if layout == "full" and nup is not None:
        raise ValueError("layout='full' takes nup=None; use "
                         "layout='embedded' for a sector in the full space")
    if not 1 <= L <= basis_mod.MAX_L:
        raise ValueError(f"L must be in [1, {basis_mod.MAX_L}], got {L}")
    if layout not in ("compact", "full") and nup is None:
        raise ValueError(f"layout={layout!r} requires nup")
    if nup is not None and not 0 <= nup <= L:
        raise ValueError(f"nup must be in [0, {L}], got {nup}")
    if dtype not in _NP_DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"got {dtype}")
    if layout in ("embedded", "full") and L >= 30:
        raise ValueError(
            f"{layout} layout at L={L} needs 2^{L} amplitudes; use the "
            "sector_kron layout")

    np_dtype = _NP_DTYPES[dtype]
    hop_i, hop_j, hop_J = _couplings_to_arrays(hopping, L, np_dtype)
    zz_i, zz_j, zz_J = _couplings_to_arrays(zz, L, np_dtype)
    field = (np.zeros(L, np_dtype) if onsite_field is None
             else np.asarray(onsite_field, dtype=np_dtype))
    if field.shape != (L,):
        raise ValueError(f"onsite_field must have shape ({L},)")
    hop_sites = tuple(zip(hop_i.tolist(), hop_j.tolist()))
    lo_bits = None
    if layout == "sector_blocked":
        from .ops.sector_blocked import make_sector_blocked_layout

        lo_bits = make_sector_blocked_layout(
            (L, nup, hop_sites, hop_J.astype(np.float64).tolist())).Ll
    if layout in FLAT_MODES:
        return SpinModel(
            L=L, nup=nup, field=field,
            hop_i=hop_i, hop_j=hop_j, hop_J=hop_J,
            zz_i=zz_i, zz_j=zz_j, zz_J=zz_J,
            hop_sites=hop_sites,
            zz_sites=tuple(zip(zz_i.tolist(), zz_j.tolist())),
            kron_splits=None, kron_pads=None,
            n_states_static=(basis_mod.sector_dimension(L, nup)
                             if layout in SECTOR_MODES else 1 << L),
            mode=layout, neighbor_table=bool(build_neighbor_table),
            lo_bits=lo_bits)
    from .ops.sector_kron import make_sector_kron_layout

    lay = make_sector_kron_layout(
        (L, nup, hop_sites, hop_J.astype(np.float64).tolist()),
        splits=kron_splits)
    return SpinModel(
        L=L, nup=nup, field=field,
        hop_i=hop_i, hop_j=hop_j, hop_J=hop_J,
        zz_i=zz_i, zz_j=zz_j, zz_J=zz_J,
        hop_sites=hop_sites,
        zz_sites=tuple(zip(zz_i.tolist(), zz_j.tolist())),
        kron_splits=lay.splits, kron_pads=lay.pads,
        n_states_static=lay.n_states,
        n_valid=(lay.n_basis if lay.n_states != lay.n_basis else None),
    )


# ---------------------------------------------------------------------------
# the compact layout's builds: host numpy on the CPU, torch on the card
# ---------------------------------------------------------------------------


def _compute_diag(states, field, zz_i, zz_j, zz_J, dtype, chunk=1 << 22):
    """diag[idx] = sum_i h_i sz(bit_i) + sum_z Jz sz_i sz_j: host numpy,
    chunked over the states, accumulated in float64 and stored in `dtype`
    (the JAX package's host build)."""
    N = states.shape[0]
    out = np.zeros(N, dtype=dtype)
    for s0 in range(0, N, chunk):
        s = states[s0:s0 + chunk]
        acc = np.zeros(s.shape[0], dtype=np.float64)
        for i in np.nonzero(field)[0]:
            acc += field[i] * (((s >> i) & 1).astype(np.float64) - 0.5)
        for i, j, Jz in zip(zz_i, zz_j, zz_J):
            bi = ((s >> i) & 1).astype(np.float64) - 0.5
            bj = ((s >> j) & 1).astype(np.float64) - 0.5
            acc += float(Jz) * bi * bj
        out[s0:s0 + chunk] = acc.astype(dtype)
    return out


def _build_ell_table(states, hop_i, hop_j, chunk=1 << 22):
    """ELL neighbour table of an ascending basis (host numpy, int32
    [N, n_bonds]): nbr[n, b] = rank(state_n XOR mask_b) where bits (i_b,
    j_b) of state_n differ, else -1. The states are ascending, so the rank
    is a searchsorted."""
    N = states.shape[0]
    nbr = np.full((N, hop_i.shape[0]), -1, dtype=np.int32)
    for s0 in range(0, N, chunk):
        s = states[s0:s0 + chunk]
        for b, (i, j) in enumerate(zip(hop_i, hop_j)):
            differ = (((s >> i) ^ (s >> j)) & 1).astype(bool)
            r = np.searchsorted(states, s ^ ((1 << int(i)) | (1 << int(j))))
            nbr[s0:s0 + chunk, b] = np.where(differ, r.astype(np.int32), -1)
    return nbr


def _unranked_sector(L, nup, device) -> torch.Tensor:
    """The ascending sector as int64, unranked on `device` (L passes)."""
    N = basis_mod.sector_dimension(L, nup)
    return basis_mod.unrank_states(
        torch.arange(N, dtype=torch.int64, device=device), L, nup,
        basis_mod.binomial_table(L, nup))


def _sector_states(L, nup, device: torch.device) -> torch.Tensor:
    """The ascending sector as int64: enumerated on the host for the CPU,
    unranked on `device` elsewhere."""
    if device.type == "cpu":
        return torch.from_numpy(
            basis_mod.build_sector_basis(L, nup).astype(np.int64))
    return _unranked_sector(L, nup, device)


def _device_sector_setup(model: SpinModel, device, dtype, want_table):
    """The torch build on `device`: the states (L unrank passes for a
    compact model, an arange for a full one), the diagonal accumulated in
    `dtype`, and, with `want_table`, the int32 ELL table [N, n_bonds], one
    combinadic-rank pass (L steps) per bond. The JAX package's route for
    large sectors on an accelerator, where the host would enumerate and
    rank 4e7..6e8 states."""
    device = torch.device(device)
    L = model.L
    if model.mode == "compact":
        states = _unranked_sector(L, model.nup, device)
    else:
        states = torch.arange(model.n_states, dtype=torch.int64,
                              device=device)
    diag = torch.zeros(states.shape, dtype=dtype, device=device)
    for i in np.nonzero(model.field)[0]:
        diag += float(model.field[i]) * (((states >> int(i)) & 1).to(dtype)
                                         - 0.5)
    for i, j, J in zip(model.zz_i, model.zz_j, model.zz_J):
        bi = ((states >> int(i)) & 1).to(dtype) - 0.5
        bj = ((states >> int(j)) & 1).to(dtype) - 0.5
        diag += float(J) * bi * bj
    if not want_table:
        return states, diag, None
    nbr = torch.empty((model.n_states, model.n_bonds), dtype=torch.int32,
                      device=device)
    for b, (i, j) in enumerate(model.hop_sites):
        differ = (((states >> i) ^ (states >> j)) & 1).bool()
        flipped = states ^ ((1 << i) | (1 << j))
        r = (basis_mod.rank_states(flipped, L, basis_mod.binomial_table(
            L, model.nup)) if model.mode == "compact" else flipped)
        nbr[:, b] = torch.where(differ, r, -1)
    return states, diag, nbr


def _device_blocked_setup(model: SpinModel, device, dtype):
    """The torch build of a sector_blocked model on `device`: the states as
    one outer product (hi << Ll) | lo per group, and the diagonal
    accumulated in float64 in the host build's order (_compute_diag) and
    stored in `dtype`, so that it equals the host build bit for bit. The
    JAX package's route for large sectors on an accelerator."""
    from .ops.sector_kron import _sector_states as part_states

    def part(Lp, k):
        return torch.from_numpy(part_states(Lp, k).astype(np.int64)).to(
            device)

    L, nup, Ll = model.L, model.nup, model.lo_bits
    states = torch.cat([
        ((part(L - Ll, k)[:, None] << Ll) | part(Ll, nup - k)[None, :])
        .reshape(-1)
        for k in range(max(0, nup - Ll), min(L - Ll, nup) + 1)])
    f64 = torch.float64
    acc = torch.zeros(states.shape, dtype=f64, device=device)
    for i in np.nonzero(model.field)[0]:
        acc += float(model.field[i]) * (((states >> int(i)) & 1).to(f64)
                                        - 0.5)
    for i, j, J in zip(model.zz_i, model.zz_j, model.zz_J):
        bi = ((states >> int(i)) & 1).to(f64) - 0.5
        bj = ((states >> int(j)) & 1).to(f64) - 0.5
        acc += float(J) * bi * bj
    return states, acc.to(dtype)


def sector_setup(model: SpinModel, device, dtype: torch.dtype | None = None,
                 want_table: bool = True):
    """(states int64 [N], diag [N] in `dtype`, ELL table int32 [N, n_bonds]
    or None) of a compact model, or of a full model with a neighbour table,
    on `device`; (states, diag, None) of a sector_blocked model. The JAX
    package's choice of build: the torch build (_device_sector_setup,
    _device_blocked_setup) on the card, the host numpy build
    (build_sector_basis or blocked_order_states, _compute_diag,
    _build_ell_table) on the CPU; the two give the same states and table,
    bit for bit (and the same sector_blocked diagonal). A padded model's
    are the logical model's with the pad rows appended: state 0, diagonal
    0, neighbours -1 (pad_model of the JAX package)."""
    if model.mode not in ("compact", "full", "sector_blocked"):
        raise ValueError("sector_setup builds the compact, sector_blocked "
                         f"and full layouts, not mode={model.mode!r}")
    if model.padded:
        states, diag, nbr = sector_setup(model.logical(), device, dtype,
                                         want_table)
        return (model._pad_rows(states), model._pad_rows(diag),
                None if nbr is None else model._pad_rows(nbr, -1))
    device = torch.device(device)
    dtype = model.dtype if dtype is None else dtype
    if model.mode == "sector_blocked":
        if device.type != "cpu":
            return (*_device_blocked_setup(model, device, dtype), None)
        from .ops.sector_blocked import blocked_order_states

        states = blocked_order_states(model.L, model.nup,
                                      model.lo_bits).astype(np.int64)
        diag = _compute_diag(states, model.field, model.zz_i, model.zz_j,
                             model.zz_J, _NP_DTYPES[dtype])
        return torch.from_numpy(states), torch.from_numpy(diag), None
    if device.type != "cpu":
        return _device_sector_setup(model, device, dtype, want_table)
    states = (basis_mod.build_sector_basis(model.L, model.nup)
              if model.mode == "compact"
              else basis_mod.build_full_basis(model.L)).astype(np.int64)
    diag = _compute_diag(states, model.field, model.zz_i, model.zz_j,
                         model.zz_J, _NP_DTYPES[dtype])
    nbr = (torch.from_numpy(_build_ell_table(states, model.hop_i,
                                             model.hop_j))
           if want_table else None)
    return torch.from_numpy(states), torch.from_numpy(diag), nbr
