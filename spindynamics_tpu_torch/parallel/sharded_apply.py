"""Row-sharded ELL apply of a flat model over a mesh (port of
spindynamics_tpu/parallel/sharded_apply.py).

The state's rows are dealt over the D shards of a LocalMesh or a
ProcessMesh (parallel/mesh.py) in blocks of B = Np / D, Np the length
padded to a multiple of D. Two communication schedules, as in the JAX
package:

- `sharded_matvec_fn`: all-gather the source vector over the mesh, then
  each shard's ELL rows. Simple; each shard holds the whole vector.
- `sharded_matvec_halo_fn`: the static halo exchange. The ELL table is
  static, so the rows each shard needs from each other shard, and so every
  (src -> dst) send list, are known at build time (`build_halo_plan`).
  Each apply runs D-1 pairwise exchange rounds of only those rows, and the
  table is remapped into each shard's extended vector
  [own rows (B) | halo slab k = 1..D-1 (Hp each) | one zero]. No
  all-gather.

Both gather each shard's rows through the chunked `addmv` of the ell
kernel's plain version (ops/ell_apply._ell_accumulate), in the state's
dtype, and are plain torch on every device: the JAX package's are
shard_map programs of XLA gathers and products, not Pallas kernels. The
unsharded apply's CUDA kernel (csrc/ell_apply.cu) gathers from one state
indexed by its table; these gather from an all-gathered or halo-extended
array in another index space, and stay on their own path. A LocalMesh
holds the whole padded vector [Np] (shard d = rows [d*B, (d+1)*B)); a
ProcessMesh rank its B rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..model import FLAT_MODES, SpinModel, sector_setup
from ..ops.ell_apply import ELL_CHUNK, _ell_accumulate
from ..utils.device import resolve_device
from ..utils.dtypes import real_dtype
from .mesh import ROWS

__all__ = ["sharded_matvec_fn", "sharded_matvec_halo_fn", "padded_dim",
           "pad_state", "unpad_state", "pad_model", "build_halo_plan",
           "build_halo_plan_torch", "ShardedEllHamiltonian"]


def padded_dim(N: int, n_shards: int) -> int:
    return -(-N // n_shards) * n_shards


def pad_state(psi: torch.Tensor, n_shards: int) -> torch.Tensor:
    """psi zero-padded along its last axis (the rows) to a multiple of
    n_shards."""
    N = psi.shape[-1]
    return torch.nn.functional.pad(psi, (0, padded_dim(N, n_shards) - N))


def unpad_state(psi: torch.Tensor, N: int) -> torch.Tensor:
    return psi[..., :N]


def pad_model(model: SpinModel, n_shards: int) -> SpinModel:
    """The flat model padded to a multiple of the shard count: `n_valid`
    keeps the logical size, and the pad rows the model's builds give
    (basis_states, diag, sector_setup) have state 0, diagonal 0 and
    neighbours -1, so they compute exact zeros and poison nothing (no real
    row points at a pad row: neighbours are < N). A model that is already
    a multiple comes back as it is."""
    if model.mode not in FLAT_MODES:
        raise ValueError("pad_model pads flat models (full, embedded, "
                         f"compact, sector_blocked), not mode={model.mode!r}")
    Np = padded_dim(model.n_states, n_shards)
    if Np == model.n_states:
        return model
    return dataclasses.replace(model, n_states_static=Np, n_valid=model.dim)


def build_halo_plan(nbr_np: np.ndarray, Np: int, D: int):
    """Static halo plan for a row-partitioned ELL table (host numpy, the
    JAX package's function line for line).

    Returns (send_idx [D, D-1, Hp] int32, nbr_ext [Np, n_bonds] int32, Hp):
    send_idx[s, k-1] lists the LOCAL rows shard s ships to (s+k)%D each
    apply (0-padded; padding is sent but never referenced); nbr_ext remaps
    every neighbour of shard d's rows into d's extended vector
    [psi_blk (B) | halo slab k=1..D-1 (Hp each) | one zero sentinel]."""
    B = Np // D
    n_bonds = nbr_np.shape[1]
    need = [[None] * D for _ in range(D)]  # need[d][k]: rows from s=(d-k)%D
    for d in range(D):
        blk = nbr_np[d * B:(d + 1) * B]
        valid = blk >= 0
        owner = np.where(valid, blk // B, -1)
        for k in range(1, D):
            s = (d - k) % D
            need[d][k] = np.unique(blk[valid & (owner == s)])
    Hp = max([len(need[d][k]) for d in range(D) for k in range(1, D)]
             + [1])
    Hp = -(-Hp // 8) * 8  # sublane-align the halo slabs
    send_idx = np.zeros((D, max(D - 1, 1), Hp), np.int32)
    nbr_ext = np.zeros((Np, n_bonds), np.int32)
    sentinel = B + (D - 1) * Hp
    for d in range(D):
        blk = nbr_np[d * B:(d + 1) * B]
        valid = blk >= 0
        out = np.full(blk.shape, sentinel, np.int32)
        local = valid & (blk // B == d)
        out[local] = blk[local] - d * B
        for k in range(1, D):
            s = (d - k) % D
            rows = need[d][k]
            send_idx[s, k - 1, :len(rows)] = rows - s * B
            if len(rows) == 0:
                continue
            m = valid & (blk // B == s)
            out[m] = B + (k - 1) * Hp + np.searchsorted(rows, blk[m])
        nbr_ext[d * B:(d + 1) * B] = out
    return send_idx, nbr_ext, Hp


def build_halo_plan_torch(nbr: torch.Tensor, Np: int, D: int):
    """`build_halo_plan` in torch on nbr's device (the card's build of an
    L=28 plan, where the host's np.unique passes over 1e9 entries would
    dominate the set-up): the same (send_idx, nbr_ext, Hp), equal bit for
    bit (integer arithmetic, sorted unique sets, searchsorted on the left
    as numpy's)."""
    B = Np // D
    dev = nbr.device
    need = [[None] * D for _ in range(D)]
    for d in range(D):
        blk = nbr[d * B:(d + 1) * B]
        owner = torch.where(blk >= 0, torch.div(blk, B, rounding_mode="floor"),
                            -1)
        for k in range(1, D):
            need[d][k] = torch.unique(blk[owner == (d - k) % D], sorted=True)
        del owner
    Hp = max([need[d][k].numel() for d in range(D) for k in range(1, D)]
             + [1])
    Hp = -(-Hp // 8) * 8
    send_idx = torch.zeros((D, max(D - 1, 1), Hp), dtype=torch.int32,
                           device=dev)
    nbr_ext = torch.empty(nbr.shape, dtype=torch.int32, device=dev)
    sentinel = B + (D - 1) * Hp
    for d in range(D):
        blk = nbr[d * B:(d + 1) * B]
        owner = torch.where(blk >= 0, torch.div(blk, B, rounding_mode="floor"),
                            -1)
        out = nbr_ext[d * B:(d + 1) * B]
        out.fill_(sentinel)
        local = owner == d
        out[local] = (blk[local] - d * B).to(torch.int32)
        for k in range(1, D):
            s = (d - k) % D
            rows = need[d][k]
            send_idx[s, k - 1, :rows.numel()] = (rows - s * B).to(torch.int32)
            if rows.numel() == 0:
                continue
            m = owner == s
            out[m] = (B + (k - 1) * Hp + torch.searchsorted(
                rows, blk[m])).to(torch.int32)
    return send_idx, nbr_ext, Hp


class ShardedEllHamiltonian(nn.Module):
    """H on the row shards of a padded flat model with an ELL table
    (compact, or full with a neighbour table) over `mesh`: psi -> H psi,
    both "the rows of this process's shards" (a LocalMesh: the whole
    padded vector [Np]; a ProcessMesh rank: its B rows).

    halo=False is the all-gather schedule, halo=True the halo exchange
    (module docstring). Buffers, rows of this process only: `diag` [rows]
    and the table `nbr` [rows, n_bonds] (all-gather: the padded table,
    indices into the whole vector; halo: the plan's nbr_ext, offset by
    each local shard's place in the extended vectors, which this process
    holds one after another) and, for the halo schedule, `send_idx`
    [n_local, D-1, Hp] (int64 for the gather). `tables=(diag, nbr)` gives
    the padded model's [Np] diagonal and [Np, n_bonds] table (numpy or
    tensors, e.g. a JAX model's through utils.convert); by default they
    are sector_setup's (the torch build on the card, numpy on the CPU),
    and so is the halo plan (build_halo_plan_torch on the card,
    build_halo_plan on the CPU)."""

    def __init__(self, model: SpinModel, mesh, halo: bool, device=None,
                 dtype: torch.dtype | None = None, tables=None):
        super().__init__()
        if model.mode not in ("compact", "full"):
            raise ValueError("the sharded ELL apply runs compact models and "
                             "full ones with a neighbour table, not "
                             f"mode={model.mode!r}")
        if not model.neighbor_table and model.n_bonds > 0 and tables is None:
            raise ValueError("model has no ELL neighbour table "
                             "(build_neighbor_table=True)")
        device = resolve_device(device, mesh=mesh)
        pm = pad_model(model, mesh.D)
        self.model, self.mesh, self.halo = pm, mesh, bool(halo)
        D, Np = mesh.D, pm.n_states
        self.B = B = Np // D
        rdt = real_dtype(dtype or model.dtype)
        if tables is None:
            _, diag, nbr = sector_setup(pm, device, rdt,
                                        want_table=pm.n_bonds > 0)
            if nbr is None:
                nbr = torch.empty((Np, 0), dtype=torch.int32, device=device)
        else:
            diag, nbr = (torch.as_tensor(np.asarray(t) if not isinstance(
                t, torch.Tensor) else t) for t in tables)
            diag, nbr = diag.to(device, rdt), nbr.to(device, torch.int32)
            if diag.shape != (Np,) or nbr.shape[0] != Np:
                raise ValueError(f"tables must be the padded model's: "
                                 f"diag [{Np}], nbr [{Np}, n_bonds]")
        rows = mesh.row_slice(B)
        self.Hp = 0
        if self.halo and nbr.shape[1] > 0:
            if nbr.device.type == "cpu":
                send, ext, Hp = build_halo_plan(nbr.numpy(), Np, D)
                send, ext = torch.from_numpy(send), torch.from_numpy(ext)
            else:
                send, ext, Hp = build_halo_plan_torch(nbr, Np, D)
            del nbr
            self.Hp = Hp
            E = B + (D - 1) * Hp + 1  # one shard's extended vector
            ext = ext[rows].clone()
            for i in range(mesh.n_local):  # shard i's place in [n_local, E]
                ext[i * B:(i + 1) * B] += i * E
            nbr = ext
            self.register_buffer("send_idx",
                                 send[list(mesh.local_shards)].to(
                                     device, torch.int64), persistent=False)
        else:
            nbr = nbr[rows].clone() if mesh.n_local < D else nbr
        self.register_buffer("diag", diag[rows].clone()
                             if mesh.n_local < D else diag, persistent=False)
        self.register_buffer("nbr", nbr, persistent=False)

    @property
    def device(self):
        return self.diag.device

    def _halo_ext(self, psi):
        """[n_local, E] extended vectors: own rows, the D-1 halo slabs
        received in exchange rounds k = 1..D-1 (shard s ships
        psi_s[send_idx[s, k-1]] to (s+k) % D), one zero."""
        mesh, B, Hp, D = self.mesh, self.B, self.Hp, self.mesh.D
        n_loc = mesh.n_local
        x = psi.reshape(n_loc, B)
        ext = psi.new_empty((n_loc, B + (D - 1) * Hp + 1))
        ext[:, :B] = x
        ext[:, -1] = 0
        for k in range(1, D):
            vals = torch.gather(x, 1, self.send_idx[:, k - 1])
            halo = mesh.permute_rows(
                vals.reshape(-1), [(s, (s + k) % D) for s in range(D)])
            ext[:, B + (k - 1) * Hp:B + k * Hp] = halo.reshape(n_loc, Hp)
        return ext.reshape(-1)

    def forward(self, psi: torch.Tensor, chunk: int | None = None
                ) -> torch.Tensor:
        """One apply, in the span `apply.sharded_ell` and the counter
        `applies.sharded_ell` (utils/profiling.py)."""
        from ..utils.profiling import annotate, count

        count("applies.sharded_ell")
        with annotate("apply.sharded_ell"):
            return self._forward(psi, chunk)

    def _forward(self, psi: torch.Tensor, chunk: int | None
                 ) -> torch.Tensor:
        out = psi * self.diag.to(real_dtype(psi.dtype))
        if self.nbr.shape[1] == 0:
            return out
        if self.halo:
            ext = self._halo_ext(psi)
        else:
            # indices -1 (no bond, pad rows) read the appended zero
            ext = torch.cat([self.mesh.all_gather_rows(psi),
                             psi.new_zeros(1)])
        J = torch.as_tensor(self.model.hop_J, device=psi.device).to(
            psi.dtype)
        _ell_accumulate(out, ext, self.nbr, J, chunk or ELL_CHUNK)
        return out


def sharded_matvec_fn(model: SpinModel, mesh, axis_name: str = ROWS,
                      device=None, tables=None):
    """The all-gather sharded H apply of a model with an ELL table over
    `mesh`. Returns (matvec, padded_model): the matvec maps the rows of
    this process's shards of a padded state (shard_state) to the same rows
    of H psi; communication is one all-gather of psi per apply.
    `axis_name` is the JAX package's (the meshes have one axis); `device`
    defaults to the mesh's, else the card; `tables` as in
    ShardedEllHamiltonian."""
    mv = ShardedEllHamiltonian(model, mesh, halo=False, device=device,
                               tables=tables)
    return mv, mv.model


def sharded_matvec_halo_fn(model: SpinModel, mesh, axis_name: str = ROWS,
                           device=None, tables=None):
    """The memory-scaling sharded H apply: the static per-pair halo
    exchange (D-1 `permute_rows` rounds) instead of an all-gather, so each
    shard holds B + (D-1) Hp amplitudes. Same signature and contract as
    `sharded_matvec_fn`."""
    mv = ShardedEllHamiltonian(model, mesh, halo=True, device=device,
                               tables=tables)
    return mv, mv.model
