"""The block-distributed sector_kron apply: no replicated state anywhere
(port of spindynamics_tpu/parallel/sharded_kron_scaling.py).

  DISTRIBUTION: each kron group's hi axis (its major axis) is dealt in D
  contiguous blocks: shard d holds rows [d*b_g, (d+1)*b_g) of every group g,
  b_g = ceil(C_h(g) / D), the hi axis zero-padded at the end to D*b_g (pad
  rows are a null subspace like the tile pads: they stay exactly 0).

  LOCALITY:
  - diagonal, W_lo, W_mid and the lo|mid cross terms leave k_h alone: source
    and destination share the hi axis and the block size -> shard-local.
  - W_hi is a dense contraction over the sharded axis: each shard computes a
    PARTIAL over the full destination hi axis from its rows, and one
    reduce-scatter per (group, apply) sums and deals it out.
  - mid|hi cross terms are block shifts on the hi axis: delivered as
    destination-aligned WINDOWS, a slice of the source leaf whose rows move
    between neighbouring shards only where a run crosses a block boundary.

  COMPUTE: the hi-local terms of the large groups run in K1 (ops/kron_group)
  on each shard's local block, with the reduce-scattered W_hi partial as the
  kernel SEED and the windows read in-kernel (K1's crossw variant). At D == 1
  nothing is windowed: the mid|hi terms are K1's shifted reads of the source
  groups, the launches of the unsharded apply.

JAX derives the collectives from one global array; here the mesh object
(parallel/mesh.py) holds the shards: `LocalMesh(D)` keeps all D in one
process on one device (a leaf is the whole padded tensor [D*b_g, cmp, clp]),
`ProcessMesh` one per rank of a torch.distributed group (a leaf is the
rank's [b_g, cmp, clp]). The per-shard code below (`_hi_partial`,
`_local_group`) takes a shard's index, its local leaves, windows and seed,
and never asks which mesh it runs under; a LocalMesh loops the shards over
it.

`collective_traffic_model` predicts the per-apply collective volumes; the
meshes count what they move, and the tests hold one to the other.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..model import SpinModel
from ..ops.kron_group import (
    _from_skeleton,
    _GroupCall,
    _to_skeleton,
    _unsupported_terms,
    fused_group_plans,
    fused_group_set,
    fused_group_tables,
    kron_group_apply,
)
from ..ops.sector_kron import (
    SectorKronLayout,
    _contract,
    apply_H_sector_kron,
    default_fused_topk,
    kron_tables,
    make_sector_kron_layout,
)
from ..solvers.blockvec import BlockVec
from ..utils.device import resolve_device
from ..utils.dtypes import lift_bf16
from .mesh import ROWS

# How many groups ahead of the running kernel a hi-axis partial is computed
# and its reduce-scatter started: the number of partials (each a full
# destination hi axis) alive per shard at once.
_SCATTER_AHEAD = 4

__all__ = [
    "KronShardSpec",
    "kron_shard_spec",
    "shard_kron_state",
    "unshard_kron_state",
    "shard_kron_blockvec",
    "unshard_kron_blockvec",
    "ShardedKronHamiltonian",
    "sharded_kron_scaling_matvec_fn",
    "sharded_kron_scaling_bv_matvec_fn",
    "collective_traffic_model",
]


def collective_traffic_model(layout, spec, cfg=None, itemsize=4):
    """Predicted per-apply collective volumes of the sharded kron matvec,
    from the layout alone (what a mesh's counters must show after one
    apply):

      n_reduce_scatter / reduce_scatter_bytes: one reduce-scatter per group
        with a hi-axis partial Z; each operand is the per-shard
        [ch_pad, C_m_pad, C_l_pad] partial. Bytes that cross between shards
        ~ (D-1)/D * reduce_scatter_bytes.
      window_bytes: content of the mid|hi cross windows (fused path, D > 1).
        Only rows that cross a shard boundary travel, so under a
        ProcessMesh this is an upper bound on what the ranks receive.
      overlappable_bytes: the volume that can be in flight behind kernel
        compute: every reduce-scatter's operand depends on the input state
        alone, and the windows are exchanged before any kernel runs.

    `cfg` is the fused configuration (a ShardedKronHamiltonian's `cfg`;
    None for the unfused apply)."""
    rs_bytes = 0
    n_rs = 0
    win_bytes = 0
    for gi, (k_h, k_m, k_l, ch, cm, cl, cmp, clp) in enumerate(layout.groups):
        if _has_partial(layout, cfg, gi):
            rs_bytes += spec.ch_pad[gi] * cmp * clp * itemsize
            n_rs += 1
    if cfg is not None and cfg.windowed:
        for (gi, ei) in cfg.win_order:
            (g_src, rb0, cb0, lnb, mids) = cfg.plans[gi].crossh[ei]
            (_, _, _, chs, _, _, cmps, clps) = layout.groups[g_src]
            win_bytes += lnb * cmps * clps * itemsize
    D = spec.D
    return {"n_reduce_scatter": n_rs, "reduce_scatter_bytes": rs_bytes,
            "window_bytes": win_bytes,
            "overlappable_bytes": rs_bytes * (D - 1) // max(D, 1) + win_bytes}


def _has_partial(layout, cfg, gi) -> bool:
    """Whether group gi has a hi-axis partial Z (and so a reduce-scatter):
    its W_hi term, plus its mid|hi cross terms unless they ride windows
    (D > 1) or K1's shifted reads (D == 1). Static: every shard agrees."""
    k_h = layout.groups[gi][0]
    has_whi = k_h in layout.W[2]
    if (cfg is not None and gi in cfg.fused_set
            and cfg.plans[gi].crossh_fusable):
        return has_whi
    return has_whi or any(2 in (pa, pb)
                          for (_, pa, pb, _, _) in layout.cross_meta[gi])


class KronShardSpec:
    """Static shapes of the block-distributed kron state for D shards."""

    def __init__(self, layout: SectorKronLayout, n_devices: int):
        self.layout = layout
        self.D = n_devices
        self.b = []           # per group: local hi-block rows
        self.ch_pad = []      # per group: padded hi axis (= D * b)
        self.local_offsets = []  # per group: offset within one shard block
        off = 0
        for (_, _, _, ch, _, _, cmp, clp) in layout.groups:
            b = -(-ch // n_devices)
            self.b.append(b)
            self.ch_pad.append(b * n_devices)
            self.local_offsets.append(off)
            off += b * cmp * clp
        self.local_len = off

    @property
    def n_sharded(self) -> int:
        """Total sharded-state length (= D * local_len)."""
        return self.D * self.local_len


def kron_shard_spec(layout: SectorKronLayout, n_devices: int) -> KronShardSpec:
    return KronShardSpec(layout, n_devices)


def shard_kron_state(psi_flat: torch.Tensor, spec: KronShardSpec
                     ) -> torch.Tensor:
    """Flat kron-order state -> block-distributed order (length
    D*local_len): per group [ch, cmp, clp] -> hi padded to D*b ->
    [D, b*cmp*clp]; the D axis of all groups is gathered into the leading
    shard axis, so shard d's block is rows d of the [D, local_len] view."""
    lay, D = spec.layout, spec.D
    per_dev = []
    for gi, (_, _, _, ch, _, _, cmp, clp) in enumerate(lay.groups):
        o = lay.offsets[gi]
        T = psi_flat[o: o + ch * cmp * clp].reshape(ch, cmp * clp)
        T = torch.nn.functional.pad(T, (0, 0, 0, spec.ch_pad[gi] - ch))
        per_dev.append(T.reshape(D, spec.b[gi] * cmp * clp))
    return torch.cat(per_dev, dim=1).reshape(-1)


def unshard_kron_state(psi_sh: torch.Tensor, spec: KronShardSpec
                       ) -> torch.Tensor:
    """Inverse of shard_kron_state (drops the hi padding rows)."""
    lay, D = spec.layout, spec.D
    blocks = psi_sh.reshape(D, spec.local_len)
    outs = []
    for gi, (_, _, _, ch, _, _, cmp, clp) in enumerate(lay.groups):
        lo = spec.local_offsets[gi]
        T = blocks[:, lo: lo + spec.b[gi] * cmp * clp]
        T = T.reshape(spec.ch_pad[gi], cmp * clp)[:ch]
        outs.append(T.reshape(-1))
    return torch.cat(outs)


def shard_kron_blockvec(bv: BlockVec, spec: KronShardSpec, mesh=None
                        ) -> BlockVec:
    """BlockVec [ch, cmp, clp] leaves -> sharded-form leaves: the hi axis
    zero-padded to D*b, and of those rows the ones `mesh` holds in this
    process (all of them for a LocalMesh or no mesh, the rank's b rows for
    a ProcessMesh). The result carries the mesh."""
    out = []
    for gi, l in enumerate(bv.leaves):
        l = torch.nn.functional.pad(
            l, (0, 0, 0, 0, 0, spec.ch_pad[gi] - l.shape[0]))
        out.append(l if mesh is None else l[mesh.row_slice(spec.b[gi])])
    return BlockVec(out, mesh)


def unshard_kron_blockvec(bv: BlockVec, spec: KronShardSpec) -> BlockVec:
    """Inverse of shard_kron_blockvec (drops hi padding rows) for leaves
    that hold every shard's rows; a ProcessMesh rank holds only its own."""
    if any(l.shape[0] != chp for l, chp in zip(bv.leaves, spec.ch_pad)):
        raise ValueError("unshard_kron_blockvec needs whole sharded-form "
                         "leaves [D*b, cmp, clp]; these hold one rank's rows")
    return BlockVec([
        l[:ch] for l, (_, _, _, ch, _, _, _, _) in zip(bv.leaves,
                                                       spec.layout.groups)])


def to_sharded(bv: BlockVec, spec: KronShardSpec, mesh) -> BlockVec:
    """bv on `mesh` in sharded form: as it is when its leaves already hold
    this process's rows, else padded and cut (shard_kron_blockvec)."""
    if is_sharded_form(bv, spec, mesh):
        return BlockVec(bv.leaves, mesh)
    return shard_kron_blockvec(bv, spec, mesh)


def flat_to_sharded_leaves(psi, spec: KronShardSpec, mesh) -> list:
    """The sharded-form leaves [n_local*b_g, cmp, clp] of a flat
    block-distributed state (the [n_local, local_len] blocks of this
    process's shards): views for one local shard, a gather of the blocks'
    parts otherwise."""
    nl = mesh.n_local
    v = psi.reshape(nl, spec.local_len)
    leaves = []
    for gi, (_, _, _, _, _, _, cmp, clp) in enumerate(spec.layout.groups):
        lo = spec.local_offsets[gi]
        leaves.append(v[:, lo: lo + spec.b[gi] * cmp * clp].reshape(
            nl * spec.b[gi], cmp, clp))
    return leaves


def is_sharded_form(bv: BlockVec, spec: KronShardSpec, mesh) -> bool:
    """Whether bv's leaves already have the rows `mesh` holds here."""
    return all(l.shape[0] == mesh.n_local * b
               for l, b in zip(bv.leaves, spec.b))


class _FusedCfg:
    """Static config of the fused sharded apply: which groups run K1, and
    how their mid|hi cross terms are delivered."""

    def __init__(self, layout, spec, top_k: int):
        self.plans = fused_group_plans(layout)
        self.fused_set = fused_group_set(layout, top_k)
        # window order: (gi ascending, crossh entry order) over the fused
        # groups whose mid|hi terms are all run x run (crossh_fusable). At
        # D == 1 every row is local: K1 reads the source groups, no window
        self.windowed = spec.D > 1
        self.win_order = []
        if self.windowed:
            for gi in range(len(layout.groups)):
                p = self.plans[gi]
                if gi in self.fused_set and p.crossh_fusable:
                    self.win_order.extend((gi, ei)
                                          for ei in range(len(p.crossh)))
        self._spec = spec
        self._windows = {}
        self.moves, self.win_pos = self.windows_for(None)

    def windows_for(self, want):
        """(moves, win_pos) of the windows that the groups `want` read
        (None: every group): `moves` is the mesh's view of them, (source
        leaf, rb0, cb0, lnb, source block rows, destination block rows) in
        window order, and win_pos[(gi, ei)] the window's index there.
        Static per set of groups, so kept."""
        if want not in self._windows:
            b = self._spec.b
            keys = [k for k in self.win_order if want is None or k[0] in want]
            moves = tuple(
                (self.plans[gi].crossh[ei][0],)
                + self.plans[gi].crossh[ei][1:4]
                + (b[self.plans[gi].crossh[ei][0]], b[gi])
                for (gi, ei) in keys)
            self._windows[want] = (moves, {k: i for i, k in enumerate(keys)})
        return self._windows[want]


def _build_crossh_windows_leaves(leaves, moves, mesh):
    """The mid|hi cross sources as destination-aligned windows, from the
    sharded-form leaves: for a crossh entry (g_src, rb0, cb0, lnb, mids) of
    group gi, rows [cb0, cb0+lnb) of the window [D*b_gi, cmp_s, clp_s] are
    source rows [rb0, rb0+lnb) and the rest is zero, i.e. the hi-run factor
    applied globally. `moves` lists the windows wanted
    (_FusedCfg.windows_for). The mesh moves the rows (a slice and a pad in
    one process, isend/irecv of the boundary rows between ranks) and
    returns the rows of each window that this process's shards own."""
    if not moves:
        return []
    return mesh.exchange_windows(leaves, moves)


def _runs_to_matrix(runs, shape):
    """A multi-run factor as a dense matrix (float64: the caller casts to
    the state's dtype)."""
    M = np.zeros(shape, np.float64)
    for (r0, c0, ln, val) in runs:
        M[np.arange(r0, r0 + ln), np.arange(c0, c0 + ln)] = val
    return M


def _hi_partial(sh, gi, G, tables, lay, spec, include_cross: bool):
    """Shard sh["d"]'s hi-axis partial of group gi: Z [ch_pad, cmp, clp]
    over the FULL destination hi axis, from the shard's rows alone (the
    caller reduce-scatters it). `include_cross=False` restricts Z to the
    W_hi term (the fused path delivers mid|hi cross terms through windows
    or K1's shifted reads). Summed in float32 for bfloat16 leaves.

    A run factor on the hi axis places the shard's source rows
    [max(r0, d*b_s), min(r0+ln, (d+1)*b_s)) on destination rows shifted by
    c0 - r0. The shard index is a host integer here, so the rows are static
    slices of Z itself: the traced JAX version needs a scratch buffer three
    hi axes long (Zext) so that a dynamic update is never clamped onto the
    wrong rows; nothing can clamp a static slice, whatever the sizes of the
    source and destination hi axes."""
    (k_h, k_m, k_l, ch, cm, cl, cmp, clp) = lay.groups[gi]
    d = sh["d"]
    T = G[gi]
    chp = spec.ch_pad[gi]
    Wb = sh["W_hi"].get(k_h)   # the shard's rows of the padded [chp, chp]
    if Wb is not None:
        Z = _contract(T, Wb, 2)
    else:
        Z = torch.zeros((chp, cmp, clp), device=T.device,
                        dtype=(torch.float32 if T.dtype == torch.bfloat16
                               else T.dtype))
    if not include_cross:
        return Z
    for (g_src, pa, pb, a_key, b_key) in lay.cross_meta[gi]:
        if 2 not in (pa, pb):
            continue
        fac = {pa: (a_key, lay.cross_runs.get(a_key)),
               pb: (b_key, lay.cross_runs.get(b_key))}
        # the local-side factor first (a slice or a product on mid/lo)
        p_loc = pa if pb == 2 else pb
        X = lift_bf16(G[g_src])
        mid = slice(None)
        key_loc, runs_loc = fac[p_loc]
        if runs_loc is None:
            X = _contract(X, tables["cross"][key_loc], p_loc)
        elif len(runs_loc) == 1 and p_loc == 1:
            (r0, c0, ln, val) = runs_loc[0]
            X = X[:, r0:r0 + ln]
            if val != 1.0:
                X = val * X
            mid = slice(c0, c0 + ln)
        else:
            M = torch.as_tensor(
                _runs_to_matrix(runs_loc, lay.cross_shapes[key_loc]),
                dtype=X.dtype, device=X.device)
            X = _contract(X, M, p_loc)
        # the hi-side factor: place the local slab, or its product, into Z
        key_hi, runs_hi = fac[2]
        bs = spec.b[g_src]
        if runs_hi is not None:
            for (r0, c0, ln, val) in runs_hi:
                lo, hi = max(r0, d * bs), min(r0 + ln, (d + 1) * bs)
                if lo < hi:
                    Z[lo + c0 - r0: hi + c0 - r0, mid].add_(
                        X[lo - d * bs: hi - d * bs], alpha=val)
        else:
            Z[:, mid].add_(_contract(X, sh["cross_hi"][key_hi], 2))
    return Z


def _local_group(sh, gi, G, wins, seed, out, tables, lay, cfg):
    """Shard sh["d"]'s rows of group gi's output, written into `out`
    [b, cmp, clp]: K1 on the local block for a fused group (the
    reduce-scattered partial as its seed; the mid|hi terms from `wins`, the
    shard's rows of the group's windows, or at D == 1 from the source
    groups), else the plain hi-local terms (from the shard's leaves with
    its rows of the hi tables) plus the seed. G: the shard's local leaves;
    seed: its rows of the scattered partial or None."""
    sdt = G[gi].dtype
    call = sh["calls"][gi] if cfg is not None else None
    if call is None:
        acc = apply_H_sector_kron(G, None, lay, sh["tabs"],
                                  terms="diag,lo,mid,crossl",
                                  group_filter=(gi,))[gi]
        if seed is not None:
            acc = acc + seed
        out.copy_(acc)  # one rounding for a bfloat16 state
        return
    kron_group_apply(G[gi], None if seed is None else seed.to(sdt),
                     [G[c[0]] for c in call.cross],
                     [G[c[0]] for c in call.crossh], call, wins, out=out)
    if call.unsupported:  # rare unfusable hi-local cross entries
        extra = _unsupported_terms(G, lay, tables, [call])[gi]
        out.copy_(lift_bf16(out) + extra)


class ShardedKronHamiltonian(nn.Module):
    """H on row-sharded BlockVec states of one SectorKronLayout over
    `mesh` (a LocalMesh or a ProcessMesh): the module form of the JAX
    package's sharded_kron_scaling_bv_matvec_fn.

    Like KronHamiltonian, the tables are registered (non-persistent)
    buffers and the routing is fixed at construction, in fields: `fused`
    (K1 on each shard's local block for the `top_k` largest groups, else
    the plain apply on the local blocks). The hi-axis
    tables (W_hi, the hi factors of cross terms, the hi diagonal vectors,
    K1's D2 and D3) are stored zero-padded to the padded hi axis once, and
    a shard reads its rows as views: no per-apply copies. `device`
    defaults to the mesh's, else the card.

    forward(bv) takes and returns sharded-form leaves (shard_kron_blockvec)
    in bv's dtype: float32 (or float64 when not fused) tables also serve
    bfloat16 states (float32 partials and sums; seeds, windows and K1's
    loads and store in bfloat16). There is no axpy form. forward(bv,
    groups=...) computes those groups' outputs alone (None elsewhere): the
    bucketed Ritz finalize of the ground-state solve asks for H psi a few
    groups at a time.

    Schedule. The windows are exchanged first. Then each group's hi-axis
    partial is computed and its reduce-scatter started (asynchronously under
    a ProcessMesh) `_SCATTER_AHEAD` (4) groups ahead of the group whose
    kernel runs next: no scatter's operand depends on a kernel output, so a
    collective is in flight behind the kernels of the groups before it,
    and at most 4 partials (each a full destination hi axis) are alive per
    shard, where starting all of them first (the JAX package's two-phase
    order) would hold a whole state's worth. `schedule` lists the last
    apply's ("scatter" | "group", gi) events in the order they were
    started."""

    def __init__(self, layout: SectorKronLayout, mesh, dtype=torch.float32,
                 device=None, fused: bool = True, top_k: int | None = None):
        super().__init__()
        if fused and dtype != torch.float32:
            raise ValueError(
                "fused=True runs K1, whose tables are float32 (states "
                "float32 or bfloat16); a float64 validation run passes "
                "fused=False")
        device = resolve_device(device, mesh=mesh)
        self.layout = layout
        self.mesh = mesh
        self.spec = KronShardSpec(layout, mesh.D)
        self.fused = fused
        self.top_k = default_fused_topk(layout) if top_k is None else top_k
        self.cfg = _FusedCfg(layout, self.spec, self.top_k) if fused else None
        self.supports_axpy = False
        self.schedule = []
        memo = {}
        tree = {"tables": kron_tables(layout, dtype, device, memo),
                "hi": self._padded_hi_tables(dtype, device),
                "groups": (fused_group_tables(layout, dtype, device, memo,
                                              hi_pad=self.spec.ch_pad)
                           if fused else [])}
        self.register_buffer("_anchor", torch.empty(0, dtype=dtype,
                                                    device=device),
                             persistent=False)
        self._skeleton = _to_skeleton(self, tree, {})
        self._resolved = None

    def _padded_hi_tables(self, dtype, device):
        """Every table indexed by a hi row, zero-padded to the padded hi
        axis of its k_h: {"W": {k_h: [chp, chp]}, "cross": {key: [chp_src,
        chp_dst]}, "dvec": {k_h: [chp]}, "dcross": [({k: vec}, {k: vec})]
        with the hi-part vectors padded}."""
        lay, spec = self.layout, self.spec
        chp = {g[0]: spec.ch_pad[gi] for gi, g in enumerate(lay.groups)}

        def ten(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        def padv(v, n):
            return ten(np.pad(np.asarray(v), (0, n - len(v))))

        def padm(M, rows, cols):
            return ten(np.pad(np.asarray(M), ((0, rows - M.shape[0]),
                                              (0, cols - M.shape[1]))))

        cross = {}
        for gi, metas in enumerate(lay.cross_meta):
            for (g_src, pa, pb, a_key, b_key) in metas:
                key = a_key if pa == 2 else b_key if pb == 2 else None
                if key is not None and key in lay.cross_pool:
                    cross[key] = padm(lay.cross_pool[key],
                                      spec.ch_pad[g_src], spec.ch_pad[gi])
        return {
            "W": {k: padm(W, chp[k], chp[k]) for k, W in lay.W[2].items()},
            "cross": cross,
            "dvec": {k: padv(v, chp[k])
                     for k, v in lay.diag_vecs[2].items()},
            "dcross": [tuple({k: padv(v, chp[k]) if p == 2 else ten(v)
                              for k, v in vs.items()}
                             for p, vs in ((pa, va), (pb, vb)))
                       for (pa, pb, va, vb) in lay.diag_cross],
        }

    def _apply(self, fn, recurse=True):
        self._resolved = None  # tensors move: rebuild views and descriptors
        return super()._apply(fn, recurse)

    @property
    def dtype(self):
        return self._anchor.dtype

    @property
    def device(self):
        return self._anchor.device

    def _shard_state(self, d, tree, bf16_memo):
        """What shard d's code reads besides the state: its rows of the hi
        tables (views), the plain-apply tables with those rows in place of
        the hi vectors, and its K1 calls."""
        lay, spec, cfg = self.layout, self.spec, self.cfg
        hi, tables = tree["hi"], tree["tables"]
        b = {g[0]: spec.b[gi] for gi, g in enumerate(lay.groups)}

        def rows(t, n):
            return t[d * n: (d + 1) * n]

        b_src = {}
        for gi, metas in enumerate(lay.cross_meta):
            for (g_src, pa, pb, a_key, b_key) in metas:
                if 2 in (pa, pb):
                    b_src[a_key if pa == 2 else b_key] = spec.b[g_src]
        tabs = dict(tables)
        tabs["dvec"] = [tables["dvec"][0], tables["dvec"][1],
                        {k: rows(v, b[k]) for k, v in hi["dvec"].items()}]
        tabs["dcross"] = [
            tuple({k: rows(v, b[k]) if p == 2 else v for k, v in vs.items()}
                  for p, vs in ((pa, va), (pb, vb)))
            for (pa, pb, _, _), (va, vb) in zip(lay.diag_cross,
                                                hi["dcross"])]
        calls = None
        if cfg is not None:
            calls = [None] * len(lay.groups)
            for gi in cfg.fused_set:
                gt = dict(tree["groups"][gi])
                for name in ("D2", "D3"):
                    if gt[name] is not None:
                        gt[name] = rows(gt[name], spec.b[gi])
                calls[gi] = _GroupCall(lay, cfg.plans[gi], gt, True,
                                       rows=spec.b[gi],
                                       windowed=cfg.windowed,
                                       bf16_memo=bf16_memo)
        return {"d": d, "tabs": tabs, "calls": calls,
                "W_hi": {k: rows(W, b[k]) for k, W in hi["W"].items()},
                "cross_hi": {k: rows(M, b_src[k])
                             for k, M in hi["cross"].items()}}

    def _state(self):
        if self._resolved is None:
            tree = _from_skeleton(self, self._skeleton)
            memo = {}  # K1's bfloat16 tables, shared by the shards' calls
            self._resolved = (tree["tables"],
                              [self._shard_state(d, tree, memo)
                               for d in self.mesh.local_shards])
        return self._resolved

    @property
    def tables(self) -> dict:
        """The plain-apply tables (kron_tables layout, unpadded)."""
        return self._state()[0]

    @property
    def shard(self):
        """The `shard=` argument of the BlockVec state constructors."""
        return self.spec, self.mesh

    def to_mesh(self, bv: BlockVec) -> BlockVec:
        """bv in the form forward takes: padded and cut to this process's
        rows unless its leaves are in that form already."""
        return to_sharded(bv, self.spec, self.mesh)

    def forward(self, bv: BlockVec, groups=None) -> BlockVec:
        """One apply, in the span and counter of its route
        (`apply.sharded_k1`, `apply.sharded_plain` or
        `apply.sharded_groups`, utils/profiling.py)."""
        from ..utils.profiling import annotate, count

        route = ("sharded_groups" if groups is not None
                 else "sharded_k1" if self.fused else "sharded_plain")
        count("applies." + route)
        with annotate("apply." + route):
            return self._forward(bv, groups)

    def _forward(self, bv: BlockVec, groups) -> BlockVec:
        lay, spec, cfg, mesh = self.layout, self.spec, self.cfg, self.mesh
        want = None if groups is None else frozenset(groups)
        order = sorted(range(len(lay.groups)) if want is None else want)
        tables, shards = self._state()
        leaves = list(bv.leaves)
        nl = mesh.n_local
        if not is_sharded_form(bv, spec, mesh):
            raise ValueError(
                "the sharded apply takes sharded-form leaves "
                f"[{nl} * b_g, cmp, clp] (shard_kron_blockvec)")

        def local(x, gi, i):
            return x[i * spec.b[gi]: (i + 1) * spec.b[gi]]

        G = [[local(l, gi, i) for gi, l in enumerate(leaves)]
             for i in range(nl)]
        wins, win_pos = [], {}
        if cfg is not None:  # only the windows that the wanted groups read
            moves, win_pos = cfg.windows_for(want)
            wins = _build_crossh_windows_leaves(leaves, moves, mesh)
        fused = cfg.fused_set if cfg is not None else frozenset()
        with_z = [gi for gi in order if _has_partial(lay, cfg, gi)]
        self.schedule = schedule = []
        pending, nxt = {}, 0

        def scatter_until(n):
            nonlocal nxt
            while nxt < min(n, len(with_z)):
                g = with_z[nxt]
                cross = not (g in fused and cfg.plans[g].crossh_fusable)
                pending[g] = mesh.reduce_scatter_rows(
                    _hi_partial(sh, g, G[i], tables, lay, spec, cross)
                    for i, sh in enumerate(shards))
                schedule.append(("scatter", g))
                nxt += 1

        outs = [None] * len(leaves)
        n_done = 0  # groups with a partial whose seed was consumed
        for gi in order:
            scatter_until(n_done + _SCATTER_AHEAD)
            seed = None
            if gi in pending:
                seed = pending.pop(gi).wait()
                n_done += 1
            schedule.append(("group", gi))
            outs[gi] = torch.empty_like(leaves[gi])
            for i, sh in enumerate(shards):
                w = []
                if cfg is not None and sh["calls"][gi] is not None:
                    w = [local(wins[win_pos[(gi, ei)]], gi, i)
                         for ei in range(len(sh["calls"][gi].crossw))]
                _local_group(sh, gi, G[i], w,
                             None if seed is None else local(seed, gi, i),
                             local(outs[gi], gi, i), tables, lay, cfg)
        return BlockVec(outs, mesh)


def _layout_of(model: SpinModel) -> SectorKronLayout:
    if model.kron_splits is None:
        raise ValueError("model must be built with layout='sector_kron'")
    return make_sector_kron_layout(model, model.kron_splits, model.kron_pads)


def sharded_kron_scaling_bv_matvec_fn(model: SpinModel, mesh,
                                      axis_name: str = ROWS,
                                      use_fused: bool | None = None,
                                      top_k: int | None = None, device=None):
    """BlockVec form of the block-distributed kron matvec: (matvec, layout,
    spec) with matvec a ShardedKronHamiltonian over `mesh`, mapping
    sharded-form BlockVecs (shard_kron_blockvec) to the same. use_fused
    defaults to a float32 model (a float64 model runs the plain apply on
    the local blocks: the validation path); top_k bounds the groups K1
    takes (default `default_fused_topk`), the rest keep the plain path.
    `axis_name` is kept from the JAX signature; the meshes have one axis.
    `device` defaults to the mesh's, else the card."""
    del axis_name
    layout = _layout_of(model)
    if use_fused is None:
        use_fused = model.dtype == torch.float32
    if use_fused and model.dtype != torch.float32:
        raise ValueError(
            "use_fused requires a float32 model; the float64 validation "
            "path runs with use_fused=False")
    H = ShardedKronHamiltonian(layout, mesh, dtype=model.dtype,
                               device=device, fused=use_fused, top_k=top_k)
    return H, layout, H.spec


def sharded_kron_scaling_matvec_fn(model: SpinModel, mesh,
                                   axis_name: str = ROWS,
                                   use_fused: bool | None = None,
                                   top_k: int | None = None, device=None):
    """Flat form of the block-distributed kron matvec: (matvec, layout,
    spec); matvec maps a block-distributed flat state (shard_kron_state
    order; the [n_local, local_len] rows of this process's shards) to the
    same. A thin wrapper of the BlockVec form, which is the one to use: a
    rank's per-group views of its flat block are free, but a LocalMesh's
    whole leaves [D*b_g, cmp, clp] are gathered out of the D blocks (one
    copy in, one concatenate out)."""
    H, layout, spec = sharded_kron_scaling_bv_matvec_fn(
        model, mesh, axis_name, use_fused, top_k, device)
    nl = mesh.n_local

    def matvec(psi):
        out = H(BlockVec(flat_to_sharded_leaves(psi, spec, mesh), mesh))
        return torch.cat([l.reshape(nl, -1) for l in out.leaves],
                         dim=1).reshape(-1)

    matvec.H = H
    matvec.device = H.device
    return matvec, layout, spec
