"""The object a `mesh=` argument takes: D row shards of a kron state or of
a flat state, held by one process or by the ranks of a process group (the
port's counterpart of spindynamics_tpu/parallel/mesh.py and of the 1-D
`jax.sharding.Mesh` the JAX package's sharded paths run on).

JAX's mesh is a global view: one array, rows dealt to devices, collectives
derived by the compiler. PyTorch has no such view, so the two forms below
hold the shards explicitly, behind one interface:

  LocalMesh(D)     D shards in ONE process on ONE device. A sharded-form
                   leaf is the whole padded tensor [D*b, cmp, clp] (a flat
                   state: the whole padded vector [D*B]); shard d is the
                   view of rows [d*b, (d+1)*b). Collectives are tensor
                   operations. This is what runs a D-shard apply on one
                   card (and the CPU tests): the per-shard kernels,
                   windows and seeds are the multi-GPU run's own.
  ProcessMesh()    one shard per rank of a torch.distributed process group
                   (NCCL between cards, gloo on the CPU). A leaf is the
                   rank's [b, cmp, clp] block (a flat state: its B rows).

Both hold a leaf as "the rows of my shards, in shard order": local shard i
(global index `local_shards[i]`) is rows [i*b, (i+1)*b) of the leaf, and
`row_slice(b)` says which rows of the padded global hi axis [D*b] those
are. Code written against that runs unchanged on either mesh.

The kron path's collectives are the reduce-scatter of partials, the
window exchange and the all-reduce of dots; the flat path's (the JAX
package's shard_map applies) are `all_gather_rows` (JAX's
`all_gather(..., tiled=True)`) and `permute_rows` (JAX's `ppermute` by a
(src, dst) list). Every collective counts its calls and bytes
(`counters()`: the bytes the shards of this process receive), so a test
can hold an apply to `collective_traffic_model` or to the halo plan.

`shard_state` and `shard_model` (the JAX names) put a flat state and a
flat model on a mesh: zero pad rows up to a multiple of D, then this
process's rows; the model keeps its logical size in `n_valid`.
"""

from __future__ import annotations

import torch

__all__ = ["ROWS", "LocalMesh", "ProcessMesh", "shard_state",
           "shard_model"]

ROWS = "rows"  # the JAX package's mesh axis name, kept for signatures


class _Done:
    """A finished collective: wait() returns its result."""

    def __init__(self, out):
        self._out = out

    def wait(self):
        return self._out


class _Pending:
    """An asynchronous collective in flight: wait() blocks the current
    stream (NCCL) or the host (gloo) until `out` is ready."""

    def __init__(self, work, out, keep):
        self._work, self._out, self._keep = work, out, keep

    def wait(self):
        self._work.wait()
        self._keep = None  # the operand may be freed now
        return self._out


def window_segments(move, D: int):
    """The row ranges one window move sends between shards, as a list of
    (sender, receiver, src_row, dst_row, n_rows) in local rows of the
    sender's source block and of the receiver's window.

    move = (src, rb0, cb0, lnb, b_src, b_dst): global rows [rb0, rb0+lnb)
    of leaf `src` (dealt in blocks of b_src rows) land on global rows
    [cb0, cb0+lnb) of a window dealt in blocks of b_dst rows. Static: it
    depends on the layout and D alone."""
    _, rb0, cb0, lnb, b_src, b_dst = move
    out = []
    for r in range(D):
        lo, hi = max(cb0, r * b_dst), min(cb0 + lnb, (r + 1) * b_dst)
        if lo >= hi:
            continue
        slo, shi = lo - cb0 + rb0, hi - cb0 + rb0
        for s in range(slo // b_src, (shi - 1) // b_src + 1):
            a, b = max(slo, s * b_src), min(shi, (s + 1) * b_src)
            out.append((s, r, a - s * b_src, a - rb0 + cb0 - r * b_dst,
                        b - a))
    return out


class _Mesh:
    """Counters shared by both meshes."""

    def __init__(self):
        self.reset_counters()

    def reset_counters(self) -> None:
        self.n_reduce_scatter = 0
        self.reduce_scatter_bytes = 0   # operand bytes, per shard
        self.n_window_exchange = 0
        self.window_bytes = 0           # window content placed here
        self.window_bytes_remote = 0    # of those, received from other ranks
        self.n_all_reduce = 0
        self.all_reduce_bytes = 0
        self.n_all_gather = 0
        self.all_gather_bytes = 0       # rows received from other shards
        self.n_permute = 0
        self.permute_bytes = 0          # rows received from other shards

    def counters(self) -> dict:
        return {k: getattr(self, k) for k in (
            "n_reduce_scatter", "reduce_scatter_bytes", "n_window_exchange",
            "window_bytes", "window_bytes_remote", "n_all_reduce",
            "all_reduce_bytes", "n_all_gather", "all_gather_bytes",
            "n_permute", "permute_bytes")}

    def shard_state(self, psi, axis_name: str = None):
        return shard_state(psi, self)

    def shard_model(self, model, axis_name: str = None):
        return shard_model(model, self)

    @property
    def n_local(self) -> int:
        return len(self.local_shards)

    def row_slice(self, b: int) -> slice:
        """Rows of a padded global hi axis [D*b] that this process holds."""
        return slice(self.local_shards[0] * b, (self.local_shards[-1] + 1) * b)


class LocalMesh(_Mesh):
    """D shards held by one process on one device (`device`: where the
    entry points that take this mesh run; None is the card)."""

    def __init__(self, D: int, device=None):
        super().__init__()
        if D < 1:
            raise ValueError(f"LocalMesh needs D >= 1, got {D}")
        self.D = int(D)
        self.device = None if device is None else torch.device(device)
        self.local_shards = tuple(range(self.D))
        self.rank = 0

    def reduce_scatter_rows(self, parts):
        """Sum the shards' partials [D*b, ...] (an iterable, consumed one
        at a time so that only the running sum and one partial are alive)
        and deal the rows out: returns a handle whose wait() gives the leaf
        [D*b, ...] whose rows [d*b, (d+1)*b) are shard d's."""
        Z = None
        for part in parts:
            if Z is None:
                Z = part  # the first partial becomes the running sum
                self.n_reduce_scatter += 1
                self.reduce_scatter_bytes += (part.numel()
                                              * part.element_size())
            else:
                Z.add_(part)
        return _Done(Z)

    def exchange_windows(self, leaves, moves):
        """One zeroed window [D*b_dst, ...] per move, with the source rows
        in place: a slice and a pad of the whole leaf."""
        wins = []
        for (src, rb0, cb0, lnb, _, b_dst) in moves:
            leaf = leaves[src]
            win = leaf.new_zeros((self.D * b_dst,) + tuple(leaf.shape[1:]))
            win[cb0:cb0 + lnb] = leaf[rb0:rb0 + lnb]
            wins.append(win)
            self.window_bytes += (lnb * leaf[0].numel()
                                  * leaf.element_size())
        self.n_window_exchange += 1
        return wins

    def all_reduce_sum(self, x):
        """A sum over shards of a value already summed over this process's
        rows: nothing to add here."""
        self.n_all_reduce += 1
        self.all_reduce_bytes += x.numel() * x.element_size()
        return x

    def all_gather_rows(self, x):
        """Every shard's rows to every shard (JAX's tiled all_gather): the
        whole [D*b, ...] tensor is already here. Counts the D*(D-1) blocks
        of b rows each shard would receive."""
        self.n_all_gather += 1
        self.all_gather_bytes += (self.D - 1) * x.numel() * x.element_size()
        return x

    def permute_rows(self, x, perm):
        """JAX's ppermute: shard s's block of x [D*b, ...] becomes shard
        d's for each (s, d) in `perm`; a shard that receives nothing gets
        zeros. One gather of the blocks."""
        D = self.D
        b = x.shape[0] // D
        src = [None] * D
        for s, d in perm:
            src[d] = s
        blocks = x.reshape((D, b) + tuple(x.shape[1:]))
        if None in src:
            out = torch.zeros_like(blocks)
            for d, s in enumerate(src):
                if s is not None:
                    out[d] = blocks[s]
        else:
            out = blocks[torch.tensor(src, device=x.device)]
        self.n_permute += 1
        row_bytes = b * x[0].numel() * x.element_size()
        self.permute_bytes += row_bytes * sum(1 for s, d in perm if s != d)
        return out.reshape(x.shape)


class ProcessMesh(_Mesh):
    """One shard per rank of a torch.distributed process group (default:
    the world). torch.distributed must be initialized
    (parallel.distributed.initialize_distributed, or init_process_group)."""

    device = None  # the caller's `device=` (or its state) says where

    def __init__(self, group=None):
        super().__init__()
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "ProcessMesh needs an initialized torch.distributed process "
                "group (parallel.distributed.initialize_distributed)")
        self.group = group
        self.D = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.local_shards = (self.rank,)
        self._plans = {}

    def reduce_scatter_rows(self, parts):
        """reduce_scatter_tensor of this rank's partial [D*b, ...], started
        asynchronously: wait() gives this rank's rows [b, ...]."""
        import torch.distributed as dist

        (part,) = tuple(parts)
        part = part.contiguous()
        out = part.new_empty((part.shape[0] // self.D,)
                             + tuple(part.shape[1:]))
        work = dist.reduce_scatter_tensor(out, part, group=self.group,
                                          async_op=True)
        self.n_reduce_scatter += 1
        self.reduce_scatter_bytes += part.numel() * part.element_size()
        return _Pending(work, out, part)

    def _plan(self, moves):
        plan = self._plans.get(moves)
        if plan is None:
            plan = [[seg for seg in window_segments(mv, self.D)
                     if self.rank in seg[:2]] for mv in moves]
            self._plans[moves] = plan
        return plan

    def exchange_windows(self, leaves, moves):
        """One zeroed window [b_dst, ...] per move; the rows other ranks
        hold are received straight into it (batched isend/irecv over the
        static row ranges of `window_segments`), this rank's own rows are
        copied."""
        import torch.distributed as dist

        wins, ops = [], []
        for (src, _, _, _, _, b_dst), segs in zip(moves, self._plan(moves)):
            leaf = leaves[src]
            win = leaf.new_zeros((b_dst,) + tuple(leaf.shape[1:]))
            row_bytes = leaf[0].numel() * leaf.element_size()
            for (s, r, a, c, n) in segs:
                if s == r:
                    win[c:c + n] = leaf[a:a + n]
                elif s == self.rank:
                    ops.append(dist.P2POp(dist.isend, leaf[a:a + n],
                                          self._global_rank(r),
                                          group=self.group))
                else:
                    ops.append(dist.P2POp(dist.irecv, win[c:c + n],
                                          self._global_rank(s),
                                          group=self.group))
                    self.window_bytes_remote += n * row_bytes
                if r == self.rank:
                    self.window_bytes += n * row_bytes
            wins.append(win)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        self.n_window_exchange += 1
        return wins

    def _global_rank(self, r: int) -> int:
        import torch.distributed as dist

        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)

    def all_reduce_sum(self, x):
        import torch.distributed as dist

        x = x.clone()
        dist.all_reduce(_real(x), group=self.group)
        self.n_all_reduce += 1
        self.all_reduce_bytes += x.numel() * x.element_size()
        return x

    def all_gather_rows(self, x):
        """This rank's rows [b, ...] gathered from every rank into the
        whole [D*b, ...] (all_gather_into_tensor)."""
        import torch.distributed as dist

        x = x.contiguous()
        out = x.new_empty((self.D * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(_real(out), _real(x), group=self.group)
        self.n_all_gather += 1
        self.all_gather_bytes += (self.D - 1) * x.numel() * x.element_size()
        return out

    def permute_rows(self, x, perm):
        """JAX's ppermute: this rank's block x [b, ...] goes to d for its
        (rank, d) in `perm`, and the block of s for (s, rank) comes back
        (zeros when none does); batched isend/irecv."""
        import torch.distributed as dist

        x = x.contiguous()
        out = torch.zeros_like(x)
        ops = []
        for s, d in perm:
            if s == self.rank and d == self.rank:
                out.copy_(x)
            elif s == self.rank:
                ops.append(dist.P2POp(dist.isend, _real(x),
                                      self._global_rank(d), group=self.group))
            elif d == self.rank:
                ops.append(dist.P2POp(dist.irecv, _real(out),
                                      self._global_rank(s), group=self.group))
                self.permute_bytes += x.numel() * x.element_size()
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        self.n_permute += 1
        return out


def _real(x):
    """A complex tensor as its real view (what every backend moves)."""
    return torch.view_as_real(x) if x.is_complex() else x


def shard_state(psi, mesh, axis_name: str = ROWS):
    """Row-partition a flat state over `mesh` (JAX's shard_state): the last
    axis (the rows; a [2, N] plane pair shards each plane) zero-padded to a
    multiple of D, then this process's rows: the whole padded tensor on a
    LocalMesh (moved to the mesh's device when it names one), the rank's B
    rows on a ProcessMesh (on psi's device). `axis_name` is the JAX
    package's; the port's meshes have one axis."""
    from .sharded_apply import pad_state

    psi = pad_state(psi, mesh.D)
    rows = mesh.row_slice(psi.shape[-1] // mesh.D)
    if rows.stop - rows.start != psi.shape[-1]:
        psi = psi[..., rows].clone()  # the rank's part alone stays alive
    dev = getattr(mesh, "device", None)
    return psi if dev is None else psi.to(dev)


def shard_model(model, mesh, axis_name: str = ROWS):
    """A flat model placed on `mesh` (JAX's shard_model): padded to a
    multiple of D (sharded_apply.pad_model: pad rows have state 0,
    diagonal 0 and neighbours -1, `n_valid` keeps the logical size) and
    tagged with the mesh, so that matvec_fn, the solvers and the
    observables run it row-sharded. The port's model holds no N-sized
    array, so nothing is placed here: each module that applies it builds
    the rows of its process."""
    import dataclasses

    from .sharded_apply import pad_model

    return dataclasses.replace(pad_model(model, mesh.D), mesh=mesh)
