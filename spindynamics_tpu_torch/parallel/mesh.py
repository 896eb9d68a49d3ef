"""The object a `mesh=` argument takes: D row shards of a kron state, held
by one process or by the ranks of a process group (the port's counterpart
of spindynamics_tpu/parallel/mesh.py and of the 1-D `jax.sharding.Mesh` the
JAX package's sharded kron path runs on).

JAX's mesh is a global view: one array, rows dealt to devices, collectives
derived by the compiler. PyTorch has no such view, so the two forms below
hold the shards explicitly, behind one interface:

  LocalMesh(D)     D shards in ONE process on ONE device. A sharded-form
                   leaf is the whole padded tensor [D*b, cmp, clp]; shard d
                   is the view of rows [d*b, (d+1)*b). Collectives are
                   tensor operations. This is what runs a D-shard apply on
                   one card (and the CPU tests): the per-shard kernels,
                   windows and seeds are the multi-GPU run's own.
  ProcessMesh()    one shard per rank of a torch.distributed process group
                   (NCCL between cards, gloo on the CPU). A leaf is the
                   rank's [b, cmp, clp] block.

Both hold a leaf as "the rows of my shards, in shard order": local shard i
(global index `local_shards[i]`) is rows [i*b, (i+1)*b) of the leaf, and
`row_slice(b)` says which rows of the padded global hi axis [D*b] those
are. Code written against that runs unchanged on either mesh.

Every collective counts its calls and bytes (`counters()`), so a test can
hold an apply to `collective_traffic_model`.

The flat ELL path's `shard_model` / `shard_state` are not ported (the
compact layout is not).
"""

from __future__ import annotations

import torch

__all__ = ["ROWS", "LocalMesh", "ProcessMesh"]

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

    def counters(self) -> dict:
        return {k: getattr(self, k) for k in (
            "n_reduce_scatter", "reduce_scatter_bytes", "n_window_exchange",
            "window_bytes", "window_bytes_remote", "n_all_reduce",
            "all_reduce_bytes")}

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
        dist.all_reduce(x, group=self.group)
        self.n_all_reduce += 1
        self.all_reduce_bytes += x.numel() * x.element_size()
        return x
