"""A cell on C > 1 cards: C processes, one per card, under one run.

The process that `run.py` starts is rank 0 on the first device. For a cell
whose `chips` is C > 1 it starts ranks 1..C-1 (the same interpreter, this
file's `serve`, the environment it has, so the same kernel caches inside
the checkout; its torch thread count) on devices 1..C-1, after the
layout's kernels are built, so that no two ranks build into one cache.
Every rank joins one torch.distributed group (NCCL on cards, gloo on the
CPU; a free localhost port; `GROUP_TIMEOUT_S`) and builds the layout's
`System` on its own device.

Rank 0 drives, the other ranks serve. The mix runs on rank 0 alone, with a
`Proxy` of rank 0's System: each method call is sent to every rank before
rank 0 makes it, so all ranks run the same calls in the same order, and
every decision of the mix (the window's end, any draw) is rank 0's. A call
returns once each rank has synchronized its device and answered, so a
unit's wall on rank 0's clock covers every rank's part of it. Arguments
travel by value, except what an earlier call returned: a part of a result
that is not plain data (a state, a tensor) is named by the call and its
path in the result, and each rank passes its own. Once rank 0 drops such a
part, the ranks drop theirs with the next message.

No rank outlives the run: the monitor ends the run (one line naming the
rank, exit 4, no result) within a second of any rank exiting before it is
told to, and a rank dies with rank 0 (the kernel's parent-death signal, and
EOF on its pipe).
"""

from __future__ import annotations

import os
import pickle
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
import weakref
from multiprocessing.connection import Connection, wait
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 120
JOIN_S = 60
EXIT_RANK_FAILED = 4
PLAIN = (type(None), bool, int, float, complex, str, bytes, np.ndarray,
         np.generic)


def device_of(device: torch.device, rank: int) -> torch.device:
    """Rank `rank`'s device: card `rank` where rank 0 runs on a card."""
    return torch.device("cuda", rank) if device.type == "cuda" else device


def backend_of(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _put(conn: Connection, msg) -> None:
    """Send by plain pickle: a Connection's own pickler would hand a
    tensor's storage over by file descriptor."""
    conn.send_bytes(pickle.dumps(msg))


def _get(conn: Connection):
    return pickle.loads(conn.recv_bytes())


def _init_group(port: int, world: int, rank: int, device) -> None:
    from spindynamics_tpu_torch.parallel.distributed import (
        initialize_distributed)

    initialize_distributed(f"tcp://localhost:{port}", world_size=world,
                           rank=rank, backend=backend_of(device),
                           timeout_s=GROUP_TIMEOUT_S)


# ---- arguments and results across ranks -------------------------------------


class _Ref:
    """A part of an earlier call's result: (call id, path)."""

    def __init__(self, key):
        self.key = key


class _Gen:
    """A generator's state, rebuilt on the receiving rank's device."""

    def __init__(self, g: torch.Generator):
        self.state = g.get_state()


class _Tensor:
    """A tensor by value, put on the receiving rank's device where it was
    on one."""

    def __init__(self, t: torch.Tensor):
        self.value = t.detach().to("cpu", copy=True)
        self.on_device = t.device.type != "cpu"


def parts(x, path=()):
    """(path, part) of each part of `x` that is not plain data, walking
    dicts, lists and tuples."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield from parts(v, path + (k,))
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from parts(v, path + (i,))
    elif not isinstance(x, PLAIN):
        yield path, x


def _map(x, fn):
    """`x` with `fn` applied to each part that is not a dict, list or
    tuple (a named tuple comes back a tuple)."""
    if isinstance(x, dict):
        return {k: _map(v, fn) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_map(v, fn) for v in x)
    if isinstance(x, list):
        return [_map(v, fn) for v in x]
    return fn(x)


# ---- rank 0 -----------------------------------------------------------------


class Ranks:
    """Rank 0's side of a run on `world` devices: the other ranks'
    processes and pipes, the monitor, and the results they hold."""

    def __init__(self, root: Path, name: str, world: int, device, log):
        self.root, self.name, self.world = Path(root), name, world
        self.device, self.log = torch.device(device), log
        self.procs, self.conns = {}, {}
        self.closing = False
        self.group = None
        self._lock = threading.Lock()
        self._calls = 0
        self._held = {}  # id(part) -> (key, weakref)
        self._dropped = []

    # -- start, watch, stop ---------------------------------------------------

    def start(self) -> None:
        """Start ranks 1..world-1 and join the process group as rank 0."""
        port = _free_port()
        code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                "from perfbench.ranks import serve; "
                "serve(sys.argv[1:])")
        for r in range(1, self.world):
            mine, theirs = socket.socketpair()
            dev = device_of(self.device, r)
            p = subprocess.Popen(
                [sys.executable, "-c", code, str(self.root), self.name,
                 str(r), str(self.world), str(port), str(dev),
                 str(torch.get_num_threads()), str(theirs.fileno()),
                 str(os.getpid())],
                pass_fds=(theirs.fileno(),), stdin=subprocess.DEVNULL,
                stdout=2, close_fds=True)  # a rank's prints go to stderr
            theirs.close()
            self.procs[r] = p
            self.conns[r] = Connection(mine.detach())
            self.log(f"rank {r}: pid {p.pid} on {dev}")
        threading.Thread(target=self._monitor, daemon=True).start()
        _init_group(port, self.world, 0, self.device)
        self.group = dist.group.WORLD

    def _monitor(self) -> None:
        while not self.closing:
            for r, p in self.procs.items():
                rc = p.poll()
                if rc is not None and not self.closing:
                    self.fail(r, rc)
            time.sleep(0.1)

    def fail(self, rank: int, rc) -> None:
        """End the run: the other ranks killed, one line, exit 4, no
        result."""
        with self._lock:
            self.kill()
            how = (f"was killed by signal {-rc}" if isinstance(rc, int)
                   and rc < 0 else f"exited with code {rc}"
                   if isinstance(rc, int) else rc)
            print(f"perfbench: rank {rank} {how}; the run has no result",
                  file=sys.stderr, flush=True)
            os._exit(EXIT_RANK_FAILED)

    def blame(self, wait_s: float = 5.0) -> None:
        """After rank 0 raised: where another rank has exited (a collective
        fails on this side when its peer dies), end the run in its name;
        else return."""
        t_end = time.perf_counter() + wait_s
        while time.perf_counter() < t_end:
            for r, p in self.procs.items():
                if p.poll() is not None:
                    self.fail(r, p.returncode)
            time.sleep(0.1)

    def _exited(self, r: int):
        """Rank r's exit code, once its pipe has closed."""
        try:
            return self.procs[r].wait(timeout=5)
        except subprocess.TimeoutExpired:
            return "closed its pipe"

    def kill(self) -> None:
        """Kill and reap every rank still running."""
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            try:
                p.wait(timeout=JOIN_S)
            except subprocess.TimeoutExpired:
                pass

    def stop(self) -> None:
        """Tell every rank to exit and leave the group with them (NCCL's
        close waits for every rank's), then wait for them; a rank, or
        this one, still there after JOIN_S s ends the run."""
        self.closing = True
        self._send(("exit", None))
        guard = threading.Timer(JOIN_S, self._late)
        guard.daemon = True
        guard.start()
        dist.destroy_process_group()
        for r, p in self.procs.items():
            rc = p.wait()
            if rc != 0:
                self.fail(r, rc)
        guard.cancel()
        for c in self.conns.values():
            c.close()

    def _late(self) -> None:
        r = next((r for r, p in self.procs.items() if p.poll() is None), 0)
        self.fail(r, f"did not exit within {JOIN_S} s")

    # -- messages -------------------------------------------------------------

    def _send(self, msg) -> None:
        for r, c in self.conns.items():
            try:
                _put(c, msg)
            except OSError:
                self.fail(r, self._exited(r))

    def _replies(self, want: str) -> dict:
        """Each rank's next reply, which must be `want`: {rank: payload}."""
        got, by_conn = {}, {c: r for r, c in self.conns.items()}
        t_end = time.perf_counter() + GROUP_TIMEOUT_S
        while len(got) < len(self.conns):
            left = t_end - time.perf_counter()
            ready = wait([c for c, r in by_conn.items() if r not in got],
                         timeout=max(0.0, left))
            if not ready:
                r = min(set(self.conns) - set(got))
                self.fail(r, f"did not answer within {GROUP_TIMEOUT_S} s")
            for c in ready:
                r = by_conn[c]
                try:
                    kind, payload = _get(c)
                except EOFError:
                    self.fail(r, self._exited(r))
                if kind != want:
                    self.fail(r, f"answered {kind!r} for {want!r}")
                got[r] = payload
        return got

    def ready(self) -> dict:
        """Wait for every rank's set-up: {rank: its set-up's info}."""
        return self._replies("ready")

    def peaks(self) -> dict:
        """{rank: its device's max_memory_allocated}, the other ranks'."""
        self._send(("peak", self._take_dropped()))
        return self._replies("peak")

    # -- calls ----------------------------------------------------------------

    def _take_dropped(self) -> list:
        out, self._dropped = self._dropped, []
        return out

    def _encode(self, x):
        def one(v):
            held = self._held.get(id(v))
            if held is not None and held[1]() is v:
                return _Ref(held[0])
            if isinstance(v, torch.Generator):
                return _Gen(v)
            if isinstance(v, torch.Tensor):
                return _Tensor(v)
            return v
        return _map(x, one)

    def _hold(self, cid: int, out) -> None:
        for path, part in parts(out):
            if id(part) in self._held:
                continue
            key = (cid, path)
            try:
                ref = weakref.ref(part, lambda _, k=key, i=id(part):
                                  self._drop(i, k))
            except TypeError:
                continue  # a part that cannot be followed stays by value
            self._held[id(part)] = (key, ref)

    def _drop(self, i: int, key) -> None:
        self._held.pop(i, None)
        self._dropped.append(key)

    def call(self, system, method: str, args: tuple, kwargs: dict):
        """`system.method(*args, **kwargs)` on every rank; rank 0's result
        once each rank has synchronized its device and answered."""
        self._calls += 1
        cid = self._calls
        self._send(("call", (cid, method, self._encode(args),
                             self._encode(kwargs), self._take_dropped())))
        out = getattr(system, method)(*args, **kwargs)
        sync(self.device)
        self._hold(cid, out)
        self._replies("done")
        return out


class Proxy:
    """Rank 0's System as the mix and the harness see it: a method call
    runs on every rank (`Ranks.call`), any other attribute is rank 0's."""

    def __init__(self, system, ranks: Ranks):
        self._system, self._ranks = system, ranks

    def __getattr__(self, name):
        attr = getattr(self._system, name)
        if not callable(attr) or isinstance(attr, type):
            return attr
        return lambda *a, **k: self._ranks.call(self._system, name, a, k)


# ---- ranks 1..C-1 -----------------------------------------------------------


def _die_with_parent(ppid: int) -> None:
    """SIGKILL when rank 0 exits (Linux's parent-death signal)."""
    if sys.platform.startswith("linux"):
        import ctypes

        PR_SET_PDEATHSIG = 1
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG,
                                                signal.SIGKILL)
    if os.getppid() != ppid:  # rank 0 died before the signal was armed
        os._exit(1)


def serve(argv) -> None:
    """One rank r > 0: join the group, set up the cell's System on its
    device, answer "ready", run rank 0's calls until told to exit, and
    exit the process (code 0, 1 on an error, 3 with JAX loaded)."""
    root, name, rank, world, port, dev, threads, fd, ppid = argv
    rank, world, ppid = int(rank), int(world), int(ppid)
    _die_with_parent(ppid)
    conn = Connection(int(fd))
    try:
        code = _serve(Path(root), name, rank, world, int(port),
                      torch.device(dev), int(threads), conn)
    except BaseException:
        traceback.print_exc()
        code = 1
    # no interpreter teardown (a communicator's threads can hold it up)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def _serve(root, name, rank, world, port, device, threads, conn) -> int:
    from perfbench import harness, run

    torch.set_num_threads(threads)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.empty(0, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    _init_group(port, world, rank, device)
    _, _, cfg, _ = harness.cell(root, name)
    layout = harness.load(root, "layouts", cfg["model"]["layout"])
    system = layout.System(cfg, device)
    _put(conn, ("ready", system.setup()))
    held = {}

    def decode(x):
        def one(v):
            if isinstance(v, _Ref):
                return held[v.key]
            if isinstance(v, _Gen):
                g = torch.Generator(device=device)
                g.set_state(v.state)
                return g
            if isinstance(v, _Tensor):
                return v.value.to(device) if v.on_device else v.value
            return v
        return _map(x, one)

    while True:
        try:
            kind, payload = _get(conn)
        except EOFError:  # rank 0 is gone
            os._exit(1)
        if kind == "exit":
            break
        if kind == "peak":
            for key in payload:
                held.pop(key, None)
            _put(conn, ("peak", peak_bytes(device)))
            continue
        cid, method, args, kwargs, dropped = payload
        for key in dropped:
            held.pop(key, None)
        out = getattr(system, method)(*decode(args), **decode(kwargs))
        sync(device)
        for path, part in parts(out):
            held[(cid, path)] = part
        del out
        _put(conn, ("done", None))
    held.clear()
    del system
    dist.destroy_process_group()  # with rank 0's
    bad = run.loaded_banned()
    if bad:
        print(f"perfbench: rank {rank} loaded {', '.join(bad)}",
              file=sys.stderr, flush=True)
        return 3
    return 0
