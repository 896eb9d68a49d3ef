"""Profiling and timing helpers (port of spindynamics_tpu/utils/profiling.py):
thin wrappers of torch.profiler, the port's spans and counters,
CUDA-event timers and the card's data sheet.

Spans. `annotate(name)` is the port's one span primitive: a
torch.profiler.record_function range while a profiler session runs (the
benchmark's `--trace 1` slices, a user's `trace(...)`), else one shared
no-op context. The spans are events of the profiler's own session, so they
lie on the device trace's clock. Their names are dotted by layer: `apply.*`
(one per H apply, named by its route), `lanczos.*` and `kpm.*` (the
solvers' statement groups and phases), `build.*`, and `sync` around each
device-to-host read (`host_read`).

Counters. `count(name, n)` adds to one registry of plain integers, always
on: the kernels' launches (`launches.k1.<dtype>`, `launches.k1_crossw.
<dtype>`, `launches.k2.<dtype>`, `launches.k3`, `launches.dot2`,
`launches.ell.<dtype>`, read back by each kernel module's launch-count
function), `applies.<route>`, `syncs`, `lanczos.cycles`, `lanczos.polish`,
`kpm.moments`, `build.kron_tables` and `build.k1_descriptors`.
`counters()` is a copy of the registry.

The port's modules import this one inside the functions that use it, as
they import their kernels' wrappers: importing the package loads none of
the measurement helpers.

`slope_timer` is not ported: it cancels a remote accelerator's dispatch
latency by timing two chain lengths, where the card is timed with CUDA
events (torch.cuda.Event) instead. Every timer here raises when no card is
present or when it is told its work runs on the CPU: a host time is never
taken for a device time.
"""

from __future__ import annotations

import contextlib
import functools
import os
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "annotate", "host_read", "count", "counters",
           "reset_counters", "sync_time", "event_ms", "graph_ms",
           "card_info", "HBM_BYTES_PER_S", "F32_FLOPS_PER_S",
           "BF16_TC_FLOPS_PER_S"]

# NVIDIA H100 SXM data sheet: the denominators of every bound in the port
HBM_BYTES_PER_S = 3.35e12     # HBM3
F32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12  # dense bf16 on the tensor cores


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block, CPU and (where there is
    one) the card, and write it to `log_dir` as a Chrome trace
    (`trace.json`, viewable in Perfetto or chrome://tracing). Yields the
    profiler, whose `key_averages()` gives the kernel table. The card's
    work is synchronized before the trace ends, so queued kernels land in
    it."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_NO_SPAN = contextlib.nullcontext()
_COUNTERS: dict = {}


def annotate(name: str):
    """The span `name`: while a profiler session runs, a
    torch.profiler.record_function range (the operations enqueued inside
    show under `name` in its table and timeline); otherwise the shared
    no-op context, which costs one check."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _NO_SPAN


def host_read():
    """The span of one device-to-host read (`sync`, whose length is the
    host's wait for the device), counted in `syncs`."""
    count("syncs")
    return annotate("sync")


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter: {name: count}."""
    return dict(_COUNTERS)


def reset_counters(*prefixes: str) -> None:
    """Zero every counter, or those named by `prefixes` (a name, or the
    names under it: "launches.k1" zeroes "launches.k1.float32")."""
    if not prefixes:
        _COUNTERS.clear()
        return
    for name in list(_COUNTERS):
        if any(name == p or name.startswith(p + ".") for p in prefixes):
            del _COUNTERS[name]


def _require_card(device=None) -> None:
    """Raise unless a card is present and `device` (where the timed work
    runs, when given) is one."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the timers measure the card only")
    if device is not None and torch.device(device).type != "cuda":
        raise RuntimeError(f"the timed work runs on {device}, not on the card:"
                           " no host time is taken for a device time")


def sync_time(fn, device=None):
    """(fn(), seconds) on the host clock between two
    torch.cuda.synchronize() calls: the wall time of work that ends on the
    card."""
    _require_card(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps=20, warm=3, device=None):
    """Median CUDA-event time of fn() in ms (warm): `warm` calls first,
    then `reps` calls, each between two events."""
    _require_card(device)
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fn, reps=20, device=None):
    """Median CUDA-event time in ms of one replay of fn()'s launches
    captured in a CUDA graph: the device's time for them with the host's
    enqueue cost taken out (an eager loop of many short launches is paced
    by the host)."""
    _require_card(device)
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return event_ms(graph.replay, reps=reps)


@functools.lru_cache(maxsize=None)
def card_info() -> dict:
    """The card every time is taken on, read once: {"name":
    torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    "power_limit_w": the power limit in W, "smi": the line of
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` for
    card 0}."""
    _require_card()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    line = smi.stdout.strip().splitlines()[0]
    limit = line.rsplit(",", 1)[1].strip().split()[0]
    return {"name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "power_limit_w": float(limit) if limit[:1].isdigit() else None,
            "smi": line}
