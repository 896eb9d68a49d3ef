"""Profiling and timing helpers (port of spindynamics_tpu/utils/profiling.py):
thin wrappers of torch.profiler, CUDA-event timers and the card's data
sheet.

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

__all__ = ["trace", "annotate", "sync_time", "event_ms", "graph_ms",
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


def annotate(name: str):
    """Named range for solver phases: the ops run inside show under `name`
    in the profiler's table and timeline (torch.profiler.record_function)."""
    return record_function(name)


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
