"""Profiling helpers (port of spindynamics_tpu/utils/profiling.py): thin
wrappers of torch.profiler.

`slope_timer` is not ported: it cancels a remote accelerator's dispatch
latency by timing two chain lengths, where the card is timed with CUDA
events (torch.cuda.Event) instead.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "annotate"]


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
