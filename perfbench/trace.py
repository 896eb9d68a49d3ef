"""The traced slices of a window and what the readers take from them.

A `--trace 1` run runs the same window as a timed one and traces a bounded
steady slice of it: `Slice` counts the forward calls of the cell's H-apply
module (a global module forward hook) and holds torch.profiler (CPU and
CUDA activities) open from the end of apply `start` to the end of apply
`stop` of the first unit of its kind, inside a span named after the slice.
Both ends synchronize with the card, so the slice holds exactly `stop -
start` applies and the vector operations between them.

`analyze` reads a Chrome trace's event list and nothing else (copied from
the legacy benchmark's benchmark/layers.py, which later PRs may change):
per span its wall and device-busy ms, device ms by kernel (K1, dot2, the
rest) and kernel launches; the operation names with the most device time;
and the longest idle gaps, each with the innermost host operation open at
its start.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

K1 = "kron_group_kernel"
DOT2 = "dot2"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Slice:
    """Trace applies (start, stop] of the first unit run while armed."""

    def __init__(self, name: str, module_type: type, start: int, stop: int,
                 out_dir: Path):
        self.name, self.type = name, module_type
        self.start, self.stop = start, stop
        self.path = Path(out_dir) / f"{name}.json"
        self.calls = 0
        self.applies = stop - start
        self.events = None
        self._hook = self._prof = self._span = None
        self._written = False

    def arm(self) -> None:
        self._hook = torch.nn.modules.module.register_module_forward_hook(
            self._on_apply)

    def _sync(self, mod) -> None:
        dev = next((b.device for b in mod.buffers()), None)
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _on_apply(self, mod, args, out) -> None:
        if type(mod) is not self.type:
            return
        self.calls += 1
        if self.calls == self.start:
            from torch.profiler import ProfilerActivity, profile

            self._sync(mod)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.start()
            self._span = torch.profiler.record_function(self.name)
            self._span.__enter__()
        elif self.calls == self.stop:
            self._sync(mod)
            self._span.__exit__(None, None, None)
            self._prof.stop()
            # written now: a later profiler session drops this one's device
            # events; read back after the window
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._prof.export_chrome_trace(str(self.path))
            self._written, self._prof, self._span = True, None, None
            self.disarm()

    def read(self) -> None:
        """The finished slice's events, from its Chrome trace."""
        if self._written:
            self.events = json.loads(self.path.read_text())["traceEvents"]
            self._written = False

    def disarm(self) -> None:
        """Stop counting; a slice the unit did not reach the end of is
        dropped (its events stay None)."""
        if self._hook is not None:
            self._hook.remove()
            self._hook = None
        if self._prof is not None:
            self._span.__exit__(None, None, None)
            self._prof.stop()
            self._prof = self._span = None


def warm_profiler() -> None:
    """Start and stop the profiler once: its first start initializes the
    tracing library (seconds), which belongs to set-up, not to a slice."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.zeros(1).add_(1)


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def analyze(events: list, spans: tuple, n_top: int = 10,
            n_gaps: int = 10) -> dict:
    """Per span of `spans`: wall and device-busy ms, the busy share,
    device ms of K1, of dot2 and in all (`device_ms`), the count of kernel
    launches (all, K1, dot2); the `n_top` operation names with the most
    device time over all spans, and the `n_gaps` longest idle gaps (each
    with its span and the innermost host operation open at its start).
    Times in the trace are microseconds."""
    sp_ev = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e["name"] in spans]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    host = sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") == "cpu_op"), key=lambda e: e["ts"])
    per_span, gaps, by_name = {}, [], {}
    for sp in sp_ev:
        t0, t1 = sp["ts"], sp["ts"] + sp["dur"]
        mine = [e for e in dev if t0 <= e["ts"] < t1]
        ivs = _merge([[max(e["ts"], t0), min(e["ts"] + e["dur"], t1)]
                      for e in mine])
        busy = sum(e - s for s, e in ivs)
        kern = [e for e in mine if e["cat"] == "kernel"]
        per_span[sp["name"]] = {
            "wall_ms": sp["dur"] / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / sp["dur"] if sp["dur"] > 0 else 0.0,
            "device_ms": sum(e["dur"] for e in mine) / 1e3,
            "k1_ms": sum(e["dur"] for e in mine if K1 in e["name"]) / 1e3,
            "dot2_ms": sum(e["dur"] for e in mine
                           if DOT2 in e["name"]) / 1e3,
            "launches": len(kern),
            "k1_launches": sum(1 for e in kern if K1 in e["name"]),
            "dot2_launches": sum(1 for e in kern if DOT2 in e["name"])}
        for e in mine:
            n, t = by_name.get(e["name"], (0, 0.0))
            by_name[e["name"]] = (n + 1, t + e["dur"])
        edges = [t0] + [x for iv in ivs for x in iv] + [t1]
        gaps += [(edges[i + 1] - edges[i], edges[i], sp["name"])
                 for i in range(0, len(edges), 2)
                 if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda t: -t[0])
    return {"spans": per_span,
            "top_names": [{"name": n, "count": c, "ms": t / 1e3}
                          for n, (c, t) in sorted(
                              by_name.items(), key=lambda kv: -kv[1][1])
                          [:n_top]],
            "idle_gaps": [{"span": s, "ms": d / 1e3,
                           "host_op": _open_op(host, t)}
                          for d, t, s in gaps[:n_gaps]]}


def _open_op(host: list, t: float):
    """The innermost host operation running at time t, or None (the host
    was in Python between operations)."""
    best = None
    for e in host:
        if e["ts"] > t:
            break
        if e["ts"] + e["dur"] >= t and (best is None
                                         or e["dur"] < best["dur"]):
            best = e
    return None if best is None else best["name"]


def event_ms(fn, reps: int = 16, warm: int = 3) -> float:
    """Median CUDA-event time of fn() in ms, each call between two events,
    after `warm` calls (copied from benchmark/layers.py)."""
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
    times.sort()
    n = len(times)
    return float((times[(n - 1) // 2] + times[n // 2]) / 2)
