"""What the readers of the program's own spans share: a traced slice's
device time and idle gaps booked to the program span that was open on the
host at the time.

The port names its work with spans (spindynamics_tpu_torch/utils/
profiling.py `annotate`, record_function ranges while the profiler runs):
`apply.*` around each H apply, `lanczos.*` and `kpm.*` around the solvers'
statement groups and phases, `build.*`, and `sync` around each
device-to-host read.

- A device operation (kernel, copy or set) of the slice is one enqueued
  inside it: the time of its `cuda_runtime` or `cuda_driver` event, found
  by the `correlation` arg (K1 and dot2 launch through ctypes, with no
  aten op around them), lies in the slice's span. It is booked to the
  innermost program span open on the host then.
- An idle gap (the device between the slice's start and its operations'
  end with none of them running) is booked to the innermost program span
  open on the host when the gap began. A gap that began before the
  slice's first program span or after its last is the slice's edge, the
  harness's and not the program's: the profiler's start, and its closing
  synchronize while the device works off the last apply.

The host clock decides both. The profiler's device timestamps drift from
it within a session, by up to 2% of a slice's wall in either direction
(on an H100, the last kernels of an L=32 slice drawn 21.7 ms past the
synchronize that ended it): a window cut by device time drops them, and
a gap's start read on the device clock lands in the wrong span. So the
device times are mapped onto the host clock through two anchors: the
slice's first operation starts when it is enqueued (the slice opens on an
idle device), and its last ends when the slice's closing
`cudaDeviceSynchronize` returns; without that synchronize they are taken
as they are.

What cannot be booked (an operation without its launch event, a gap that
began between program spans) stays unbooked; `book` reports it beside the
edges, and `booked` logs it.
"""

from __future__ import annotations

import json
from bisect import bisect_right

from perfbench.trace import DEVICE_CATS, _merge

PROGRAM = ("apply.", "lanczos.", "kpm.", "build.")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
APPLY = ("apply.",)
SOLVER = ("lanczos.", "kpm.")


def is_program_span(name: str) -> bool:
    return name == "sync" or name.startswith(PROGRAM)


class _Spans:
    """The innermost span containing a host time (spans nest)."""

    def __init__(self, spans: list):
        self.spans = sorted(spans, key=lambda e: (e["ts"], -e["dur"]))
        self.starts = [e["ts"] for e in self.spans]
        self.reach, r = [], float("-inf")
        for e in self.spans:  # the latest end among spans[:i + 1]
            r = max(r, e["ts"] + e["dur"])
            self.reach.append(r)

    def at(self, t: float):
        i = bisect_right(self.starts, t) - 1
        while i >= 0 and self.reach[i] >= t:
            e = self.spans[i]
            if e["ts"] + e["dur"] >= t:
                return e["name"]
            i -= 1
        return None


def book(events: list, kind: str):
    """The slice `kind` of `events` booked to program spans, times in ms:
    {"device_ms", "idle_ms" (totals over the slice), "device" and "idle"
    ({span name: ms}), "unbooked_ops" (count), "unbooked_device_ms",
    "unbooked_gaps" (count), "unbooked_idle_ms", "edge_gaps" (count),
    "edge_idle_ms"}; None where the slice is missing, has no device
    operation (a CPU run) or no program span (a program without them)."""
    sl = next((e for e in events if e.get("ph") == "X"
               and e.get("cat") == "user_annotation"
               and e["name"] == kind), None)
    if sl is None:
        return None
    t0, t1 = sl["ts"], sl["ts"] + sl["dur"]
    launch = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launch.setdefault(c, e["ts"])
    # an operation without its launch event is placed by its device time
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS
           and t0 <= launch.get((e.get("args") or {}).get("correlation"),
                                e["ts"]) < t1]
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and is_program_span(e["name"])]
    if not ops or not spans:
        return None
    at = _Spans(spans).at
    to_host = _host_clock(events, ops, launch, t1)
    p0 = min(e["ts"] for e in spans)
    p1 = max(e["ts"] + e["dur"] for e in spans)
    out = {"device_ms": 0.0, "idle_ms": 0.0, "device": {}, "idle": {},
           "unbooked_ops": 0, "unbooked_device_ms": 0.0,
           "unbooked_gaps": 0, "unbooked_idle_ms": 0.0,
           "edge_gaps": 0, "edge_idle_ms": 0.0}
    for e in ops:
        ms = e["dur"] / 1e3
        out["device_ms"] += ms
        ts = launch.get((e.get("args") or {}).get("correlation"))
        name = None if ts is None else at(ts)
        if name is None:
            out["unbooked_ops"] += 1
            out["unbooked_device_ms"] += ms
        else:
            out["device"][name] = out["device"].get(name, 0.0) + ms
    ivs = _merge([[max(to_host(e["ts"]), t0), to_host(e["ts"] + e["dur"])]
                  for e in ops])
    edges = [t0] + [x for iv in ivs for x in iv] + [max(t1, ivs[-1][1])]
    for i in range(0, len(edges), 2):
        if edges[i + 1] <= edges[i]:
            continue
        ms = (edges[i + 1] - edges[i]) / 1e3
        out["idle_ms"] += ms
        name = at(edges[i])
        if name is not None:
            out["idle"][name] = out["idle"].get(name, 0.0) + ms
        elif p0 <= edges[i] <= p1:
            out["unbooked_gaps"] += 1
            out["unbooked_idle_ms"] += ms
        else:
            out["edge_gaps"] += 1
            out["edge_idle_ms"] += ms
    return out


def _host_clock(events, ops, launch, t1):
    """The map of the slice's device times onto the host clock: linear,
    the first operation's start onto its launch, the last operation's end
    onto the end of the last `cudaDeviceSynchronize` that returned inside
    the slice (ending before `t1`); the identity without one."""
    sync = [e["ts"] + e["dur"] for e in events if e.get("ph") == "X"
            and e.get("cat") == "cuda_runtime"
            and e["name"] == "cudaDeviceSynchronize"
            and e["ts"] + e["dur"] <= t1]
    first = min(ops, key=lambda e: e["ts"])
    g0 = first["ts"]
    h0 = launch.get((first.get("args") or {}).get("correlation"), g0)
    g1 = max(e["ts"] + e["dur"] for e in ops)
    if not sync or g1 <= g0 or max(sync) <= h0:
        return lambda t: t
    rate = (max(sync) - h0) / (g1 - g0)
    return lambda t: h0 + (t - g0) * rate


def booked(ctx, kind: str):
    """(book of the traced slice `kind`, its applies), computed once per
    run and logged; None where the slice has no raw events or `book`
    finds nothing to book."""
    cache = ctx.__dict__.setdefault("_program_books", {})
    if kind not in cache:
        slc = ctx.slices.get(kind)
        events = getattr(slc, "events", None)
        b = None if not events else book(events, kind)
        cache[kind] = None if b is None else (b, slc.applies)
        log = getattr(ctx, "log", None)
        if b is not None and log is not None:
            log(f"program spans, {kind} slice: " + json.dumps(b))
    return cache[kind]


def per_apply(ctx, kind: str, what: str, prefixes: tuple):
    """ms per apply of the slice `kind`'s `what` ("device" or "idle")
    booked to spans whose names start with one of `prefixes`, or None."""
    got = booked(ctx, kind)
    if got is None:
        return None
    b, n = got
    return sum(ms for name, ms in b[what].items()
               if name.startswith(prefixes)) / n
