"""One run of one cell: everything the cell needs is found by name.

- the cell in BENCHMARK.json's `workloads`, its configuration's file from
  `configs`, its traffic in perfbench/traffic/<traffic>.json;
- the traffic's mix in perfbench/mixes/<mix>.py (`run`, `metrics`,
  `counts`, `check`);
- the configuration's layout in perfbench/layouts/<model.layout>.py (a
  `System`: `setup`, the units, `applies`, `to_host`, `probes`, `close`;
  and `reference_state`, a ground state in the reference's form);
- the configuration's float64 reference H (`chain`): reference.BlockChain
  for model.chain "xxz", else the `Chain` of
  perfbench/chains/<model.chain>.py;
- each per-layer metric's reader in perfbench/readers/<metric>.py
  (`read(ctx)` returns a number, or None where it finds nothing to read).

A later cell, mix, layout, chain or metric is a new file and a new entry in
BENCHMARK.json: nothing here names one. A cell on C > 1 chips runs as C
processes, one per device (perfbench/ranks.py): this one is rank 0, drives
the mix and reports; the layout's System is built on every rank, and its
`build_kernels()`, where it has one, runs here before the other ranks
start. A one-chip cell starts no process and no process group.
"""

from __future__ import annotations

import functools
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import reference
from .ranks import Proxy, Ranks, peak_bytes
from .trace import Slice, analyze, warm_profiler

ROOT = Path(__file__).resolve().parents[1]
TRACE_DIR = Path("build") / "perfbench"
GIB = 2 ** 30


def load(root: Path, sub: str, name: str):
    """The module perfbench/<sub>/<name>.py under `root`, by its path."""
    path = Path(root) / "perfbench" / sub / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {sub[:-1]} '{name}': {path} is missing")
    mod_name = f"perfbench.{sub}.{name.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(root: Path, name: str) -> tuple:
    """(manifest, workload, configuration dict, traffic dict)."""
    bench = json.loads((Path(root) / "BENCHMARK.json").read_text())
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload '{name}' in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg = json.loads((Path(root) / c["file"]).read_text())
    traffic = json.loads((Path(root) / "perfbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    return bench, w, cfg, traffic


def chain(root: Path, model: dict):
    """The configuration's float64 reference H, as a function of the
    device: the nearest-neighbour XXZ chain of reference.py for
    model["chain"] == "xxz", else `Chain(model, device)` of
    perfbench/chains/<chain>.py (loaded here, so that a missing file ends
    a run before its set-up)."""
    if model["chain"] == "xxz":
        return functools.partial(reference.BlockChain, model["L"],
                                 model["nup"], model["Jxy"], model["Jz"])
    return functools.partial(load(root, "chains", model["chain"]).Chain,
                             model)


def _applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def unit_seeds(seed: int):
    """unit i's seed: a 63-bit draw from (seed, i), for any whole seed."""
    def unit_seed(i: int) -> int:
        ss = np.random.SeedSequence([seed % 2 ** 64, i % 2 ** 64])
        return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))
    return unit_seed


def run(name: str, seed: int, seconds: float, trace: bool, device,
        root: Path = ROOT, t_start: float | None = None, log=None) -> dict:
    """One run of cell `name`: set-up, the window, the comparison; returns
    the result line's object ("checks" last). `t_start` is the process's
    start on the host clock (set-up is counted from it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    cuda = device.type == "cuda"
    bench, w, cfg, traffic = cell(root, name)
    mix = load(root, "mixes", traffic["mix"])
    layout = load(root, "layouts", cfg["model"]["layout"])
    make_H = chain(root, cfg["model"])
    if cuda:
        torch.cuda.set_device(device)
        torch.empty(0, device=device)  # the context, before its statistics
        torch.cuda.reset_peak_memory_stats(device)
    body = functools.partial(_run, name, seed, seconds, trace, device, root,
                             t_start, log, bench, cfg, traffic, mix, layout,
                             make_H)
    if w["chips"] == 1:
        return body(None)
    if cuda and hasattr(layout, "build_kernels"):
        layout.build_kernels()  # once, before any other rank loads them
    ranks = Ranks(root, name, w["chips"], device, log)
    try:
        ranks.start()
        return body(ranks)
    except Exception:
        ranks.blame()  # a rank that died first is the cause, not this one
        raise
    finally:
        ranks.kill()


def _run(name, seed, seconds, trace, device, root, t_start, log, bench,
         cfg, traffic, mix, layout, make_H, ranks) -> dict:
    """`run` from the System's set-up on: `make_H` makes the reference H on
    a device (`chain`); `ranks` are the other ranks of a cell on several
    chips, None on one."""
    cuda = device.type == "cuda"
    system = layout.System(cfg, device)
    info = system.setup()
    log(f"set-up: {json.dumps(info)}")
    if ranks is not None:
        for r, i in ranks.ready().items():
            log(f"rank {r} set-up: {json.dumps(i)}")
        system = Proxy(system, ranks)
    slices = {}
    if trace:
        warm_profiler()
        trace_dir = Path(root) / TRACE_DIR / name
        slices = {kind: Slice(kind, system.apply_type, a, b, trace_dir)
                  for kind, (a, b) in traffic["trace"].items()}
    ctx = SimpleNamespace(system=system, cfg=cfg, traffic=traffic,
                          seed=seed, seconds=seconds, device=device,
                          slices=slices, unit_seed=unit_seeds(seed), log=log,
                          rank=0, world=1 if ranks is None else ranks.world,
                          group=None if ranks is None else ranks.group)
    setup_s = time.perf_counter() - t_start
    res = mix.run(ctx)
    peak = peak_bytes(device)
    if ranks is not None:  # the fullest device's
        peaks = {0: peak, **ranks.peaks()}
        log(f"peaks by rank: {json.dumps(peaks)}")
        peak = max(peaks.values())
    log(f"window: {res['window_s']:.3f} s, units "
        f"{json.dumps([[u['kind'], u['wall_s']] for u in res['units']])}")

    values = dict(mix.metrics(res), setup_s=setup_s, peak_gib=peak / GIB)
    metrics, breakdown, dev_extra = {}, None, {}
    if trace:
        ctx.counts = mix.counts(res)
        ctx.probes = system.probes() if cuda else {}
        for s in slices.values():
            s.read()
        events = [e for s in slices.values() if s.events for e in s.events]
        ctx.trace = analyze(events, tuple(slices)) if events else None
        for m in bench["per_layer"]:
            if not _applies(m, name) or not _applies(
                    next(e for e in bench["end_to_end"]
                         if e["name"] == m["moves"]), name):
                continue
            v = load(root, "readers", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if ctx.trace is not None:
            sp = ctx.trace["spans"].values()
            dev_extra = {"busy_s": sum(s["busy_ms"] for s in sp) / 1e3,
                         "window_s": sum(s["wall_ms"] for s in sp) / 1e3}
            breakdown = {
                "device_ops": [[t["name"], t["ms"] / 1e3]
                               for t in ctx.trace["top_names"]],
                "idle_gaps": [[g["host_op"] or "python", g["ms"] / 1e3]
                              for g in ctx.trace["idle_gaps"]]}
    else:
        for m in bench["end_to_end"]:
            if _applies(m, name):
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}

    # the comparison: the program's state freed first, so the reference
    # neither shares the card with it nor sets the peak
    system.close()
    del system
    ctx.system = None
    if ranks is not None:
        ranks.stop()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ctx.layout = layout
    t0 = time.perf_counter()
    H = make_H(device)
    checks, failed = mix.check(ctx, res, H)
    log(f"comparison: {time.perf_counter() - t0:.3f} s")
    del H
    out = {"correct": failed == 0 and all(v <= lim for _, v, lim in checks),
           "attempted": len(res["units"]), "failed": failed,
           "metrics": metrics,
           "device": dict({"platform": "gpu" if cuda else "cpu",
                           "kind": torch.cuda.get_device_name(device)
                           if cuda else "cpu",
                           "count": ctx.world,
                           "memory_peak_bytes": int(peak)},
                          **dev_extra)}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return out
