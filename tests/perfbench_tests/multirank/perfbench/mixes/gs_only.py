"""Ground states alone: a closed loop of one user who solves for a ground
state (a restarted two-pass Lanczos solve to the configuration's residual
from a random start drawn from the unit's seed) over and over. Units run
back to back; none starts once the window's seconds have passed, the one in
flight then runs to its end and counts, and a window has one at least.
After each its state is copied to the host, outside every unit's wall.

Each unit also records how far the layout's `counters()` moved in it.

The comparison, once the window has closed and the program's state is
freed, with the float64 reference of perfbench/reference.py, for every
ground state: `residual`, ||H psi - E0 psi|| / ||psi|| of the program's
(E0, psi) under the reference's H, to the configuration's residual target;
`E0_gap`, |E0 - E0_ref| to its E0_tol; `pad`, the largest pad slot
(exactly 0).
"""

from __future__ import annotations

import time

import torch

from .. import reference


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> dict:
    sysm = ctx.system
    units, states = [], []
    slc = ctx.slices.get("groundstate")
    t_start = time.perf_counter()
    i = 0
    while time.perf_counter() - t_start < ctx.seconds or not units:
        gen = torch.Generator(device=ctx.device).manual_seed(
            ctx.unit_seed(i))
        if slc is not None and i == 0:
            slc.arm()
        i += 1
        c0 = sysm.counters()
        _sync(ctx.device)
        t0 = time.perf_counter()
        gs = sysm.groundstate(gen)
        _sync(ctx.device)
        wall = time.perf_counter() - t0
        if slc is not None:
            slc.disarm()
        c1 = sysm.counters()
        units.append({"kind": "groundstate", "wall_s": wall,
                      "counters": {k: c1[k] - c0[k] for k in c1}})
        states.append({"E0": gs["E0"], "psi": sysm.to_host(gs["psi"])})
        del gs
    return {"units": units, "states": states,
            "window_s": time.perf_counter() - t_start}


def metrics(res: dict) -> dict:
    walls = [u["wall_s"] for u in res["units"]]
    return {"groundstate_s": sum(walls) / len(walls)}


def counts(res: dict) -> dict:
    """Each counter's move per ground state."""
    us = res["units"]
    return {f"{k}.groundstate": sum(u["counters"][k] for u in us) / len(us)
            for k in us[0]["counters"]}


def check(ctx, res: dict, H: reference.BlockChain) -> tuple:
    g = ctx.cfg["guarantees"]
    worst = {"residual": 0.0, "E0_gap": 0.0, "pad": 0.0}
    failed = 0
    for i, s in enumerate(res["states"]):
        t0 = time.perf_counter()
        psi, pad = ctx.layout.reference_state(H, s.pop("psi"))
        _, residual = reference.energy(H, psi)
        r = residual(s["E0"])
        del psi
        ctx.log(f"reference: ground state {i} "
                f"{time.perf_counter() - t0:.3f} s")
        gap = abs(s["E0"] - g["E0_ref"])
        worst["residual"] = max(worst["residual"], r)
        worst["E0_gap"] = max(worst["E0_gap"], gap)
        worst["pad"] = max(worst["pad"], pad)
        failed += not (r <= g["residual_target"] and gap <= g["E0_tol"]
                       and pad == 0.0)
    limits = {"residual": g["residual_target"], "E0_gap": g["E0_tol"],
              "pad": 0.0}
    return [(k, v, limits[k]) for k, v in worst.items()], failed
