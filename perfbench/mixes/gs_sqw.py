"""The ground-state and spectrum mix: a closed loop of one user who solves
for a ground state and then asks for S(q, omega) rows of it, over and
over.

A cycle is one `groundstate` unit (a restarted two-pass Lanczos solve to
the configuration's residual from a random start drawn from the unit's
seed) followed by `rows_per_groundstate` `row` units (KPM S(q, omega) of
that ground state at q = 2 pi k / L, k running through the configuration's
`sqw.q_k` from a place drawn from the seed, on its omega grid above E0). Units run back to back; none
starts once the window's seconds have passed, and the one in flight then
runs to its end and counts; a window that has run no row yet runs one. After each cycle its ground state is copied to
the host (outside every unit's wall) for the comparison.

The comparison, once the window has closed and the program's state is
freed, with the float64 reference of perfbench/reference.py:
- every ground state: `residual` ||H psi - E0 psi|| / ||psi|| of the
  program's (E0, psi) under the reference's H, to the configuration's
  residual target; `E0_gap`, |E0 - E0_ref| to the configuration's E0_tol;
  `pad`, the largest pad slot (exactly 0);
- `rows_checked` rows drawn from the seed among the window's: `row` (and
  `row_pi` for a row at q = pi), the largest |S - S_ref| over the
  reference row's peak, S_ref rebuilt from float64 moments of the
  program's psi0 in the program's window (a, b);
  `mu_max`, the largest |mu_n| of those moments (at most 1 when the window
  holds the spectrum of S^z_q psi0).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import reference


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> dict:
    """The window: units back to back until `ctx.seconds` have passed."""
    sysm, cfg, tr = ctx.system, ctx.cfg, ctx.traffic
    L = cfg["model"]["L"]
    q_k = cfg["sqw"]["q_k"]
    units, cycles = [], []
    # where in q_k the window's rows start, drawn from the seed: every run
    # does the same work, and the runs together cover every q
    n_rows = ctx.unit_seed(2 ** 32 + 1) % len(q_k)
    t_start = time.perf_counter()

    def timed(kind, fn):
        slc = ctx.slices.get(kind)
        if slc is not None and not units_of(kind):
            slc.arm()
        a0 = sysm.applies()
        _sync(ctx.device)
        t0 = time.perf_counter()
        out = fn()
        _sync(ctx.device)
        wall = time.perf_counter() - t0
        if slc is not None:
            slc.disarm()
        a1 = sysm.applies()
        units.append({"kind": kind, "wall_s": wall,
                      "applies": None if a0 is None else a1 - a0})
        return out

    def units_of(kind):
        return [u for u in units if u["kind"] == kind]

    def open_():
        # every run has a unit of each kind, whose metrics it reports (at
        # the cells' sizes the first row starts well inside the window)
        return (time.perf_counter() - t_start < ctx.seconds
                or not units_of("row"))

    i = 0
    while open_():
        gen = torch.Generator(device=ctx.device).manual_seed(
            ctx.unit_seed(i))
        i += 1
        gs = timed("groundstate", lambda: sysm.groundstate(gen))
        cyc = {"E0": gs["E0"], "rows": []}
        for _ in range(tr["rows_per_groundstate"]):
            if not open_():
                break
            q = 2.0 * math.pi * q_k[n_rows % len(q_k)] / L
            n_rows += 1
            S, a, b = timed("row", lambda: sysm.row(gs, q))
            cyc["rows"].append({"q": q, "S": np.asarray(S, np.float64),
                                "a": a, "b": b})
        cyc["psi"] = sysm.to_host(gs["psi"])
        del gs
        cycles.append(cyc)
    return {"units": units, "cycles": cycles,
            "window_s": time.perf_counter() - t_start}


def metrics(res: dict) -> dict:
    """The end-to-end times: each kind's summed walls over its units."""
    out = {}
    for kind, name in (("groundstate", "groundstate_s"), ("row", "sqw_row_s")):
        walls = [u["wall_s"] for u in res["units"] if u["kind"] == kind]
        if walls:
            out[name] = sum(walls) / len(walls)
    return out


def counts(res: dict) -> dict:
    """Applies per unit of each kind, where the program counts them."""
    out = {}
    for kind in ("groundstate", "row"):
        us = [u for u in res["units"] if u["kind"] == kind]
        if us and all(u["applies"] is not None for u in us):
            out[f"applies.{kind}"] = sum(u["applies"] for u in us) / len(us)
    return out


def row_key(q: float) -> str:
    """The row's number: `row_pi` at q = pi, where S(q, omega) peaks and
    float32 rounding shows most (section 2 of PERF.md), `row` elsewhere."""
    return "row_pi" if abs(q - math.pi) < 1e-9 else "row"


def check(ctx, res: dict, H: reference.BlockChain) -> tuple:
    """([(name, value, limit)], units refused): the window's outputs
    against the float64 reference, every ground state and the sampled
    rows."""
    cfg, g = ctx.cfg, ctx.cfg["guarantees"]
    lim = ctx.traffic["limits"]
    rows = [(ci, ri) for ci, c in enumerate(res["cycles"])
            for ri in range(len(c["rows"]))]
    rng = np.random.default_rng(ctx.unit_seed(2 ** 32))
    n_pick = min(ctx.traffic["rows_checked"], len(rows))
    picked = {rows[j] for j in rng.choice(len(rows), n_pick, replace=False)}
    lo, hi, n = cfg["sqw"]["omega"]
    omega = np.linspace(lo, hi, n)
    worst = {"residual": 0.0, "E0_gap": 0.0, "pad": 0.0}
    failed = 0
    for ci, c in enumerate(res["cycles"]):
        t0 = time.perf_counter()
        psi, pad = ctx.layout.reference_state(H, c.pop("psi"))
        t1 = time.perf_counter()
        _, residual = reference.energy(H, psi)
        r = residual(c["E0"])
        ctx.log(f"reference: ground state {ci} read {t1 - t0:.3f} s, "
                f"residual {time.perf_counter() - t1:.3f} s")
        gap = abs(c["E0"] - g["E0_ref"])
        worst["residual"] = max(worst["residual"], r)
        worst["E0_gap"] = max(worst["E0_gap"], gap)
        worst["pad"] = max(worst["pad"], pad)
        failed += not (r <= g["residual_target"] and gap <= g["E0_tol"]
                       and pad == 0.0)
        for ri, row in enumerate(c["rows"]):
            if (ci, ri) not in picked:
                continue
            t0 = time.perf_counter()
            S_ref, mu_max = reference.sqw_row(
                H, psi, row["q"], omega, c["E0"], row["a"], row["b"],
                cfg["sqw"]["kpm_m"])
            ctx.log(f"reference: row {ci}.{ri} {time.perf_counter() - t0:.3f} s")
            d = reference.row_deviation(row["S"], S_ref)
            key = row_key(row["q"])
            worst[key] = max(worst.get(key, 0.0), d)
            worst["mu_max"] = max(worst.get("mu_max", 0.0), mu_max)
            failed += not (d <= lim[key] and mu_max <= 1.0 + lim["mu"])
        del psi
    limits = {"residual": g["residual_target"], "E0_gap": g["E0_tol"],
              "pad": 0.0, "row": lim["row"], "row_pi": lim["row_pi"],
              "mu_max": 1.0 + lim["mu"]}
    return [(k, v, limits[k]) for k, v in worst.items()], failed
