"""The readings that a cell's limits are set from (not run by the benchmark's
own runs).

    python3 perfbench/calibrate.py --workload NAME --seeds 1 2 ... \
        --control-seeds 1 2 3 [--control bf16|tf32] [--out FILE.json]

In one process on the card, at the cell's own size: for each seed, one
ground-state unit and one row (q from the configuration's q_k in turn)
through the program as the window runs them, then, with the program's
state freed, the cell's comparison of each (the readings of sound runs);
then the control on each control seed. The reference is the
configuration's chain (harness.chain). `--control bf16`: the reference
put in the program's place with bfloat16 storage, its restarted two-pass
Lanczos (residual and E0 against the configuration) and its KPM row from
the program's ground state of that seed with every T_n phi stored in
bfloat16, against the float64 row. `--control tf32`: the program itself
with TF32 matrix products switched on (torch.backends...allow_tf32), its
units judged as the sound runs' are. Prints one JSON object and writes
it to --out.
"""

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", choices=("bf16", "tf32"), default="bf16",
                    help="bf16: the reference with bfloat16 storage; tf32: "
                    "the program with TF32 matrix products switched on")
    ap.add_argument("--rows-only", action="store_true",
                    help="bf16 control: its rows alone, no Lanczos")
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from perfbench import harness, reference
    from perfbench.mixes import gs_sqw

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    dev = torch.device(args.device)
    _, w, cfg, traffic = harness.cell(ROOT, args.workload)
    layout = harness.load(ROOT, "layouts", cfg["model"]["layout"])
    make_H = harness.chain(ROOT, cfg["model"])
    mo, g = cfg["model"], cfg["guarantees"]
    q_k = cfg["sqw"]["q_k"]
    lo, hi, n = cfg["sqw"]["omega"]
    omega = np.linspace(lo, hi, n)
    system = layout.System(cfg, dev)
    t0 = time.perf_counter()
    system.setup()
    out = {"workload": args.workload, "setup_s": time.perf_counter() - t0,
           "sound": [], "control": []}
    runs = []
    tf32 = [(s, False) for s in args.seeds]
    if args.control == "tf32":
        tf32 += [(s, True) for s in args.control_seeds]
    for i, (seed, tf) in enumerate(tf32):
        torch.backends.cuda.matmul.allow_tf32 = tf
        torch.backends.cudnn.allow_tf32 = tf
        us = harness.unit_seeds(seed)
        gen = torch.Generator(device=dev).manual_seed(us(0))
        t0 = time.perf_counter()
        gs = system.groundstate(gen)
        t_gs = time.perf_counter() - t0
        q = 2 * math.pi * q_k[i % len(q_k)] / mo["L"]
        t0 = time.perf_counter()
        S, a, b = system.row(gs, q)
        t_row = time.perf_counter() - t0
        runs.append({"seed": seed, "tf32": tf, "E0": gs["E0"], "q": q,
                     "S": S, "a": a,
                     "b": b, "psi": system.to_host(gs["psi"]),
                     "groundstate_s": t_gs, "row_s": t_row,
                     "solver_residual": float(gs["info"]["residual"])})
        del gs
    system.close()
    del system
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    H = make_H(dev)
    by_seed = {}
    for r in runs:
        t0 = time.perf_counter()
        psi, pad = layout.reference_state(H, r.pop("psi"))
        _, residual = reference.energy(H, psi)
        S_ref, mu_max = reference.sqw_row(H, psi, r["q"], omega, r["E0"],
                                          r["a"], r["b"], cfg["sqw"]["kpm_m"])
        rec = {k: r[k] for k in ("seed", "E0", "q", "groundstate_s", "row_s",
                                 "solver_residual", "tf32")}
        rec.update({"residual": residual(r["E0"]),
                    "E0_gap": abs(r["E0"] - g["E0_ref"]), "pad": pad,
                    gs_sqw.row_key(r["q"]): reference.row_deviation(
                        r["S"], S_ref),
                    "mu_max": mu_max,
                    "reference_s": time.perf_counter() - t0})
        out["control" if rec.pop("tf32") else "sound"].append(rec)
        print(json.dumps(rec), file=sys.stderr, flush=True)
        if args.control == "bf16" and r["seed"] in args.control_seeds:
            by_seed[r["seed"]] = (psi, r)
        else:
            del psi
    for seed in args.control_seeds if args.control == "bf16" else []:
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(
            harness.unit_seeds(seed)(0))
        gst = cfg["groundstate"]
        rec = {"seed": seed}
        if not args.rows_only:
            E_c, _, r_c = reference.ground_state(
                H, gen, m=gst["lanc_m"], cycles=gst["cycles"],
                tol=gst["target_residual"], store=torch.bfloat16)
            rec.update(residual=r_c, E0_gap=abs(E_c - g["E0_ref"]))
        if seed in by_seed:
            psi, r = by_seed.pop(seed)
            S64, _ = reference.sqw_row(H, psi, r["q"], omega, r["E0"],
                                       r["a"], r["b"], cfg["sqw"]["kpm_m"])
            S16, mu16 = reference.sqw_row(
                H, psi, r["q"], omega, r["E0"], r["a"], r["b"],
                cfg["sqw"]["kpm_m"], store=torch.bfloat16)
            rec.update({gs_sqw.row_key(r["q"]): reference.row_deviation(
                S16, S64), "q": r["q"], "mu_max": mu16})
            del psi
        rec["control_s"] = time.perf_counter() - t0
        out["control"].append(rec)
        print(json.dumps(rec), file=sys.stderr, flush=True)
    for key in ("residual", "E0_gap", "row", "row_pi", "mu_max"):
        got = [r[key] for r in out["sound"] if key in r]
        if got:
            out[f"sound_max.{key}"] = max(got)
        got = [r[key] for r in out["control"] if key in r]
        if got:
            out[f"control_min.{key}"] = min(got)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("sound", "control")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
