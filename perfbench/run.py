"""The benchmark of spindynamics_tpu_torch on NVIDIA H100 cards.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Runs one cell of BENCHMARK.json on the card(s) of this machine: in this
process for a one-chip cell, as one process per card for a cell on C > 1
chips (this one rank 0 on card 0, perfbench/ranks.py). Set-up (the kernels
built into the checkout's build/ where they are missing, the cell's model
and apply on the card, every shape the window runs warmed once, the
traffic's own set-up such as the KPM window),
then the window, units back to back for S seconds (the one in flight when
they pass runs to its end), then the comparison with the float64
reference, the program's state freed first. `--seed` draws each unit's
random start and the rows checked, and nothing else. `--trace 1` runs the
same window and traces a bounded slice of its first units; it reports the
per-layer metrics, `--trace 0` the end-to-end ones.

The last line on standard output is one JSON object: correct, attempted,
failed, metrics, device (and breakdown with --trace 1), then checks: each
number compared with its limit, which are also the last lines on standard
error. Without a CUDA device (or with fewer than the cell asks for), or
when jax, jaxlib, flax or the JAX package are loaded once the window has
closed (in this process or in another rank), or when another rank fails,
it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "spindynamics_tpu")
TORCH_THREADS = 4  # fixed, whatever the machine's core count


def loaded_banned() -> list:
    """Loaded modules whose top-level name is a banned one, compared as a
    whole name (spindynamics_tpu_torch is not spindynamics_tpu)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def main(argv=None, device=None) -> int:
    """The run; `device` None is the card path (cuda:0, the card checks),
    a device such as "cpu" runs the port's plain versions there (the CPU
    tests)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache of this run inside the checkout, at
    # fixed paths (the port's own nvcc builds go to build/ beside it)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "perfbench_cache" / sub)
    # one thread in the OpenMP and BLAS pools that torch and numpy start on
    # import: their idle threads spin beside the one that launches and waits
    # on the card, and a ground state's per-step host reads then drift by
    # several percent for seconds at a time
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = next((w for w in bench["workloads"]
              if w["name"] == args.workload), None)
    if w is None:
        print(f"perfbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if device is None and (not torch.cuda.is_available() or (
            torch.cuda.device_count() < w["chips"])):
        print(f"perfbench: the cell needs {w['chips']} CUDA device(s), "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              "; the benchmark measures the card only", file=sys.stderr)
        return 2
    torch.set_num_threads(TORCH_THREADS)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace),
                      torch.device("cuda", 0) if device is None else device,
                      ROOT,
                      T_START)
    bad = loaded_banned()
    if bad:
        print(f"perfbench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
