"""What the example modules share: the flags each takes beside its JAX
script's arguments, the device rule, the stage lines and the plot guard.

Every module runs on the card unless `--device cpu` is passed; without a
CUDA device the card is a usage error, never a fallback. It writes only
under `--out-dir` (default `build/examples/`), and only from `main`.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def parser(module_doc: str, prog: str) -> argparse.ArgumentParser:
    """An argument parser with the flags every example takes: --device,
    --dtype, --seed and --out-dir."""
    ap = argparse.ArgumentParser(
        prog=f"python -m spindynamics_tpu_torch.examples.{prog}",
        description=" ".join(module_doc.strip().split("\n\n")[0].split()))
    ap.add_argument("--device", default="cuda",
                    help="where the run goes: cuda (the card, the default) "
                         "or cpu")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                    help="the model's precision (default float32, as the "
                         "JAX script runs without x64)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random start vectors")
    ap.add_argument("--out-dir", default="build/examples", dest="out_dir",
                    help="directory of the plot and data files")
    return ap


def resolve(ap: argparse.ArgumentParser, args, kron: bool = False):
    """(device, dtype) of the parsed flags. The card without CUDA is a
    usage error. `kron`: the module's apply is K1, which takes float32
    states, so float64 on the card is refused as the CLI refuses it."""
    device = torch.device(args.device)
    dtype = DTYPES[args.dtype]
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda, but there is no CUDA device; pass "
                 "--device cpu for a CPU run")
    if kron and device.type == "cuda" and dtype != torch.float32:
        ap.error("--dtype float64 is unsupported for the sector_kron "
                 "examples on the card (K1 takes float32 states); use "
                 "--device cpu for a float64 run")
    return device, dtype


def emit(record: dict) -> None:
    """One stage line: a JSON object on stdout, flushed as the stage ends."""
    print(json.dumps(record), flush=True)


def quiet(record: dict) -> None:
    """The stage sink of run() called as a library: nothing printed."""


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def elapsed(t0: float, device) -> float:
    """Seconds since t0, after the device's queued work has finished."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def save_plot(out_dir, name: str, draw) -> None:
    """draw(plt) -> figure, saved as out_dir/name with one stage line.
    Without matplotlib the plot is skipped and a stage line says so;
    nothing else is caught."""
    try:
        import matplotlib
    except ImportError as e:
        emit({"stage": "plot", "skipped": str(e)[:200]})
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = draw(plt)
    out = Path(out_dir) / name
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    emit({"stage": "plot", "file": str(out)})


def kron_ground_state(L: int, lanc_m: int, cycles: int, target: float,
                      device, dtype, seed: int, sink):
    """The open Heisenberg chain (Jxy = Jz = 1) in the Sz=0 sector on the
    sector_kron layout and its restarted two-pass ground state
    (groundstate_kron: K1 on the card), as every kron example builds it.
    Emits the "groundstate" stage with the keys of the JAX scripts'
    groundstate lines. Returns (model, E0, psi, info, layout)."""
    import spindynamics_tpu_torch as pt

    device = pt.resolve_device(device)
    t0 = time.perf_counter()
    model = pt.xxz_chain(L, Jxy=1.0, Jz=1.0, nup=L // 2, dtype=dtype,
                         layout="sector_kron")
    E0, psi, info, lay = pt.groundstate_kron(
        model, lanc_m=lanc_m, cycles=cycles, target_residual=target,
        generator=generator(device, seed), device=device)
    sink({"stage": "groundstate", "L": L, "n_basis": lay.n_basis,
          "n_states": lay.n_states, "splits": list(lay.splits), "E0": E0,
          "E0_per_site": E0 / L, "residual": info["residual"],
          "cycles": info.get("cycles"), "polished": info.get("polished", 0),
          "lanc_m": lanc_m, "wall_s": elapsed(t0, device)})
    return model, E0, psi, info, lay
