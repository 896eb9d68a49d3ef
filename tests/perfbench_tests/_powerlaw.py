"""The power-law XY chain's cell added to a checkout as new files and
entries only: the files under powerlaw/ (its float64 reference chain
perfbench/chains/powerlaw_xy.py, the layout sector_kron_powerlaw, its
configuration and its traffic) and entries in BENCHMARK.json (the
configuration, the cell kron_lr_gs_kpm_L30 on one chip, and the cell in
the end-to-end metrics groundstate_s and sqw_row_s and in every per-layer
metric that the nearest-neighbour kron cell reports).

The tests add it to a tree cut to L=12. On the card, from the root of a
checkout,

    python tests/perfbench_tests/_powerlaw.py tree DEST

copies the benchmark (BENCHMARK.json, perfbench/, tests/perfbench_tests/)
to DEST and adds the cell as the template holds it; then, from DEST, with
the port on PYTHONPATH, `python3 perfbench/run.py --workload
kron_lr_gs_kpm_L30 ...`. And

    python tests/perfbench_tests/_powerlaw.py reference --L 30

reads the configuration's chain at L sites in float64 on the card: its
ground state (E0_ref), the top of its spectrum, and the share of the q =
pi reference row's weight that lies past each omega (omega_max). A
configuration at another L takes its E0_ref from this reading.
"""

import argparse
import json
import math
import shutil
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
TEMPLATE = HERE / "powerlaw"
CELL = "kron_lr_gs_kpm_L30"
CONFIG = "xy_powerlaw_a1.5_open_L30_sz0_kron"
CONFIG_FILE = f"perfbench/configs/{CONFIG}.json"
TRAFFIC = "gs_sqw.L30_powerlaw"
LIKE = "kron_gs_kpm_L32"  # the cell whose per-layer metrics it reports


def _new_file(src: Path, dst: Path) -> None:
    if dst.exists():
        raise FileExistsError(f"{dst} is there: the cell adds new files only")
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(src, dst)


def add_cell(root, L: int | None = None) -> str:
    """Add the cell to the checkout at `root` (its configuration cut to L
    sites, E0_ref its chain's own there, where L is given); returns the
    cell's name."""
    root = Path(root)
    for src in sorted((TEMPLATE / "perfbench").rglob("*")):
        if src.is_file() and "__pycache__" not in src.parts:
            _new_file(src, root / src.relative_to(TEMPLATE))
    if L is not None:
        from _perfbench_tree import cut

        cut(root, CONFIG_FILE, L)
    cfg = json.loads((root / CONFIG_FILE).read_text())
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({
        "name": CONFIG, "source": cfg["source"], "file": CONFIG_FILE,
        "reduced": ["model"],
        "why": "the power-law XY chain of trapped ions, alpha 1.5, L=30, "
        "Sz=0: 155,117,520 amplitudes, all 435 bonds, in the sector_kron "
        "layout, float32"})
    b["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": TRAFFIC, "chips": 1,
        "why": "L=30 ground state then 3 KPM rows (100 moments), closed "
        "loop: all-pairs hopping, K1 beside the plain-torch cross-term "
        "routes; solvers and dot2 shared with the L=32 cell"})
    for m in b["end_to_end"]:
        if m["name"] in ("groundstate_s", "sqw_row_s"):
            m["workloads"].append(CELL)
    for m in b["per_layer"]:
        if LIKE in m["workloads"]:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=2))
    return CELL


def tree(dest) -> str:
    repo, dest = HERE.parents[1], Path(dest)
    dest.mkdir(parents=True)
    shutil.copy(repo / "BENCHMARK.json", dest / "BENCHMARK.json")
    for sub in ("perfbench", "tests/perfbench_tests"):
        shutil.copytree(repo / sub, dest / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    return add_cell(dest)


def reference_readings(L: int) -> dict:
    """The configuration's chain at L sites in float64 on the card: its
    build, one apply, its ground state (restarted two-pass Lanczos, m 40,
    residual 1e-9 or 30 cycles), the top of its spectrum (one
    Lanczos cycle of -H, m 60) and the q = pi row from 100 moments over
    the whole spectrum above E0, with the share of its weight past each
    omega."""
    import numpy as np
    import torch

    sys.path.insert(0, str(HERE.parents[1]))
    from perfbench import harness, reference

    model = dict(json.loads((TEMPLATE / CONFIG_FILE).read_text())["model"],
                 L=L, nup=L // 2)
    dev = torch.device("cuda")
    out = {"L": L, "device": torch.cuda.get_device_name(dev)}
    t0 = time.perf_counter()
    H = harness.chain(TEMPLATE, model)(dev)
    torch.cuda.synchronize(dev)
    out.update(n=H.n, build_s=time.perf_counter() - t0)
    v = torch.randn(H.n, dtype=torch.float64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    H(v)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        H(v)
    torch.cuda.synchronize(dev)
    out["apply_s"] = (time.perf_counter() - t0) / 3
    del v
    print(json.dumps(out), flush=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    E0, psi, r = reference.ground_state(H, gen, m=40, cycles=30,
                                         tol=1e-9)
    torch.cuda.synchronize(dev)
    out.update(E0=E0, E0_per_site=E0 / L, residual=r,
               groundstate_s=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)

    class Neg:
        n, device = H.n, H.device

        def __call__(self, x):
            return -H(x)

    t0 = time.perf_counter()
    Emax_ritz, _, r_top = reference.ground_state(
        Neg(), torch.Generator(device=dev).manual_seed(1), m=60, cycles=1,
        tol=0.0)
    Emax = -Emax_ritz + max(r_top, 1e-3)  # a Ritz value is a lower bound
    out.update(Emax=Emax, top_residual=r_top,
               top_s=time.perf_counter() - t0)
    a, b = 1.01 * (Emax - E0) / 2, (Emax + E0) / 2
    omega = np.linspace(0.0, Emax - E0, 2001)
    t0 = time.perf_counter()
    S, mu_max = reference.sqw_row(H, psi, math.pi, omega, E0, a, b, 100)
    weight = np.concatenate([[0.0], np.cumsum(
        (S[1:] + S[:-1]) / 2 * np.diff(omega))]) / a
    past = (weight[-1] - weight) / weight[-1]
    out.update(row_s=time.perf_counter() - t0, window=[a, b],
               mu_max=mu_max, weight_total=float(weight[-1]),
               omega_99=float(omega[np.argmax(past < 0.01)]),
               past={f"{w:g}": float(np.interp(w, omega, past))
                     for w in (4, 5, 6, 7, 8, 9, 10, 12)})
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("tree").add_argument("dest")
    sub.add_parser("reference").add_argument("--L", type=int, default=30)
    args = ap.parse_args(argv)
    if args.cmd == "tree":
        print(tree(args.dest))
    else:
        reference_readings(args.L)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
