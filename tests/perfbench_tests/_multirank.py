"""A multi-rank cell added to a checkout as new files and entries only:
the files under multirank/ (the sector_kron layout on a ProcessMesh, a mix
of ground states alone, the per-layer metric window_exchanges_per_groundstate
with its reader and its case) and entries in BENCHMARK.json; with a fault,
the drill's layout of multirank/faults/ and a cell of its own.

The tests add it to a tree cut to L=12 and run it on gloo ranks. On C
cards, from the root of a checkout,

    python tests/perfbench_tests/_multirank.py DEST --chips C

copies the benchmark (BENCHMARK.json, perfbench/, tests/perfbench_tests/)
to DEST and adds the cell at the configuration's own L, with the drills'
cells (their names printed); then, from DEST, with the port on PYTHONPATH,
`python3 perfbench/run.py --workload kron_mesh_gs ...`.
"""

import argparse
import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
TEMPLATE = HERE / "multirank"
CELL = "kron_mesh_gs"
BASE = "heisenberg_open_L32_sz0_kron"
METRIC = "window_exchanges_per_groundstate"
DRILLS = {  # cell suffix -> the planted fault
    "raise_in_setup": {"rank": 1, "at": "setup", "how": "raise"},
    "rank1_killed": {"rank": 1, "at": "groundstate", "after": 1,
                     "how": "kill"},
    "rank0_killed": {"rank": 0, "at": "groundstate", "after": 1,
                     "how": "kill"},
}


def _new_file(src: Path, dst: Path) -> None:
    if dst.exists():
        raise FileExistsError(f"{dst} is there: the cell adds new files only")
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(src, dst)


def add_cell(root, chips: int, fault: str | None = None) -> str:
    """Add the cell (or the drill `fault` of DRILLS) to the checkout at
    `root` on `chips` ranks; returns the cell's name."""
    root = Path(root)
    if not (root / "perfbench" / "layouts" / "sector_kron_mesh.py").exists():
        for sub in ("perfbench", "tests"):
            for src in sorted((TEMPLATE / sub).rglob("*.py")):
                _new_file(src, root / src.relative_to(TEMPLATE))
        (root / "perfbench" / "traffic" / "gs_only.mesh.json").write_text(
            json.dumps({"mix": "gs_only",
                        "trace": {"groundstate": [10, 30]}}))
    name, layout = CELL, "sector_kron_mesh"
    if fault is not None:
        name, layout = f"{CELL}.{fault}", "sector_kron_mesh_fault"
        dst = root / "perfbench" / "layouts" / f"{layout}.py"
        if not dst.exists():
            _new_file(TEMPLATE / "faults" / f"{layout}.py", dst)
    b = json.loads((root / "BENCHMARK.json").read_text())
    base = next(c for c in b["configs"] if c["name"] == BASE)
    cfg = json.loads((root / base["file"]).read_text())
    cfg_name = f"{BASE}_mesh" + ("" if fault is None else f"_{fault}")
    cfg.update(name=cfg_name, deployment=f"one chain over {chips} ranks, "
               "one block of every group's rows a rank")
    cfg["model"]["layout"] = layout
    if fault is not None:
        cfg["fault"] = DRILLS[fault]
    cfg_file = f"perfbench/configs/{cfg_name}.json"
    (root / cfg_file).write_text(json.dumps(cfg, indent=1))
    b["configs"].append(dict(base, name=cfg_name, file=cfg_file,
                             why="the same chain on a ProcessMesh"))
    b["workloads"].append({
        "name": name, "config": cfg_name, "traffic": "gs_only.mesh",
        "chips": chips, "why": "ground states alone on a ProcessMesh: the "
        "block-distributed apply, its reduce-scatters and windows"})
    for m in b["end_to_end"]:
        if m["name"] == "groundstate_s":
            m["workloads"].append(name)
    if fault is None:
        b["per_layer"].append({
            "name": METRIC, "unit": "ops", "better": "lower",
            "source": "program_counter", "layer": "mesh collectives",
            "moves": "groundstate_s", "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(b, indent=2))
    return name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dest")
    ap.add_argument("--chips", type=int, default=4)
    args = ap.parse_args(argv)
    repo, dest = HERE.parents[1], Path(args.dest)
    dest.mkdir(parents=True)
    shutil.copy(repo / "BENCHMARK.json", dest / "BENCHMARK.json")
    for sub in ("perfbench", "tests/perfbench_tests"):
        shutil.copytree(repo / sub, dest / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    print(add_cell(dest, args.chips))
    for fault in DRILLS:
        print(add_cell(dest, args.chips, fault))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
