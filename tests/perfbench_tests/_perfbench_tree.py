"""A checkout of the benchmark cut to a small L, for the perfbench tests."""

import json
import math
import shutil
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
L_SMALL = 12


def small_tree(dst: Path, L: int = L_SMALL) -> Path:
    """A checkout of the benchmark (BENCHMARK.json, perfbench/) in `dst`
    with every configuration at L sites, E0_ref the reference's own."""
    from perfbench import reference

    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    H = reference.BlockChain(L, L // 2, 1.0, 1.0, "cpu")
    E0, _, _ = reference.ground_state(H, torch.Generator().manual_seed(0),
                                      tol=1e-10)
    for c in bench["configs"]:
        p = dst / c["file"]
        cfg = json.loads(p.read_text())
        cfg["model"].update(L=L, nup=L // 2, n_basis=math.comb(L, L // 2))
        cfg["guarantees"]["E0_ref"] = E0
        p.write_text(json.dumps(cfg))
    return dst
