"""A checkout of the benchmark cut to a small L, for the perfbench tests."""

import json
import math
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
L_SMALL = 12


def small_tree(dst: Path, L: int = L_SMALL) -> Path:
    """A checkout of the benchmark (BENCHMARK.json, perfbench/) in `dst`
    with every configuration cut to L sites (`cut`)."""
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in bench["configs"]:
        cut(dst, c["file"], L)
    return dst


def cut(root: Path, file: str, L: int) -> None:
    """The configuration root/file cut to L sites (nup = L // 2), E0_ref
    its own chain's reference ground state there."""
    from _manifest import ground_energy

    p = Path(root) / file
    cfg = json.loads(p.read_text())
    cfg["model"].update(L=L, nup=L // 2, n_basis=math.comb(L, L // 2))
    cfg["guarantees"]["E0_ref"] = ground_energy(root, cfg["model"])
    p.write_text(json.dumps(cfg))
