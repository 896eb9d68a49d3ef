"""A cell on several ranks, added to a tree cut to L=12 as new files and
entries only (_multirank.py), run on gloo ranks on the CPU through
run.py's entry: the manifest's checks hold for the tree, the run is
correct against the reference and reports every rank, and a rank that
fails ends the run with no result and no process left behind."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest

import _manifest
import _multirank
from _perfbench_tree import REPO, small_tree
from perfbench import ranks as ranks_mod

# run.py's entry on the CPU, one torch thread a rank (the ranks take rank
# 0's count): the tests share the machine's cores
ENTRY = ("import sys; sys.path.insert(0, '.'); from perfbench import run; "
         "run.TORCH_THREADS = 1; "
         "sys.exit(run.main(sys.argv[1:], device='cpu'))")
LIMIT_S = 150  # one run's, set-up and a failing rank's 60 s included


def _tree(tmp_path, chips, fault=None):
    root = small_tree(tmp_path / "tree")
    shutil.copytree(REPO / _manifest.CASES, root / _manifest.CASES)
    return root, _multirank.add_cell(root, chips, fault)


def _run(root, workload, trace=0, seconds=0.5):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", ENTRY, "--workload", workload, "--seed",
         str(2 ** 31 + 77), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=root, env=env, capture_output=True, text=True,
        timeout=LIMIT_S)
    return res, time.perf_counter() - t0


def _pids(stderr: str) -> dict:
    return {int(r): int(p) for r, p in
            re.findall(r"^rank (\d+): pid (\d+) on ", stderr, re.M)}


def _gone(pids, wait_s=10.0) -> bool:
    t_end = time.perf_counter() + wait_s
    while True:
        alive = []
        for p in pids:
            try:
                os.kill(p, 0)
                alive.append(p)
            except ProcessLookupError:
                pass
        if not alive or time.perf_counter() > t_end:
            return not alive
        time.sleep(0.2)


def test_a_multirank_cell_added_as_files(tmp_path):
    root, name = _tree(tmp_path, 4)
    _manifest.check_all(root)  # the manifest's checks hold for the tree
    b = _manifest.bench(root)
    assert {w["name"]: w["chips"] for w in b["workloads"]}[name] == 4

    res, _ = _run(root, name)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["attempted"] >= 1
    assert set(out["metrics"]) == {"groundstate_s", "peak_gib", "setup_s"}
    assert out["device"]["count"] == 4
    peaks = json.loads(re.search(r"^peaks by rank: (.*)$", res.stderr,
                                 re.M).group(1))
    assert sorted(peaks) == ["0", "1", "2", "3"]
    top = max(peaks.values())
    assert out["device"]["memory_peak_bytes"] == top
    assert out["metrics"]["peak_gib"]["value"] == top / 2 ** 30
    pids = _pids(res.stderr)
    assert sorted(pids) == [1, 2, 3] and _gone(pids.values(), 0)

    res, _ = _run(root, name, trace=1)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert set(out["metrics"]) == {_multirank.METRIC}
    assert out["metrics"][_multirank.METRIC]["value"] > 0
    assert _gone(_pids(res.stderr).values(), 0)


@pytest.mark.parametrize("fault", sorted(_multirank.DRILLS))
def test_a_failing_rank_ends_the_run(fault, tmp_path):
    """A rank that raises in set-up, or is killed in the window: one line
    naming it, a non-zero exit, no result, no rank left. Rank 0 killed:
    the other ranks die with it."""
    root, name = _tree(tmp_path, 2, fault)
    res, wall = _run(root, name, seconds=5.0)
    assert res.returncode != 0
    assert not any(ln.startswith("{") for ln in res.stdout.splitlines())
    assert wall < 60 + ranks_mod.GROUP_TIMEOUT_S
    pids = _pids(res.stderr)
    assert list(pids) == [1]
    f = _multirank.DRILLS[fault]
    if f["rank"] == 0:
        assert res.returncode == -9
    else:
        assert res.returncode == ranks_mod.EXIT_RANK_FAILED
        last = res.stderr.strip().splitlines()[-1]
        assert last.startswith(f"perfbench: rank {f['rank']} ")
        assert ("killed by signal 9" if f["how"] == "kill"
                else "exited with code 1") in last
    assert _gone(pids.values())
