"""Fixtures of the perfbench tests: a copy of the benchmark's files with its
cells' configurations cut to L=12, so a whole run goes through the port's
plain (CPU) versions in seconds.

It also keeps the legacy benchmark's tests (tests/test_torch_benchmark.py)
on the manifest they were written for. The legacy harness under
benchmark/ reads its manifest from `benchmark.cells.BENCHMARK_JSON`, the
repository's root BENCHMARK.json, which now holds the perfbench benchmark;
its own manifest is kept byte for byte beside this file and the constant
points there for the test session, until the legacy harness and its tests
are retired together.
"""

from pathlib import Path

import pytest
import torch

from _perfbench_tree import small_tree
from benchmark import cells as _legacy_cells

_legacy_cells.BENCHMARK_JSON = Path(__file__).with_name(
    "legacy_BENCHMARK.json")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    return small_tree(tmp_path_factory.mktemp("bench"))
