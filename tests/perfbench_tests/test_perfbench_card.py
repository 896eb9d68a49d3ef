"""The benchmark on the card, at L=16: the kernels' paths, the window and
the comparison. Marked `gpu`; it skips where there is no card. Run on the
card with `python -m pytest --noconftest tests/perfbench_tests/
test_perfbench_card.py` (the card's machine has no JAX, which
tests/conftest.py imports)."""

import pytest
import torch

from _perfbench_tree import small_tree
from perfbench import harness


@pytest.fixture
def card():
    """The card; decided when the test runs, not at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["kron_gs_kpm_L32", "compact_gs_kpm_L28"])
def test_a_cell_runs_on_the_card(name, card, tmp_path):
    root = small_tree(tmp_path, L=16)
    for trace in (False, True):
        out = harness.run(name, 3, 1.0, trace, card, root,
                          log=lambda m: None)
        assert out["correct"], out["checks"]
        assert out["device"]["platform"] == "gpu"
