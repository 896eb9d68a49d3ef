"""The per-layer readers against a trace made by hand, each on its case
(tests/perfbench_tests/reader_cases/<metric>.py), and BENCHMARK.json
against the contract's shape: every name it gives has its file. The checks
are _manifest.py's, which a test of a tree with an added cell runs too."""

import pytest

import _manifest
from _perfbench_tree import REPO
from perfbench import harness, trace


def test_analyze_reads_the_slices():
    an = trace.analyze(_manifest.events(), ("groundstate", "row"))
    g = an["spans"]["groundstate"]
    assert (g["wall_ms"], g["busy_ms"]) == (0.1, 0.045)
    assert g["busy_share"] == pytest.approx(0.45)
    assert (g["device_ms"], g["k1_ms"], g["dot2_ms"]) == pytest.approx(
        (0.045, 0.03, 0.005))
    assert (g["launches"], g["k1_launches"], g["dot2_launches"]) == (4, 2, 1)
    assert an["spans"]["row"]["launches"] == 1
    assert an["top_names"][0]["name"].startswith("void kron_group")
    # the longest gap: groundstate 60-100 us, the host in aten::item
    assert an["idle_gaps"][0] == {"span": "groundstate", "ms": 0.04,
                                  "host_op": "aten::item"}


CASES = _manifest.case_names(REPO)


@pytest.mark.parametrize("name", CASES)
def test_reader_on_a_synthetic_trace(name):
    case = _manifest.load_case(REPO, name)
    got = harness.load(REPO, "readers", name).read(_manifest.case_ctx(case))
    if case.EXPECTED is None:
        assert got is None
    else:
        assert got == pytest.approx(case.EXPECTED)


@pytest.mark.parametrize("name", CASES)
def test_reader_finds_nothing_without_a_trace(name):
    """No trace, no probes, no counts: every reader returns None, never 0
    (a share of a roofline that was not measured is left out)."""
    ctx = _manifest.empty_ctx()
    assert harness.load(REPO, "readers", name).read(ctx) is None


def test_every_per_layer_metric_has_its_reader():
    """Each metric of the manifest has its reader and its case, each case
    has its reader, and each reader returns None without a trace."""
    _manifest.check_readers(REPO)
    assert len(CASES) >= 17
    for name in CASES:
        _manifest.check_case(REPO, name)


def test_manifest_has_the_contract_shape():
    _manifest.check_shape(REPO)


@pytest.mark.parametrize("w", [w["name"] for w in
                               _manifest.bench(REPO)["workloads"]])
def test_each_cell_finds_its_files(w):
    _manifest.check_cell(REPO, w)
