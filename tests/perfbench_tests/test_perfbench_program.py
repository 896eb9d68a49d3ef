"""The readers of the program's own spans (perfbench/readers/_program.py)
against a slice made by hand: kernels and a copy, their launch events with
correlation ids, nested program spans, idle gaps inside an apply span and
inside a solver span, an operation without its launch event, a gap that
began between program spans and the slice's two edges."""

from types import SimpleNamespace

import pytest

from _perfbench_tree import REPO
from perfbench import harness
from perfbench.readers import _program


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _groundstate():
    """A 100 us slice of two applies; the program's spans run 0.5-97 us.
    Device busy 12-55, 60-68, 78-83, 90-95, 96-98 and 101-103 us (an add
    enqueued at 92 whose device time the profiler drew past the slice's
    end); idle 0-12 (an edge: before the first span), 55-60 (in
    lanczos.beta), 68-78 (between spans: unbooked), 83-90 and 95-96 (in
    apply.k1), 98-101 (an edge: after the last span)."""
    return [
        _x("user_annotation", "groundstate", 0, 100),
        _x("user_annotation", "lanczos.cycle", 0.5, 59.5),
        _x("user_annotation", "lanczos.alpha", 1, 9),
        _x("user_annotation", "apply.k1", 10, 30),
        _x("user_annotation", "lanczos.orth", 40, 10),
        _x("user_annotation", "lanczos.beta", 50, 16),
        _x("user_annotation", "apply.k1", 75, 22),
        _x("cpu_op", "aten::mul", 41, 3),
        _x("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=1),
        _x("cuda_driver", "cuLaunchKernel", 12, 1, corr=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 14, 1, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 42, 1, corr=4),
        _x("cuda_runtime", "cudaLaunchKernel", 58, 1, corr=5),
        _x("cuda_runtime", "cudaLaunchKernel", 76, 1, corr=6),
        _x("cuda_runtime", "cudaLaunchKernel", 85, 1, corr=7),
        _x("cuda_runtime", "cudaLaunchKernel", 92, 1, corr=9),
        _x("cuda_runtime", "cudaLaunchKernel", 120, 1, corr=10),
        _x("kernel", "dot2_kernel", 12, 8, corr=1),
        _x("kernel", "kron_group_kernel", 20, 25, corr=2),
        _x("gpu_memcpy", "Memcpy DtoD", 45, 5, corr=3),
        _x("kernel", "mul_kernel", 50, 5, corr=4),
        _x("kernel", "norm_kernel", 60, 8, corr=5),
        _x("kernel", "add_kernel", 78, 5, corr=6),
        _x("kernel", "add_kernel", 90, 5, corr=7),
        _x("kernel", "lost_kernel", 96, 2, corr=99),  # no launch event
        _x("kernel", "add_kernel", 101, 2, corr=9),  # drawn past the end
        _x("kernel", "late", 150, 5, corr=8),  # after the slice
        _x("kernel", "next", 98.5, 1, corr=10),  # enqueued after it
    ]


def _row_without_spans():
    """A row slice of a program that names nothing (the parent commit)."""
    return [_x("user_annotation", "row", 0, 50),
            _x("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
            _x("kernel", "add_kernel", 10, 20, corr=1)]


def _ctx(row=None):
    return SimpleNamespace(slices={
        "groundstate": SimpleNamespace(applies=2, events=_groundstate()),
        "row": SimpleNamespace(applies=4, events=row or _row_without_spans())
    }, log=lambda msg: None)


def test_book_splits_device_time_and_gaps_by_the_open_span():
    b = _program.book(_groundstate(), "groundstate")
    assert b["device_ms"] == pytest.approx(0.065)
    assert b["device"] == pytest.approx({"lanczos.alpha": 0.008,
                                         "apply.k1": 0.042,
                                         "lanczos.orth": 0.005,
                                         "lanczos.beta": 0.008})
    assert (b["unbooked_ops"], b["unbooked_device_ms"]) == (
        1, pytest.approx(0.002))
    assert b["idle_ms"] == pytest.approx(0.038)
    assert b["idle"] == pytest.approx({"lanczos.beta": 0.005,
                                       "apply.k1": 0.008})
    assert (b["unbooked_gaps"], b["unbooked_idle_ms"]) == (
        1, pytest.approx(0.010))
    assert (b["edge_gaps"], b["edge_idle_ms"]) == (2, pytest.approx(0.015))


def test_a_gap_inside_a_phase_is_booked_to_the_phase():
    ev = _groundstate() + [_x("user_annotation", "lanczos.pass1", 0.5, 96)]
    b = _program.book(ev, "groundstate")
    assert b["idle"]["lanczos.pass1"] == pytest.approx(0.010)
    assert b["unbooked_gaps"] == 0


def test_device_times_drawn_onto_the_host_clock():
    """Device timestamps stretched by 1.2 from 2 us on: the gap that began
    at 45 us on the host (in lanczos.orth) reads 53.6 us on the device
    clock (in apply.k1). The anchors, the first kernel's launch and the
    closing synchronize, draw it back."""
    def gpu(t):
        return 2 + (t - 2) * 1.2

    ev = [_x("user_annotation", "groundstate", 0, 100),
          _x("user_annotation", "lanczos.orth", 0.5, 49.5),
          _x("user_annotation", "apply.k1", 50, 40),
          _x("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
          _x("cuda_runtime", "cudaLaunchKernel", 55, 1, corr=2),
          _x("cuda_runtime", "cudaDeviceSynchronize", 90.2, 0.3),
          _x("kernel", "mul_kernel", gpu(2), gpu(45) - gpu(2), corr=1),
          _x("kernel", "kron_group_kernel", gpu(56), gpu(90) - gpu(56),
             corr=2)]
    b = _program.book(ev, "groundstate")
    assert set(b["idle"]) == {"lanczos.orth"}
    assert b["idle"]["lanczos.orth"] == pytest.approx(0.011, rel=0.02)
    assert b["device_ms"] == pytest.approx(1.2 * (0.043 + 0.034))
    # without the synchronize the device clock is taken as it is
    b = _program.book(ev[:5] + ev[6:], "groundstate")
    assert set(b["idle"]) == {"apply.k1"}


def test_a_kernel_in_a_sync_span_is_neither_apply_nor_solver():
    ev = _groundstate() + [_x("user_annotation", "sync", 2, 0.5)]
    b = _program.book(ev, "groundstate")
    assert b["device"]["sync"] == pytest.approx(0.008)
    assert "lanczos.alpha" not in b["device"]


EXPECTED = {
    "apply_ms_per_apply.gs": 0.042 / 2,
    "solver_ms_per_apply.gs": (0.008 + 0.005 + 0.008) / 2,
    "apply_idle_ms_per_apply.gs": 0.008 / 2,
    "solver_idle_ms_per_apply.gs": 0.005 / 2,
    "apply_ms_per_apply.sqw": None,  # the row slice names no span
    "solver_ms_per_apply.sqw": None,
}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_slice_with_program_spans(name):
    got = harness.load(REPO, "readers", name).read(_ctx())
    if EXPECTED[name] is None:
        assert got is None
    else:
        assert got == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_finds_nothing_without_raw_events(name):
    """The harness's context of a slice without its raw events (the
    synthetic context of test_perfbench_readers.py), and one with no
    slices at all: None, never 0."""
    ctx = SimpleNamespace(trace=None, counts={}, probes={}, slices={
        k: SimpleNamespace(applies=n)
        for k, n in (("groundstate", 20), ("row", 10))})
    assert harness.load(REPO, "readers", name).read(ctx) is None
    ctx = SimpleNamespace(trace=None, slices={}, counts={}, probes={})
    assert harness.load(REPO, "readers", name).read(ctx) is None


def test_row_readers_book_the_row_slice():
    row = [_x("user_annotation", "row", 0, 50),
           _x("user_annotation", "kpm.rescale", 0, 5),
           _x("user_annotation", "apply.ell", 5, 20),
           _x("user_annotation", "kpm.recur", 25, 5),
           _x("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
           _x("cuda_runtime", "cudaLaunchKernel", 6, 1, corr=2),
           _x("cuda_runtime", "cudaLaunchKernel", 26, 1, corr=3),
           _x("kernel", "sub_kernel", 2, 3, corr=1),
           _x("kernel", "gather_kernel", 7, 18, corr=2),
           _x("kernel", "add_kernel", 27, 3, corr=3)]
    ctx = _ctx(row)
    read = {n: harness.load(REPO, "readers", n).read(ctx)
            for n in ("apply_ms_per_apply.sqw", "solver_ms_per_apply.sqw")}
    assert read == pytest.approx({"apply_ms_per_apply.sqw": 0.018 / 4,
                                  "solver_ms_per_apply.sqw": 0.006 / 4})


def test_no_device_operation_reads_none():
    """A CPU run: the spans are there, the device operations are not."""
    ev = [e for e in _groundstate()
          if e["cat"] not in ("kernel", "gpu_memcpy")]
    assert _program.book(ev, "groundstate") is None
    ctx = SimpleNamespace(slices={"groundstate": SimpleNamespace(
        applies=2, events=ev)})
    assert _program.per_apply(ctx, "groundstate", "device",
                              _program.APPLY) is None


def test_booked_once_and_logged():
    logged = []
    ctx = _ctx()
    ctx.log = logged.append
    first = _program.booked(ctx, "groundstate")
    assert _program.booked(ctx, "groundstate") is first
    assert len(logged) == 1 and logged[0].startswith(
        "program spans, groundstate slice: ")
    assert _program.booked(ctx, "row") is None and len(logged) == 1
