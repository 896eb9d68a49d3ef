"""The port's spans and counters (spindynamics_tpu_torch/utils/profiling.py):
`annotate` costs nothing without a profiler; under one, a kron ground state
and a compact KPM row name their work with one `apply.*` span per apply
and the solvers' statement groups, every operation of a steady loop inside
exactly one leaf span; the counters count applies by route, table builds
per solve and kernel launches through one registry."""

import json
import math

import numpy as np
import pytest
import torch

import spindynamics_tpu_torch as pt
from spindynamics_tpu_torch import bench
from spindynamics_tpu_torch.ops import cheb_term as ct
from spindynamics_tpu_torch.ops import dot2 as d2
from spindynamics_tpu_torch.ops import fused_matvec as fm
from spindynamics_tpu_torch.ops import kron_group as kg
from spindynamics_tpu_torch.utils import profiling

L = 12
# spans that enclose other spans: the phases of a solve
PHASES = {"lanczos.cycle", "lanczos.pass1", "lanczos.pass2",
          "lanczos.tridiag", "lanczos.finalize", "lanczos.polish",
          "kpm.bounds", "kpm.phi", "kpm.moments", "kpm.reconstruct",
          "build.kron_hamiltonian"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _is_program(name):
    return name == "sync" or name.startswith(("apply.", "lanczos.", "kpm.",
                                              "build."))


class _Forwards:
    """Forward calls of the modules of `types`, by type name."""

    def __init__(self, *types):
        self.types, self.n = types, {}

    def __enter__(self):
        self._h = torch.nn.modules.module.register_module_forward_hook(
            self._on)
        return self

    def _on(self, mod, args, out):
        if type(mod) in self.types:
            k = type(mod).__name__
            self.n[k] = self.n.get(k, 0) + 1

    def __exit__(self, *exc):
        self._h.remove()


def _traced(tmp_path, fn):
    """(fn()'s result, the trace's X events) under utils.profiling.trace."""
    with profiling.trace(str(tmp_path)):
        out = fn()
    ev = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    return out, [e for e in ev if e.get("ph") == "X"]


def _spans(events):
    return [e for e in events if e.get("cat") == "user_annotation"]


def _steady_ops_outside_leaves(events, start=10, stop=30):
    """The host operations that start between the end of apply span
    `start` and the start of apply span `stop` (a steady stretch of the
    solve) outside every leaf span."""
    spans = _spans(events)
    applies = sorted((e for e in spans if e["name"].startswith("apply.")),
                     key=lambda e: e["ts"])
    t0 = applies[start - 1]["ts"] + applies[start - 1]["dur"]
    t1 = applies[stop - 1]["ts"]
    leaves = [e for e in spans if _is_program(e["name"])
              and e["name"] not in PHASES]
    return [e["name"] for e in events if e.get("cat") == "cpu_op"
            and t0 <= e["ts"] < t1
            and not any(s["ts"] <= e["ts"]
                        and e["ts"] + e["dur"] <= s["ts"] + s["dur"]
                        for s in leaves)]


def _leaves_around_applies(events):
    """Leaf spans that enclose an apply span. A profiler session stopped
    from an apply's forward hook (the benchmark's slices) must find no
    leaf open: a span still open at the stop is cut from the trace."""
    spans = _spans(events)
    leaves = [e for e in spans if _is_program(e["name"])
              and e["name"] not in PHASES
              and not e["name"].startswith("apply.")]
    return sorted({s["name"] for a in spans if a["name"].startswith("apply.")
                   for s in leaves if s["ts"] <= a["ts"]
                   and a["ts"] + a["dur"] <= s["ts"] + s["dur"]})


def test_annotate_without_a_profiler_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError("record_function called without a profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    a, b = profiling.annotate("apply.k1"), profiling.annotate("kpm.dots")
    assert a is b is profiling._NO_SPAN
    with a:
        pass


def test_annotate_under_a_profiler_is_a_span(tmp_path):
    def work():
        with profiling.annotate("lanczos.alpha"):
            torch.ones(4).sum()

    _, ev = _traced(tmp_path, work)
    assert [e["name"] for e in _spans(ev)] == ["lanczos.alpha"]


def test_kron_groundstate_spans_and_counters(tmp_path):
    m = pt.xxz_chain(L, nup=L // 2, dtype=torch.float32,
                     layout="sector_kron")
    profiling.reset_counters()
    with _Forwards(kg.KronHamiltonian) as fw:
        (E0, psi, info, _), ev = _traced(tmp_path, lambda: pt.groundstate_kron(
            m, lanc_m=40, cycles=2, target_residual=None, device="cpu",
            generator=torch.Generator().manual_seed(0)))
    c = profiling.counters()
    names = [e["name"] for e in _spans(ev)]
    n_apply = sum(1 for n in names if n.startswith("apply."))
    # one apply span per forward call, counted by its route
    assert n_apply == fw.n["KronHamiltonian"] == (
        c["applies.k1"] + c["applies.groups"])
    assert c["applies.k1"] == names.count("apply.k1") == 2 * 2 * 40
    assert c["applies.groups"] == names.count("apply.groups") == 2 * 8
    assert {"groundstate", "row"}.isdisjoint(names)
    for n in ("lanczos.cycle", "lanczos.pass1", "lanczos.tridiag",
              "lanczos.pass2", "lanczos.finalize", "lanczos.alpha",
              "lanczos.orth", "lanczos.beta", "lanczos.next",
              "lanczos.accumulate", "build.kron_hamiltonian", "sync"):
        assert n in names, n
    assert names.count("lanczos.alpha") == 2 * 2 * 40
    assert c["lanczos.cycles"] == info["cycles"] == 2
    assert c["syncs"] == names.count("sync") == 2 * 2
    assert c["build.kron_tables"] == 1 and c["build.k1_descriptors"] == 1
    assert _steady_ops_outside_leaves(ev) == []
    assert _leaves_around_applies(ev) == []


def test_compact_kpm_row_spans_and_counters(tmp_path):
    m = pt.xxz_chain(L, nup=L // 2, dtype=torch.float32, layout="compact")
    mv = pt.matvec_fn(m, device="cpu")
    psi = torch.randn(m.n_states, generator=torch.Generator().manual_seed(1))
    psi = psi / torch.linalg.vector_norm(psi)
    profiling.reset_counters()
    with _Forwards(type(mv)) as fw:
        S, ev = _traced(tmp_path, lambda: pt.kpm_sqw(
            psi, m, [math.pi / 2], np.linspace(0, 4, 30), a=6.0, b=0.0,
            kpm_m=80, E0=-5.0, matvec=mv))
    c = profiling.counters()
    names = [e["name"] for e in _spans(ev)]
    # the doubled scan: T_1..T_40, one apply each
    assert names.count("apply.ell") == c["applies.ell"] == 41
    assert fw.n["FlatHamiltonian"] == 41
    assert c["kpm.moments"] == 80
    assert {"groundstate", "row"}.isdisjoint(names)
    for n in ("kpm.phi", "kpm.moments", "kpm.rescale", "kpm.recur",
              "kpm.dots", "kpm.reconstruct"):
        assert n in names, n
    assert "kpm.bounds" not in names  # the window was given
    assert _steady_ops_outside_leaves(ev) == []
    assert _leaves_around_applies(ev) == []


def test_kron_tables_built_once_per_groundstate_call():
    m = pt.xxz_chain(10, nup=5, dtype=torch.float32, layout="sector_kron")
    profiling.reset_counters()
    for k in range(1, 4):
        pt.groundstate_kron(m, lanc_m=6, cycles=1, target_residual=None,
                            device="cpu",
                            generator=torch.Generator().manual_seed(k))
        assert profiling.counters()["build.kron_tables"] == k


def test_launch_counts_read_the_one_registry():
    f32, bf16 = torch.float32, torch.bfloat16
    profiling.reset_counters()
    assert (kg.kernel_launch_count(), ct.kernel_launch_count(),
            fm.kernel_launch_count(), d2.dot2_launch_count()) == (0,) * 4
    for name, n in (("launches.k1.float32", 3), ("launches.k1.bfloat16", 2),
                    ("launches.k1_crossw.float32", 1),
                    ("launches.k2.float32", 5), ("launches.k2.bfloat16", 4),
                    ("launches.k3", 6), ("launches.dot2", 7)):
        profiling.count(name, n)
    assert (kg.kernel_launch_count(), kg.kernel_launch_count(f32),
            kg.kernel_launch_count(bf16)) == (5, 3, 2)
    assert (kg.kernel_launch_count(crossw=True),
            kg.kernel_launch_count(f32, crossw=True)) == (1, 1)
    assert (ct.kernel_launch_count(), ct.kernel_launch_count(bf16)) == (9, 4)
    assert (fm.kernel_launch_count(), d2.dot2_launch_count()) == (6, 7)
    assert bench.launch_counts() == {"K1": 3, "K1 bf16": 2, "K1 crossw": 1,
                                     "K2": 5, "K2 bf16": 4, "K3": 6}
    kg.reset_kernel_launch_count()
    assert kg.kernel_launch_count() == kg.kernel_launch_count(
        crossw=True) == 0
    assert (ct.kernel_launch_count(), fm.kernel_launch_count(),
            d2.dot2_launch_count()) == (9, 6, 7)
    ct.reset_kernel_launch_count()
    fm.reset_kernel_launch_count()
    d2.reset_dot2_launch_count()
    assert profiling.counters() == {}
    with pytest.raises(KeyError):
        kg.kernel_launch_count(torch.float64)
