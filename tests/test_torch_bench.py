"""The port's bench (spindynamics_tpu_torch/bench.py) and its two scripts
(scripts/bench_kron.py, scripts/mxu_calibrate.py) on the CPU: each point's
timed path against the JAX package's plain route on the same numpy-made
inputs, the bound and value counts against bench.py's formulas on the JAX
layout, the matrix tokens against bench.py's own dispatch, and the refusal
to time anything without a card (scripts/sqw_precision.py's too). Timing
itself runs on the card only (chip_smoke.py's bench phase)."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
from spindynamics_tpu.ops import pallas_kron as jpk
from spindynamics_tpu.ops import sector_kron as jsk
from spindynamics_tpu.solvers import kron_evolve as jke
from spindynamics_tpu.solvers.blockvec import BlockVec as JBV
from spindynamics_tpu_torch import bench
from spindynamics_tpu_torch.parallel.sharded_kron_scaling import (
    shard_kron_blockvec, unshard_kron_blockvec)
from spindynamics_tpu_torch.scripts import bench_kron, mxu_calibrate
from spindynamics_tpu_torch.solvers.blockvec import BlockVec
from spindynamics_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5            # of max|y|: float32 against the JAX package
BF16_ULP = 2.0 ** -8  # one bfloat16 rounding, relative to |y|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread per test process, so parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_kron(L):
    m = sd.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2, dtype=jnp.float32,
                     layout="sector_kron")
    return m, jsk.make_sector_kron_layout(m, m.kron_splits, m.kron_pads)


def _np_leaves(lay, seed):
    """Normalized numpy leaves of the layout, zero in the tile pads."""
    rng = np.random.default_rng(seed)
    out = []
    for (_, _, _, ch, cm, cl, cmp, clp) in lay.groups:
        x = np.zeros((ch, cmp, clp), np.float32)
        x[:, :cm, :cl] = rng.standard_normal((ch, cm, cl))
        out.append(x)
    n = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in out))
    return [x / np.float32(n) for x in out]


def _held(out, want, bf16=False):
    """Worst |out - want| over TOL max|want| (+ BF16_ULP |want| for a
    bfloat16 out): <= 1 passes. `want` is the JAX value, float32 or
    float64, before any bfloat16 rounding."""
    outs = [np.asarray(o.float().numpy(), np.float64) for o in out]
    wants = [np.asarray(w, np.float64) for w in want]
    ymax = max(float(np.abs(w).max()) for w in wants)
    return max(float((np.abs(o - w) / (TOL * ymax + (BF16_ULP * np.abs(w)
                                                      if bf16 else 0.0)
                                        + 1e-30)).max())
               for o, w in zip(outs, wants))


def _jax_fused_bf16(jlay, x64, top_k):
    """JAX's value of its fused apply on bfloat16 leaves (x64: their
    float64 values) before the output's rounding, in float64: each fused
    group's seed made as pallas_kron.apply_H_sector_kron_fused makes it
    (the seed terms of the group's plan, stored in bfloat16) plus the
    group's other terms, and the tail groups' whole apply."""
    plans = jpk.fused_group_plans(jlay)
    sizes = [(ch * cmp * clp, gi) for gi, (_, _, _, ch, _, _, cmp, clp)
             in enumerate(jlay.groups)]
    fused = {gi for _, gi in sorted(sizes, reverse=True)[:top_k]}
    out = jsk.apply_H_sector_kron(x64, None, jlay, group_filter=frozenset(
        range(len(jlay.groups))) - fused)
    for gi in fused:
        v2 = plans[gi].crossh_fusable
        seed = jsk.apply_H_sector_kron(
            x64, None, jlay, terms="hi" if v2 else "hi,crossh",
            group_filter=(gi,))[gi].astype(jnp.bfloat16)
        out[gi] = seed.astype(jnp.float64) + jsk.apply_H_sector_kron(
            x64, None, jlay, terms="diag,lo,mid,crossl" + (",crossh" if v2
                                                           else ""),
            group_filter=(gi,))[gi]
    return out


@pytest.mark.parametrize("tok", ["14", "bf16:14", "bf16:20", "shardmap:14"])
def test_kron_apply_points_match_jax(tok):
    """One apply of the timed path (the fused KronHamiltonian, K1's plain
    version on the CPU; the sharded apply on LocalMesh(1)) against JAX's
    apply_H_sector_kron (float64, the same float32 or bfloat16-rounded
    input). float32: within 1e-5 max|y|. bfloat16: within one rounding
    (2^-8 |y| + 1e-5 max|y|) of JAX's fused apply before its output
    rounding, whose seeds are stored in bfloat16 (_jax_fused_bf16); at
    L=20 the float64 apply of the same leaves, two roundings away, misses
    that limit many times over, so the case sees a change of the seeds'
    rounding."""
    kind, L, opt = bench.parse_token(tok)
    p = bench.make_point(kind, L, opt, bench.Builds("cpu"))
    bf16 = kind == "sector_kron" and opt
    _, jlay = _jax_kron(L)
    sdt = torch.bfloat16 if bf16 else torch.float32
    xt = BlockVec([torch.tensor(x).to(sdt) for x in _np_leaves(jlay, 3)])
    x64 = [jnp.asarray(x.float().numpy(), jnp.float64) for x in xt.leaves]
    if bf16:
        assert p.run.top_k == jsk.default_fused_topk(jlay)
        want = _jax_fused_bf16(jlay, x64, p.run.top_k)
    else:
        want = jsk.apply_H_sector_kron(x64, None, jlay)
    if kind == "shardmap":
        b = bench.Builds("cpu").get(("shardmap", L))
        got = unshard_kron_blockvec(
            p.run(shard_kron_blockvec(xt, b.spec, b.mesh)), b.spec)
    else:
        got = p.run(xt)
    assert all(g.dtype == sdt for g in got.leaves)
    assert _held(got.leaves, want, bf16) <= 1.0
    if bf16 and L >= 20:
        assert _held(got.leaves, jsk.apply_H_sector_kron(x64, None, jlay),
                     True) > 10.0
    assert p.check() <= 1.0  # the point's own check, plain against plain


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_evolve_point_step_matches_jax(monkeypatch, bf16):
    """One Chebyshev step of the timed path (KronPlanes, K2's plain version
    on the CPU) against JAX's _cheb_kron_scan oracle through the plain
    applies (its accumulator is float32), bench.py's dt, bounds and
    cheb_n, from the same numpy-made state. float32: within 1e-5 max|y|.
    bfloat16, against JAX's float32 step of the same (bfloat16-exact)
    state: every stored term and the result are rounded to bfloat16, so
    within two roundings of the largest amplitude, 2^-7 max|y| (the 40
    terms' roundings enter weighted by the coefficients, sum |c_k| ~ 1.5,
    at 2^-9 each)."""
    monkeypatch.setenv("SDTPU_CHEB_FUSED", "0")
    L = 12
    p = bench.make_point("evolve", L, bf16, bench.Builds("cpu"))
    _, jlay = _jax_kron(L)
    sdt = torch.bfloat16 if bf16 else torch.float32
    re = [torch.tensor(x).to(sdt) for x in _np_leaves(jlay, 5)]
    pair = (BlockVec(re), BlockVec([torch.zeros_like(x) for x in re]))
    n, dt, bnd = (bench.EVOLVE[k] for k in ("cheb_n", "dt", "bound"))
    c, a, b = sd.solvers.chebyshev.chebyshev_coefficients(dt, -bnd * L,
                                                          bnd * L, n)
    c_ri = jnp.asarray(np.stack([c.real, c.imag], axis=1), jnp.float32)
    jpair = tuple(JBV([jnp.asarray(x.float().numpy()) for x in P.leaves])
                  for P in pair)
    want = jke._cheb_kron_scan(jke.kron_planes_matvec_fn(jlay, fused=False),
                               jpair, c_ri,
                               (jnp.float32(1.0 / a), jnp.float32(b)), n)
    got = p.run(pair)
    outs = [x for P in got for x in P.leaves]
    wants = [x for P in want for x in P.leaves]
    assert all(x.dtype == sdt for x in outs)
    if bf16:
        ymax = max(float(jnp.abs(w).max()) for w in wants)
        assert max(float(np.abs(o.float().numpy() - np.asarray(w)).max())
                   for o, w in zip(outs, wants)) <= 2 * BF16_ULP * ymax
    else:
        assert _held(outs, wants) <= 1.0
    assert p.check() <= 1.0


@pytest.mark.parametrize("backend", ["pallas", "blocked", "tensor"])
def test_embedded_points_match_jax(backend):
    """One flat apply of the timed path (`pallas` -> the port's `fused`
    backend, K3's plain version on the CPU) against JAX's apply_H through
    its blocked backend, float32, within 1e-5 max|y|."""
    L = 14
    p = bench.make_point("embedded", L, backend, bench.Builds("cpu"))
    assert p.metric == f"spmv_nnz_per_s_L{L}_Sz0_embedded_{backend}"
    mj = sd.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2, dtype=jnp.float32,
                      layout="embedded")
    x = np.random.default_rng(7).standard_normal(2 ** L).astype(np.float32)
    want = sd.apply_H(jnp.asarray(x), mj, backend="blocked")
    got = p.run(torch.tensor(x))
    assert got.dtype == torch.float32
    assert _held([got], [want]) <= 1.0
    assert p.check() <= 1.0


def _exact_nnz(L, sector):
    """The nonzeros of the open XXZ chain's H (Jxy=1, Jz=0.5) on the Sz=0
    sector or the whole space, counted from the basis bits: a diagonal
    Jz sum_i (+-1/4) that is not 0, and one flip per anti-aligned bond."""
    s = np.arange(2 ** L)
    if sector:
        s = s[np.array([bin(v).count("1") for v in s]) == L // 2]
    anti = [((s >> i) ^ (s >> (i + 1))) & 1 for i in range(L - 1)]
    diag = sum(0.5 * 0.25 * (1 - 2 * a) for a in anti)
    return int(np.count_nonzero(diag) + sum(int(a.sum()) for a in anti))


def test_counts_match_bench_py_formulas():
    """nnz of each point against bench.py's formula on the JAX layout of
    the same model (bench.py:85-86, 266), and no larger than H's exact
    count; the bounds' counts of the function's work: bytes over the C(L,
    L/2) sector amplitudes (not bench.py's padded count), one multiply-add
    per nonzero (not bench.py's kron_apply_flops, the dense tile products
    of one route), a step's cheb_n - 1 applies per plane; each at its
    data-sheet rate, the bytes deciding."""
    L = 14
    builds = bench.Builds("cpu")
    mj, jlay = _jax_kron(L)
    N = jlay.n_basis
    assert N == 3432 and jlay.n_states > N
    nnz = N * (1.0 + len(mj.hop_sites) / 2.0)
    assert nnz <= _exact_nnz(L, sector=True)
    assert 2 * nnz < float(jsk.kron_apply_flops(jlay))
    for bf16, size in ((False, 4), (True, 2)):
        p = bench.sector_kron_point(L, bf16, builds)
        assert p.nnz == nnz
        assert (p.n_bytes, p.flops) == (2.0 * N * size, 2.0 * nnz)
        e = bench.evolve_point(L, bf16, builds)
        assert e.nnz is None
        assert e.n_bytes == 6 * 39 * N * size
        assert e.flops == 4 * 39 * nnz
        for q in (p, e):
            assert bench.bound_ms(q) == (q.n_bytes / 3.35e12 * 1e3, "bytes")
            assert q.flops / 989e12 < q.n_bytes / 3.35e12
    s = bench.shardmap_point(L, builds)
    assert (s.nnz, s.n_bytes, s.flops) == (nnz, 2.0 * N * 4, 2.0 * nnz)
    mf = sd.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2, layout="embedded")
    k = bench.embedded_point(L, "pallas", builds)
    assert k.nnz == mf.n_states * (1.0 + len(mf.hop_sites) / 2.0)
    assert k.nnz == _exact_nnz(L, sector=False)
    assert (k.n_bytes, k.flops) == (2.0 * 2 ** L * 4, 2.0 * k.nnz)
    assert bench.bound_ms(k) == (k.n_bytes / 3.35e12 * 1e3, "bytes")


def test_default_tokens_give_bench_py_names():
    """The default headline and matrix give bench.py's seven names, in its
    order (bench.py:354-356)."""
    toks = ["32"] + bench.DEFAULT_MATRIX.split(",")
    assert [bench.metric_name(*bench.parse_token(t)) for t in toks] == [
        "spmv_nnz_per_s_L32_Sz0_sector_kron",
        "spmv_nnz_per_s_L28_Sz0_sector_kron",
        "spmv_nnz_per_s_L26_Sz0_embedded_pallas",
        "spmv_nnz_per_s_L32_Sz0_sector_kron_bf16",
        "spmv_nnz_per_s_L32_Sz0_shardmap_d1_kron",
        "evolve_step_s_L28_Sz0_kron",
        "evolve_step_s_L28_Sz0_kron_bf16"]
    assert bench.parse_token("26", "pallas") == ("embedded", 26, "pallas")
    with pytest.raises(ValueError, match="unknown backend"):
        bench.parse_token("fused:26")


_BENCH_PY_NAMES = """
import json, sys
sys.path.insert(0, {repo!r})
import bench
bench._slope_time = lambda chain, args, r0, r1: 1e-3  # no timing
bench.main()
"""


def test_tokens_follow_bench_py_dispatch(tmp_path):
    """bench.py itself (its timing stubbed) on a matrix of every kind at
    small L, on the CPU: its lines' metric names, in order, are the port's
    parse of the same tokens."""
    toks = "10,pallas:10,bf16:10,shardmap:10,evolve:10,evolvebf16:10"
    env = dict(os.environ, JAX_PLATFORMS="cpu", BENCH_PLATFORM="cpu",
               BENCH_L="12", BENCH_MATRIX=toks, BENCH_REPS="3",
               BENCH_CACHE_DIR=str(tmp_path))
    res = subprocess.run([sys.executable, "-c",
                          _BENCH_PY_NAMES.format(repo=REPO)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    names = [json.loads(ln)["metric"] for ln in res.stdout.splitlines()]
    ours = [bench.metric_name(*bench.parse_token(t))
            for t in ["12"] + toks.split(",")]
    assert names == ours + ours[:1]


@pytest.mark.parametrize("module", [
    "spindynamics_tpu_torch.bench",
    "spindynamics_tpu_torch.scripts.bench_kron",
    "spindynamics_tpu_torch.scripts.mxu_calibrate",
    "spindynamics_tpu_torch.scripts.sqw_precision"])
def test_refuses_without_a_card(module):
    """No CUDA device: exit non-zero and print nothing on stdout (no CPU
    time under a device metric)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    res = subprocess.run([sys.executable, "-m", module], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    assert "no CUDA device" in res.stderr


def test_modules_import_no_jax():
    code = ("import sys\n"
            "import spindynamics_tpu_torch.bench\n"
            "import spindynamics_tpu_torch.scripts.bench_kron\n"
            "import spindynamics_tpu_torch.scripts.mxu_calibrate\n"
            "import spindynamics_tpu_torch.scripts.sqw_precision\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib',"
            " 'spindynamics_tpu'))\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_timers_never_time_the_host():
    """Every timer raises for work on the CPU, and without a card at all."""
    x = torch.zeros(4)
    for timer in (profiling.event_ms, profiling.graph_ms):
        with pytest.raises(RuntimeError):
            timer(lambda: x + 1, device="cpu")
    with pytest.raises(RuntimeError):
        profiling.sync_time(lambda: x + 1, device="cpu")
    if not torch.cuda.is_available():
        for fn in (lambda: profiling.event_ms(lambda: x + 1),
                   lambda: profiling.sync_time(lambda: x + 1),
                   profiling.card_info):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                fn()


def test_builds_are_shared_then_freed():
    """A build is made once for the points that use it and freed after the
    last of them."""
    toks = [bench.parse_token(t) for t in ("12", "bf16:12", "shardmap:12")]
    needs = bench.Counter(k for t in toks for k in bench._keys(*t))
    builds = bench.Builds("cpu", needs)
    a = bench.make_point(*toks[0], builds)
    b = bench.make_point(*toks[1], builds)
    assert builds.get(("kron", 12)).H is a.run is b.run
    builds.done(a.keys)
    builds.done(b.keys)
    assert ("kron", 12) in builds._built
    s = bench.make_point(*toks[2], builds)
    builds.done(s.keys)
    assert builds._built == {}


def test_calibration_accuracy_on_cpu():
    """mxu_calibrate's accuracy part at a small M: float32 products within
    float32 rounding of float64, bfloat16 operands near 2^-8, and the
    precision settings (TF32 pinned off at import) restored."""
    A, W = mxu_calibrate.operands(256, 64, "cpu")
    modes = [m[0] for m in mxu_calibrate.MODES + (mxu_calibrate.BF16,)]
    assert modes == ["highest", "high", "bf16"]
    errs = mxu_calibrate.relative_errors(A, W, modes, rows=128)
    assert errs["highest"] <= 1e-6
    assert 1e-4 <= errs["bf16"] <= 2e-2
    assert all(np.isfinite(v) for v in errs.values())
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32


def test_bench_kron_splits_reach_the_model():
    """--splits is passed to the model; no default is patched."""
    from spindynamics_tpu_torch.ops import sector_kron as tsk

    before = tsk.default_kron_splits(16, 8)
    assert bench_kron.kron_model(16, [6, 5, 5]).kron_splits == (6, 5, 5)
    assert bench_kron.kron_model(16).kron_splits == before
    assert tsk.default_kron_splits(16, 8) == before
