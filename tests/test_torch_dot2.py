"""The dot2 kernel's host emulation and the compensated dots' call sites on
the CPU.

The emulation (tests/_dot2_emulation.py) replays csrc/dot2.cu's partition
through the ctypes leaf tables of ops/dot2.describe and is held to the exact
sum (math.fsum of the float64 products) within one float32 ulp. The CPU
call sites (dot2_leaves, _inner_c, _norm_c, pair_dot, pair_norm2, the
bucketed finalize) are held bit for bit to the per-leaf code they replaced,
and to the JAX package's compensated dots on the same numpy-made BlockVecs.
"""

import ctypes
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from _dot2_emulation import _emulate_dot2, owner
from spindynamics_tpu.ops import sector_kron as jsk
from spindynamics_tpu.solvers import blockvec as jbv
from spindynamics_tpu.solvers import kron_evolve as jke
from spindynamics_tpu.solvers import lanczos as jla
from spindynamics_tpu.utils import compensated as jcomp
from spindynamics_tpu_torch.ops import dot2 as d2
from spindynamics_tpu_torch.ops import sector_kron as tsk
from spindynamics_tpu_torch.solvers import blockvec as tbv
from spindynamics_tpu_torch.solvers import kron_evolve as tke
from spindynamics_tpu_torch.solvers import lanczos as tla
from spindynamics_tpu_torch.solvers import runners as tru
from spindynamics_tpu_torch.utils import compensated as comp
from spindynamics_tpu_torch.utils.convert import blockvec_from_numpy

SRC = Path(d2.__file__).resolve().parents[1] / "csrc" / "dot2.cu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exact(xs, ys):
    """math.fsum of the float64 products (exact for float32 / bfloat16)."""
    return math.fsum(float(v) for a, b in zip(xs, ys)
                     for v in (a.double().reshape(-1)
                               * b.double().reshape(-1)).numpy())


def _within_ulp(got, exact):
    want = np.float32(exact)
    return abs(float(got) - float(want)) <= float(np.spacing(np.abs(want)))


def _rand(n, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=g).to(dtype)


def test_descriptor_layout_matches_source():
    """The ctypes table mirrors csrc/dot2.cu's Dot2Desc, its constants and
    flag bits, and fits the 4 KB kernel-parameter space."""
    src = SRC.read_text()
    assert _define(src, "D2_MAX_LEAVES") == d2.MAX_LEAVES
    assert _define(src, "D2_BLOCK") == d2.BLOCK
    assert (_define(src, "D2_FIRST"), _define(src, "D2_LAST"),
            _define(src, "D2_F64")) == (d2.F_FIRST, d2.F_LAST, d2.F_F64)
    assert (_define(src, "D2_M_XBF16"), _define(src, "D2_M_YBF16"),
            _define(src, "D2_M_SAME"), _define(src, "D2_M_VEC")) == (
        d2.M_XBF16, d2.M_YBF16, d2.M_SAME, d2.M_VEC)
    size = ctypes.sizeof(d2._Dot2Desc)
    assert size == 5 * 8 + 4 * 4 + d2.MAX_LEAVES * (4 * 8 + 4)
    assert size <= 4096
    assert re.search(r"#define D2_UNROLL (\d+)", src).group(1) == str(
        d2.UNROLL)
    assert d2.MAX_LEAVES >= 80  # L=32's kron groups in one launch
    # the benchmark's trace sorts device time by kernel name: this one
    # counts among the vector ops, not as K1 or K2
    assert "void __launch_bounds__(D2_BLOCK)\n    dot2_kernel(" in src
    assert "kron_group_kernel" not in src and "cheb_term_kernel" not in src


def _define(src, name):
    m = re.search(rf"#define {name} \(?(\d+)u?(?: << (\d+)\))?", src)
    return int(m.group(1)) << int(m.group(2) or 0)


def _cases():
    """(xs, ys, what) cases of the emulation test."""
    c = {}
    lens = [0, 1, 3, 7, 1001, 4099, (1 << 16) + 3, 5]
    c["odd_and_zero_lengths"] = (
        [_rand(n, i) for i, n in enumerate(lens)],
        [_rand(n, 50 + i) for i, n in enumerate(lens)])
    c["one_leaf"] = ([_rand(300_001, 1)], [_rand(300_001, 2)])
    n_many = d2.MAX_LEAVES + 7
    c["chunked"] = ([_rand(17 + 13 * i, i) for i in range(n_many)],
                    [_rand(17 + 13 * i, 900 + i) for i in range(n_many)])
    z = torch.complex(_rand(20_003, 3), _rand(20_003, 4))
    w = torch.complex(_rand(20_003, 5), _rand(20_003, 6))
    c["complex_planes"] = ([z.real, z.imag, z.real], [w.real, w.imag,
                                                     _rand(20_003, 7)])
    x = _rand(70_001, 8)
    c["norm"] = ([x, z.real, z.imag], [x, z.real, z.imag])
    b = _rand(40_009, 9, torch.bfloat16)
    c["bfloat16"] = ([b, b, _rand(40_009, 10, torch.bfloat16)],
                     [b, _rand(40_009, 11), _rand(40_009, 12,
                                                  torch.bfloat16)])
    buf = _rand(50_000, 13)
    c["misaligned"] = ([buf[1:], buf[4:]], [_rand(49_999, 14),
                                            _rand(49_996, 15)])
    return c


@pytest.mark.parametrize("case", list(_cases()))
def test_emulation_matches_exact_sum(case):
    xs, ys = _cases()[case]
    call = d2.describe(xs, ys)
    assert call.grid == d2.BLOCKS_PER_SM * d2.H100_SMS and not call.f64
    n_desc = -(-len(xs) // d2.MAX_LEAVES)
    assert len(call.descs) == n_desc
    assert [d.flags for d in call.descs] == (
        [d2.F_FIRST | d2.F_LAST] if n_desc == 1
        else [d2.F_FIRST] + [0] * (n_desc - 2) + [d2.F_LAST])
    d = call.descs[0]
    metas = [m for dd in call.descs for m in dd.meta[:dd.n_leaves]]
    assert [dd.out for dd in call.descs] == [0] * n_desc  # no launch
    if case == "complex_planes":
        assert [m & 15 for m in metas] == [2 | 2 << 2, 2 | 2 << 2, 2 | 1 << 2]
        assert not any(m & d2.M_VEC for m in metas)
    if case == "norm":
        assert all(m & d2.M_SAME for m in metas)
        assert metas[0] & d2.M_VEC and not metas[1] & d2.M_VEC
    if case == "bfloat16":
        assert metas[0] & d2.M_SAME and metas[0] & d2.M_XBF16
        assert metas[1] & d2.M_XBF16 and not metas[1] & d2.M_YBF16
        assert not metas[1] & d2.M_VEC and metas[2] & d2.M_VEC
    if case == "misaligned":
        assert not metas[0] & d2.M_VEC and metas[1] & d2.M_VEC
    if case == "odd_and_zero_lengths":
        assert list(d.n[:d.n_leaves]) == [x.numel() for x in xs]
    got = _emulate_dot2(call)
    exact = _exact(xs, ys)
    assert _within_ulp(got, exact), (got, exact)


def test_descriptor_int64_lengths():
    """Lengths and element indices past 2^31 (the sharded L=34 state holds
    2.33e9 amplitudes) stay int64 in the table and in the thread map;
    meta tensors: no memory is touched."""
    n1, n2 = (1 << 31) + 5, (1 << 32) + 2
    a = torch.empty(n1, device="meta")
    z = torch.empty(n2, dtype=torch.complex64, device="meta")
    call = d2.describe([a, z.real], [a, z.imag])
    d = call.descs[0]
    assert (d.n[0], d.n[1]) == (n1, n2)
    assert d.meta[0] & d2.M_VEC and d.meta[0] & d2.M_SAME
    assert d.meta[1] & 15 == 2 | 2 << 2 and not d.meta[1] & d2.M_VEC
    # leaf 0: 2^29 + 1 vectors of 4 in 2^19 + 1 tiles, then one tail tile
    vt = (1 << 19) + 1
    assert d2.leaf_tiles(n1, 4) == (vt, 1)
    assert (d.tile0[0], d.tile0[1]) == (0, vt + 1)
    assert d.n_tiles == vt + 1 + -(-n2 // d2.TILE)
    assert owner(d, 0, n1 - 2) == ((1 << 19) % d.grid, 0)
    assert owner(d, 0, n1 - 1) == (vt % d.grid, 0)
    # leaf 1: scalar tiles of TILE elements
    j, q = divmod(n2 - 1, d2.TILE)
    assert owner(d, 1, n2 - 1) == ((vt + 1 + j) % d.grid, q % d2.BLOCK)
    assert (n2 - 1) * 2 > 1 << 32  # the kernel's element offset i * stride


def test_describe_refusals_and_promotion():
    x = _rand(64, 0)
    with pytest.raises(TypeError):
        d2.describe([torch.complex(x, x)], [torch.complex(x, x)])
    with pytest.raises(TypeError):
        d2.describe([x.half()], [x.half()])
    with pytest.raises(ValueError):
        d2.describe([x], [x[:10]])
    with pytest.raises(ValueError):
        d2.describe([], [])
    with pytest.raises(ValueError):
        comp.dot2_leaves([x], [])
    # a float64 leaf makes the call float64: every leaf read as float64
    b = x.bfloat16()
    call = d2.describe([b, x], [x.double(), x])
    assert call.f64 and call.descs[0].flags & d2.F_F64
    assert all(p[i].dtype == torch.float64 for p in call.leaves
               for i in (0, 2))
    assert torch.equal(call.leaves[0][0], b.double())
    # not evenly strided: copied contiguous; stride 3: copied too
    m = _rand(48, 1).reshape(6, 8)
    call = d2.describe([m[:, :3], m.reshape(-1)[::3]],
                       [m[:, 3:6], m.reshape(-1)[1::3]])
    assert [(p[0].stride(), p[1]) for p in call.leaves] == [((1,), 1)] * 2
    assert torch.equal(call.leaves[0][0], m[:, :3].reshape(-1))
    assert float(_emulate_dot2(call)) == pytest.approx(
        float((m[:, :3].double() * m[:, 3:6].double()).sum()
              + (m.reshape(-1)[::3].double()
                 * m.reshape(-1)[1::3].double()).sum()), rel=1e-6)


def test_cuda_tensors_never_take_the_plain_version():
    """Only a CPU leaf takes the plain version: any other device goes to
    the kernel's launch, which raises where it cannot run."""
    a = torch.empty(100, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        comp.dot2_leaves([a], [a])
    with pytest.raises(ValueError, match="CUDA"):
        comp.dot2(a, a)


# ---- the per-leaf code the call sites had (for the bit-for-bit test) ----

def _old_dot2(x, y):
    p, e = comp.two_prod(x.reshape(-1), y.reshape(-1))
    return torch.sum(e) + torch.sum(p)


def _old_vdot2(x, y):
    if not (x.is_complex() or y.is_complex()):
        return _old_dot2(x, y)
    xr, xi = (x.real, x.imag) if x.is_complex() else (x, None)
    yr, yi = (y.real, y.imag) if y.is_complex() else (y, None)
    re_ = _old_dot2(xr, yr)
    im = torch.zeros_like(re_)
    if xi is not None and yi is not None:
        re_ = re_ + _old_dot2(xi, yi)
    if yi is not None:
        im = im + _old_dot2(xr, yi)
    if xi is not None:
        im = im - _old_dot2(xi, yr)
    return torch.complex(re_, im)


def _old_norm2(x):
    if x.is_complex():
        s = _old_dot2(x.real, x.real) + _old_dot2(x.imag, x.imag)
    else:
        s = _old_dot2(x, x)
    return torch.sqrt(torch.clamp(s, min=0))


def _old_inner_leaf(a, b):
    if a.dtype == torch.bfloat16 or b.dtype == torch.bfloat16:
        a, b = a.float(), b.float()
    return _old_vdot2(a, b)


def _old_inner_c(x, y):
    return sum(_old_inner_leaf(a, b) for a, b in zip(x.leaves, y.leaves))


def _lift(t):
    return t.float() if t.dtype == torch.bfloat16 else t


def _old_pair_dot(x, y):
    sums = [0, 0, 0, 0]
    for x0, x1, y0, y1 in zip(x[0].leaves, x[1].leaves, y[0].leaves,
                              y[1].leaves):
        x0, x1, y0, y1 = _lift(x0), _lift(x1), _lift(y0), _lift(y1)
        for i, (a, b) in enumerate(((x0, y0), (x1, y1), (x0, y1),
                                    (x1, y0))):
            sums[i] = sums[i] + _old_vdot2(a, b)
    return sums[0] + sums[1], sums[2] - sums[3]


def _old_bv_vdot(x, y):
    return sum(_old_vdot2(_lift(a), _lift(a) if b is a else _lift(b))
               for a, b in zip(x.leaves, y.leaves))


def _old_finalize(buckets, matvec, leaves):
    nrm = torch.sqrt(torch.clamp(sum(_old_vdot2(x, x) for x in leaves),
                                 min=0.0))
    inv = 1.0 / nrm
    for x in leaves:
        x.mul_(inv.to(x.dtype))
    E = 0
    for b in buckets:
        h = matvec(tbv.BlockVec(leaves), groups=b).leaves
        E = E + sum(_old_vdot2(leaves[g], h[g]) for g in b)
    r2 = 0
    for b in buckets:
        h = matvec(tbv.BlockVec(leaves), groups=b).leaves
        r2 = r2 + sum(_old_vdot2(h[g] - leaves[g] * E, h[g] - leaves[g] * E)
                      for g in b)
    return leaves, E, torch.sqrt(torch.clamp(r2, min=0.0))


def _layout(L=12):
    m = pt.heisenberg_chain(L, nup=L // 2)
    return m, tsk.make_sector_kron_layout(m, m.kron_splits)


def _bvs(lay, dtype, seed, n=4):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.complex64:
        return [tbv.BlockVec([torch.complex(a, b) for a, b in zip(
            tbv.bv_random(lay, g, torch.float32, "cpu").leaves,
            tbv.bv_random(lay, g, torch.float32, "cpu").leaves)])
            for _ in range(n)]
    return [tbv.bv_random(lay, g, dtype, "cpu") for _ in range(n)]


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.complex64],
                         ids=["float32", "bfloat16", "complex64"])
def test_cpu_results_bit_for_bit(dtype):
    """On a random L=12 BlockVec the CPU dot2_leaves, _inner_c, _norm_c,
    pair_dot, pair_norm2 and (float32) the bucketed finalize equal the
    per-leaf code they replaced, bit for bit."""
    _, lay = _layout()
    x, y, u, v = _bvs(lay, dtype, 7)
    assert len(x.leaves) > 1
    assert _same(tla._inner_c(x, y, True), _old_inner_c(x, y))
    assert _same(tla._inner_c(x, x, True), _old_inner_c(x, x))
    if dtype != torch.complex64:
        assert _same(tla._norm_c(x, True), torch.sqrt(torch.clamp(
            sum(_old_inner_leaf(a, a) for a in x.leaves), min=0)))
        assert _same(comp.dot2_leaves(x.leaves, y.leaves),
                     _old_bv_vdot(x, y))
        assert _same(tke._bv_vdot(x, x), _old_bv_vdot(x, x))
        for got, want in zip(tke.pair_dot((x, y), (u, v)),
                             _old_pair_dot((x, y), (u, v))):
            assert _same(got, want)
        assert _same(tke.pair_norm2((x, y)),
                     _old_bv_vdot(x, x) + _old_bv_vdot(y, y))
    flat = x.leaves[3]
    assert _same(comp.vdot2(flat, y.leaves[3]),
                 _old_vdot2(_lift(flat), _lift(y.leaves[3])))
    if dtype != torch.bfloat16:
        assert _same(comp.norm2(flat), _old_norm2(flat))
    if dtype == torch.float32:
        H = pt.KronHamiltonian(lay, device="cpu")
        fin = tru._make_bucketed_finalize(lay)
        psi, E, r = fin(H, x.map(torch.clone))
        buckets = [tuple(range(a, b)) for a, b in zip(
            *(lambda e: (e[:-1], e[1:]))(np.linspace(
                0, len(lay.groups), 5).astype(int))) if a < b]
        leaves, E_old, r_old = _old_finalize(buckets, H,
                                             [t.clone() for t in x.leaves])
        assert _same(E, E_old) and _same(r, r_old)
        assert all(_same(a, b) for a, b in zip(psi.leaves, leaves))


def test_cpu_bfloat16_dots_read_float32():
    """A direct CPU dot2, vdot2, norm2 or dot2_leaves of bfloat16 tensors
    reads them as float32, as every compensated dot does (the kernel on the
    card too): a float32 result equal bit for bit to the same call on the
    float32 values."""
    rng = np.random.default_rng(5)
    x, y, u, v = (torch.from_numpy(rng.standard_normal(n).astype(
        np.float32)).to(torch.bfloat16) for n in (1001, 1001, 37, 37))
    for fn, args in ((comp.dot2, (x, y)), (comp.vdot2, (x, y)),
                     (comp.norm2, (x,)),
                     (comp.dot2_leaves, ([x, u], [y, v]))):
        lifted = [[t.float() for t in a] if isinstance(a, list)
                  else a.float() for a in args]
        got = fn(*args)
        assert got.dtype == torch.float32
        assert _same(got, fn(*lifted))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_against_jax(dtype):
    """The port's compensated BlockVec dots against the JAX package's on the
    same numpy-made L=12 leaves: float64 to 1e-12, float32 (both Dot2,
    summed in another order) to 1e-6 of sum |x y|."""
    _, lay = _layout()
    mj = sd.heisenberg_chain(12, nup=6, layout="sector_kron")
    lj = jsk.make_sector_kron_layout(mj, mj.kron_splits)
    rng = np.random.default_rng(3)
    npd = np.float64 if dtype == "float64" else np.float32
    tdt = torch.float64 if dtype == "float64" else torch.float32
    leaves = [[rng.standard_normal(t.shape).astype(npd)
               for t in tbv.bv_random(lay, torch.Generator().manual_seed(0),
                                      torch.float32, "cpu").leaves]
              for _ in range(4)]
    tx = [blockvec_from_numpy(ls, "cpu", tdt) for ls in leaves]
    jx = [jbv.BlockVec([jnp.asarray(a) for a in ls]) for ls in leaves]
    sabs = sum(float(np.abs(a.astype(np.float64) * b).sum())
               for a, b in zip(leaves[0], leaves[1]))
    tol = (1e-12 if dtype == "float64" else 1e-6) * sabs
    assert len(lj.groups) == len(lay.groups)
    got = float(tla._inner_c(tx[0], tx[1], True))
    want = float(jla._inner_c(jx[0], jx[1], True))
    assert abs(got - want) <= tol
    assert abs(float(tla._norm_c(tx[0], True))
               - float(jla._norm_c(jx[0], True))) <= tol
    for g, w in zip(tke.pair_dot((tx[0], tx[1]), (tx[2], tx[3])),
                    jke.pair_dot((jx[0], jx[1]), (jx[2], jx[3]))):
        assert abs(float(g) - float(w)) <= 2 * tol
    assert abs(float(comp.dot2_leaves(tx[0].leaves, tx[1].leaves))
               - float(sum(jcomp.dot2(a, b) for a, b in zip(
                   jx[0].leaves, jx[1].leaves)))) <= tol
