"""The ell kernel's wrapper and its host emulation on the CPU.

The emulation (`_emulate_ell`) replays csrc/ell_apply.cu's partition (the
tiles of `tile_rows(n_bonds)` rows walked by a persistent grid, each tile's
words staged once by the 16-byte and word copies) and its order of
summation (diag psi first, then the bonds in order by FMA, rows of -1
skipped) in numpy, and is held to the plain version (apply_H_ell on the
CPU) and to the JAX package's apply within float32 rounding (1e-6 of
max|y|: the plain version and the JAX package sum the bonds in other
orders). The wrapper's refusals need no card: every check but the device
comes first."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu_torch.model import sector_setup
from spindynamics_tpu_torch.ops import ell_apply as ea
from spindynamics_tpu_torch.parallel.sharded_apply import pad_model
from spindynamics_tpu_torch.utils.convert import state_to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fma(j, v, a):
    """float32 FMA: the product exact in float64, one sum, one rounding to
    float32 (double rounding of a float64 sum, the same as the card's
    single rounding but in rare ties)."""
    return (np.float64(j) * v.astype(np.float64)
            + a.astype(np.float64)).astype(np.float32)


def _emulate_ell(psi, nbr, diag, J, grid, vec=True):
    """csrc/ell_apply.cu on the host for a float32 or complex64 psi: block
    b of `grid` takes tiles b, b + grid, ...; a tile of `rows` rows is
    staged word by word (16-byte copies of 4 words where `vec`, thread t
    taking copies t, t + rows, ..., then single words) and thread t sums
    row tile * rows + t. Asserts every word staged once and every row
    written once."""
    N, nb = nbr.shape
    rows = ea.tile_rows(nb)
    flat = nbr.reshape(-1)
    planes = ([psi.real, psi.imag] if np.iscomplexobj(psi) else [psi])
    outs = [np.full(N, np.nan, np.float32) for _ in planes]
    written = np.zeros(N, np.int64)
    n_tiles = -(-N // rows)
    for blk in range(grid):
        for tile in range(blk, n_tiles, grid):
            r0 = tile * rows
            words = min(rows, N - r0) * nb
            smem = np.full(rows * nb, -7, np.int32)  # poison
            staged = np.zeros(words, np.int64)
            n16 = words // 4 if vec else 0
            for t in range(rows):
                for i in range(t, n16, rows):
                    smem[4 * i:4 * i + 4] = flat[r0 * nb + 4 * i:
                                                 r0 * nb + 4 * i + 4]
                    staged[4 * i:4 * i + 4] += 1
                for i in range(4 * n16 + t, words, rows):
                    smem[i] = flat[r0 * nb + i]
                    staged[i] += 1
            assert np.all(staged == 1)
            n = min(rows, N - r0)
            r = r0 + np.arange(n)
            idx = smem[:n * nb].reshape(n, nb)
            for p, out in zip(planes, outs):
                acc = diag[r] * p[r]
                for b in range(nb):
                    m = idx[:, b] >= 0
                    acc[m] = _fma(J[b], p[idx[m, b]], acc[m])
                out[r] = acc
            written[r] += 1
    assert np.all(written == 1)
    return outs[0] if len(outs) == 1 else outs[0] + 1j * outs[1]


def _models(case):
    """(JAX model, port model) of one case, float32; the padded port model
    has the JAX model's rows first."""
    L = 9 if case == "full" else 12
    hop = sd.nn_hopping(L, 1.0)
    if case == "periodic":
        hop = hop + [(0, L - 1, 1.0)]
    fld = np.linspace(-0.3, 0.2, L)
    zz = [(i, j, 0.5) for i, j, _ in hop]
    kw = dict(hopping=hop, onsite_field=fld, zz=zz)
    if case == "full":
        mj = sd.build_model(L, dtype=jnp.float32, build_neighbor_table=True,
                            **kw)
        mt = pt.build_model(L, dtype=torch.float32,
                            build_neighbor_table=True, **kw)
    else:
        mj = sd.build_model(L, nup=L // 2, dtype=jnp.float32, **kw)
        mt = pt.build_model(L, nup=L // 2, dtype=torch.float32,
                            layout="compact", **kw)
    if case == "padded":  # 924 rows padded to 928: four rows of -1
        mt = pad_model(mt, 8)
        assert mt.n_states - mt.dim == 4
    return mj, mt


@pytest.mark.parametrize("grid", [1, 5])
@pytest.mark.parametrize("cplx", [False, True], ids=["float32", "complex64"])
@pytest.mark.parametrize("case", ["open", "periodic", "padded", "full"])
def test_emulation_matches_plain_and_jax(case, cplx, grid):
    """Each case but "full" (512 rows) has an N that is not a multiple of
    the tile (924, 928 rows against 256); the periodic chain has an even
    n_bonds."""
    mj, mt = _models(case)
    N = mt.n_states
    assert N % ea.tile_rows(mt.n_bonds) != 0 or case == "full"
    _, diag, nbr = sector_setup(mt, "cpu", torch.float32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(N).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(N)).astype(np.complex64)
    J = np.asarray(mt.hop_J, np.float32)
    got = _emulate_ell(x, nbr.numpy(), diag.numpy(), J, grid,
                       vec=grid == 1)
    plain = state_to_numpy(pt.apply_H_ell(torch.from_numpy(x), mt))
    tol = 1e-6 * np.abs(plain).max()
    assert np.abs(got - plain).max() <= tol
    n = mt.dim
    want = np.asarray(sd.apply_H(jnp.asarray(x[:n]), mj))
    assert np.abs(got[:n] - want).max() <= tol
    assert np.all(got[n:] == 0)  # pad rows: diagonal 0, no bonds


@pytest.mark.parametrize("nb,rows", [
    (0, 256), (11, 256), (27, 256), (28, 256), (29, 128), (56, 128),
    (57, 64), (190, 32), (ea.MAX_BONDS, 32)])
def test_tile_rows_fit_shared_memory(nb, rows):
    """Rows per tile from n_bonds alone: 256 while the kernel's two buffers
    of a tile fit the budget, halved down to 32, always within a block's
    shared memory."""
    assert ea.tile_rows(nb) == rows
    assert 2 * rows * nb * 4 <= (ea.SMEM_BUDGET if rows > ea.MIN_ROWS
                                 else ea.SMEM_MAX)


def test_tile_rows_refuse_too_many_bonds():
    with pytest.raises(ValueError, match="at most"):
        ea.tile_rows(ea.MAX_BONDS + 1)


def _operands(N=100, nb=5, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    psi = torch.randn(N, generator=g).to(dtype)
    nbr = torch.randint(-1, N, (N, nb), generator=g, dtype=torch.int32)
    rdt = torch.float64 if dtype in (torch.float64, torch.complex128) \
        else torch.float32
    return psi, nbr, torch.randn(N, generator=g).to(rdt), \
        torch.randn(nb, generator=g).to(rdt)


def _bad(case):
    psi, nbr, diag, J = _operands()
    if case == "state_dtype":
        psi = psi.to(torch.bfloat16)
    elif case == "state_not_contiguous":
        psi = torch.stack([psi, psi], 1)[:, 0]
    elif case == "state_2d":
        psi = psi[:, None]
    elif case == "table_dtype":
        nbr = nbr.long()
    elif case == "table_shape":
        nbr = nbr[:-1]
    elif case == "table_not_contiguous":
        nbr = nbr.t().contiguous().t()
    elif case == "diag_dtype":
        diag = diag.double()
    elif case == "n_bonds_mismatch":
        J = J[:-1]
    return psi, nbr, diag, J


@pytest.mark.parametrize("case,err,match", [
    ("state_dtype", TypeError, "float32, complex64"),
    ("state_not_contiguous", ValueError, "contiguous 1-D state"),
    ("state_2d", ValueError, "contiguous 1-D state"),
    ("table_dtype", ValueError, "int32 table"),
    ("table_shape", ValueError, "int32 table"),
    ("table_not_contiguous", ValueError, "int32 table"),
    ("diag_dtype", ValueError, "diagonal"),
    ("n_bonds_mismatch", ValueError, "one per column"),
    ("wrong_device", ValueError, "runs on CUDA tensors"),
])
def test_wrapper_refuses(case, err, match):
    """ell_apply raises on what the kernel does not take, before any build
    or launch; with every operand right, a CPU state is the wrong device."""
    n0 = ea.ell_launch_count()
    with pytest.raises(err, match=match):
        ea.ell_apply(*_bad(case))
    assert ea.ell_launch_count() == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64,
                                   torch.float64, torch.complex128])
def test_cpu_route_is_the_plain_version(dtype):
    """On the CPU, apply_H_ell and an ell FlatHamiltonian run the plain
    version (bit for bit) and launch nothing."""
    m = pt.xxz_chain(10, nup=5, layout="compact", dtype=torch.float64,
                     h=np.linspace(-0.2, 0.3, 10))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(m.n_states, generator=g, dtype=torch.float64).to(dtype)
    _, diag, nbr = sector_setup(m, "cpu", torch.float64)
    J = torch.as_tensor(m.hop_J)
    want = ea.ell_apply_plain(x, nbr, diag, J)
    n0 = ea.ell_launch_count()
    assert torch.equal(pt.apply_H_ell(x, m), want)
    assert torch.equal(pt.matvec_fn(m, device="cpu")(x), want)
    assert ea.ell_launch_count() == n0


def test_flat_hamiltonian_owns_hop_J():
    """An ell FlatHamiltonian holds the couplings as the buffer `hop_J`,
    made once in its dtype, which `.to()` casts and moves with the table;
    after a cast to float64 it applies float64 states as a float64 module
    does."""
    m = pt.xxz_chain(10, Jxy=0.7, nup=5, layout="compact")
    mv = pt.matvec_fn(m, device="cpu")
    bufs = dict(mv.named_buffers())
    assert "hop_J" in bufs and bufs["hop_J"].dtype == torch.float32
    assert torch.equal(mv.hop_J, torch.as_tensor(m.hop_J))
    mv64 = mv.to(torch.float64)
    assert mv64.hop_J.dtype == torch.float64 and mv64.nbr.dtype == torch.int32
    x = torch.randn(m.n_states, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    ref = pt.FlatHamiltonian(m, device="cpu", dtype=torch.float64)
    assert torch.equal(mv64(x), ref(x))
    moved = pt.matvec_fn(m, device="cpu").to("meta")
    assert moved.hop_J.device.type == "meta"
    assert moved.nbr.device.type == "meta"
