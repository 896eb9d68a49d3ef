"""The sector_blocked layout of the port against the JAX package's
(spindynamics_tpu/ops/sector_blocked.py, the model's mode "sector" with
lo_bits) on the CPU: the blocked order and rank, the apply at several lo
widths Ll with complex states, the host and torch builds of the states and
diagonal, the model's flat solvers; and the `tensor` backend against
apply_H_tensor on the full and embedded layouts.

Tolerances: orders, ranks and builds exactly equal; float64 applies to
1e-12 of max|y|; ground state and trajectories to 1e-9 (two Krylov or
Chebyshev recurrences). The JAX package keeps its hop tables in float32
whatever the state (the port keeps float64), so the hopping couplings here
are float32 numbers, where the two agree to rounding; the diagonal takes
any values. Inputs are made with numpy from a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu.ops import apply as japply
from spindynamics_tpu.ops import sector_blocked as jsb
from spindynamics_tpu_torch import model as tmodel
from spindynamics_tpu_torch.ops import sector_blocked as tsb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _couplings(L, Ll, kind, rng):
    """(hopping, zz, field): the XXZ chain, or a long-range chain:
    nearest and next-nearest hopping (the next-nearest bonds inside the lo
    or the hi part: only the nearest-neighbour bond may cross the cut),
    all-pairs zz ~ 1/r^2, a random field. Hopping values are multiples of
    1/8."""
    field = rng.normal(size=L) * 0.2
    hop = [(i, i + 1, float(rng.integers(4, 12)) / 8) for i in range(L - 1)]
    if kind == "chain":
        return hop, [(i, i + 1, 0.55) for i in range(L - 1)], field
    hop += [(i, i + 2, float(rng.integers(1, 5)) / 8) for i in range(L - 2)
            if i + 2 < Ll or i >= Ll]
    zz = [(i, j, 0.7 / (j - i) ** 2) for i in range(L) for j in range(i + 1, L)]
    return hop, zz, field


@pytest.mark.parametrize("L,nup,Ll,kind", [
    (8, 4, 3, "chain"), (10, 3, 5, "chain"), (9, 2, 4, "longrange"),
    (14, 7, None, "longrange")])
def test_apply_matches_jax(L, nup, Ll, kind):
    """apply_H_sector_blocked of both packages on the same layout, diagonal
    and complex state: equal to 1e-12 of max|y|; the layouts' groups,
    offsets and lo operators equal."""
    rng = np.random.default_rng(L * 100 + nup)
    Ll_eff = tsb.default_lo_bits(L) if Ll is None else Ll
    hop, zz, field = _couplings(L, Ll_eff, kind, rng)
    m = pt.build_model(L, nup=nup, hopping=hop, zz=zz, onsite_field=field,
                       dtype=torch.float64, layout="compact")
    args = (L, nup, m.hop_sites, np.asarray(m.hop_J, np.float64).tolist())
    tl = tsb.make_sector_blocked_layout(args, Ll)
    jl = jsb.make_sector_blocked_layout(args, Ll)
    assert tl.Ll == jl.Ll == Ll_eff and tl.groups == jl.groups
    assert tl.offsets == jl.offsets
    for k, _, _ in tl.groups:
        if tl.Wlo[k] is not None:
            np.testing.assert_array_equal(tl.Wlo[k], jl.Wlo[k])
    states = tsb.blocked_order_states(L, nup, Ll_eff).astype(np.int64)
    diag = tmodel._compute_diag(states, m.field, m.zz_i, m.zz_j, m.zz_J,
                                np.float64)
    psi = rng.normal(size=states.size) + 1j * rng.normal(size=states.size)
    got = tsb.apply_H_sector_blocked(torch.from_numpy(psi),
                                     torch.from_numpy(diag), tl).numpy()
    want = np.asarray(jsb.apply_H_sector_blocked(
        jnp.asarray(psi), jnp.asarray(diag), jl))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    # and the real part alone (a float64 state)
    got_r = tsb.apply_H_sector_blocked(torch.from_numpy(psi.real),
                                       torch.from_numpy(diag), tl).numpy()
    assert np.abs(got_r - want.real).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("L,nup,Ll", [(10, 5, 4), (12, 4, 6), (13, 6, 5)])
def test_blocked_order_and_rank_match_jax(L, nup, Ll):
    states = tsb.blocked_order_states(L, nup, Ll)
    np.testing.assert_array_equal(states, jsb.blocked_order_states(L, nup, Ll))
    for i in range(0, states.size, 7):
        r = tsb.blocked_rank(int(states[i]), L, nup, Ll)
        assert r == i == jsb.blocked_rank(int(states[i]), L, nup, Ll)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_torch_build_equals_host_build(dtype):
    """The torch build (the card's route, here on CPU tensors) gives the
    host build's states and diagonal bit for bit, also for a field and
    all-pairs zz couplings that round; both in the JAX model's order."""
    L, nup = 13, 6
    rng = np.random.default_rng(3)
    hop, zz, field = _couplings(L, tsb.default_lo_bits(L), "longrange", rng)
    m = pt.build_model(L, nup=nup, hopping=hop, zz=zz, onsite_field=field,
                       dtype=dtype, layout="sector_blocked")
    s_h, d_h, t_h = tmodel.sector_setup(m, "cpu")
    s_t, d_t = tmodel._device_blocked_setup(m, "cpu", dtype)
    assert t_h is None and d_h.dtype == d_t.dtype == dtype
    assert torch.equal(s_h, s_t) and torch.equal(d_h, d_t)
    mj = sd.build_model(L, nup=nup, hopping=hop, zz=zz, onsite_field=field,
                        dtype={torch.float64: jnp.float64,
                               torch.float32: jnp.float32}[dtype],
                        layout="sector_blocked")
    assert m.lo_bits == mj.lo_bits
    np.testing.assert_array_equal(s_h.numpy(), np.asarray(mj.states))
    np.testing.assert_array_equal(d_h.numpy(), np.asarray(mj.diag))


def _models(L=8, nup=4):
    mj = sd.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=nup, dtype=jnp.float64,
                      h=np.linspace(-0.3, 0.2, L), layout="sector_blocked")
    mt = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=nup, dtype=torch.float64,
                      h=np.linspace(-0.3, 0.2, L), layout="sector_blocked")
    return mj, mt


def test_model_and_flat_solvers_match_jax():
    """A sector_blocked model of both packages: the FlatHamiltonian's apply,
    the dense matrix, the ground state and its <Sz_i>, the domain-wall
    state's index and the Chebyshev trajectory's <Sz_i>."""
    mj, mt = _models()
    assert mt.mode == "sector_blocked" and mt.valid_mask() is None
    rng = np.random.default_rng(5)
    psi = rng.normal(size=mt.n_states) + 1j * rng.normal(size=mt.n_states)
    mv = pt.matvec_fn(mt, device="cpu")
    assert mv.backend == "sector_blocked"
    want = np.asarray(sd.apply_H(jnp.asarray(psi), mj))
    got = mv(torch.from_numpy(psi)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    H = pt.build_dense_H(mt)
    assert np.abs(H @ psi - want).max() <= 1e-12 * np.abs(want).max()
    np.testing.assert_array_equal(mt.basis_states().numpy(),
                                  np.asarray(mj.states))

    E_j, psi_j, _ = sd.lanczos_groundstate(sd.matvec_fn(mj), mj.n_states,
                                           lanc_m=60, dtype=jnp.float64)
    E_t, psi_t, info = pt.lanczos_groundstate(mv, mt.n_states, lanc_m=60,
                                              dtype=torch.float64,
                                              device="cpu")
    assert abs(E_t - float(E_j)) < 1e-10 and info["residual"] < 1e-8
    np.testing.assert_allclose(
        pt.magnetization_per_site(psi_t, mt).numpy(),
        np.asarray(sd.magnetization_per_site(psi_j, mj)), atol=1e-9)

    bits = pt.domain_wall_bitstring(mt)
    assert pt.state_index(mt, bits) == sd.state_index(mj, bits)
    _, obs_j = sd.evolve_trajectory(
        mj, sd.domain_wall_state(mj, dtype=jnp.complex128), 0.1, 4,
        cheb_n=40, Ebounds=(-9.0, 9.0))
    _, obs_t = pt.evolve_trajectory(
        mt, pt.domain_wall_state(mt, dtype=torch.complex128, device="cpu"),
        0.1, 4, cheb_n=40, Ebounds=(-9.0, 9.0))
    np.testing.assert_allclose(obs_t, np.asarray(obs_j), atol=1e-9)


def test_spin_operators_and_backends_on_sector_blocked():
    """Sz multiplies by the blocked order's bits; a flip leaves the sector
    (zero); the sector_blocked model takes 'sector_blocked' and 'dense'
    only, and the tensor backend full and embedded models only."""
    _, mt = _models(8, 4)
    psi = torch.from_numpy(np.random.default_rng(1).normal(size=mt.n_states))
    sz = pt.apply_spin_operator(psi, mt, 3, "z")
    bits = ((mt.basis_states() >> 3) & 1).to(torch.float64) - 0.5
    assert torch.equal(sz, psi * bits)
    assert not pt.apply_spin_operator(psi, mt, 3, "plus").any()
    for bad in ("ell", "blocked", "fused", "tensor"):
        with pytest.raises(ValueError):
            pt.apply_H(psi, mt, backend=bad)
    y = pt.apply_H(psi, mt, backend="dense")
    assert torch.allclose(y, pt.apply_H(psi, mt), rtol=0, atol=1e-12)
    mc = pt.xxz_chain(8, nup=4, layout="compact", dtype=torch.float64)
    with pytest.raises(ValueError):
        pt.matvec_fn(mc, backend="tensor", device="cpu")


@pytest.mark.parametrize("layout", ["full", "embedded"])
def test_apply_H_tensor_matches_jax(layout):
    """apply_H_tensor of both packages on a full and an embedded model with
    non-uniform couplings and a field, complex states: 1e-12 of max|y|;
    through a FlatHamiltonian too."""
    L = 8
    rng = np.random.default_rng(11)
    hop = [(i, j, 0.3 + 0.1 * (i + j)) for i in range(L)
           for j in range(i + 1, L) if j - i <= 2]
    zz = [(i, i + 1, 0.45) for i in range(L - 1)]
    field = rng.normal(size=L) * 0.3
    nup = None if layout == "full" else 4
    kw = dict(hopping=hop, zz=zz, onsite_field=field)
    mj = sd.build_model(L, nup=nup, dtype=jnp.float64,
                        layout="compact" if layout == "full" else layout, **kw)
    mt = pt.build_model(L, nup=nup, dtype=torch.float64, layout=layout, **kw)
    psi = rng.normal(size=1 << L) + 1j * rng.normal(size=1 << L)
    want = np.asarray(japply.apply_H_tensor(jnp.asarray(psi), mj))
    got = pt.apply_H_tensor(torch.from_numpy(psi), mt).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    mv = pt.matvec_fn(mt, backend="tensor", device="cpu")
    got = mv(torch.from_numpy(psi)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    got32 = mv(torch.from_numpy(psi.astype(np.complex64))).numpy()
    assert got32.dtype == np.complex64
    assert np.abs(got32 - want).max() <= 1e-5 * np.abs(want).max()
