"""The flat-state slice end to end through both packages at small L: six
of the embedded-layout cases of tests/test_embedded.py (the seventh, the
thermal state, is in tests/test_torch_typicality.py), the rule for the
default device, and a user-style drive of the port alone."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu_torch.utils.convert import (
    model_from_numpy, state_from_numpy, state_to_numpy)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


L, NUP = 8, 4


@pytest.fixture(scope="module")
def models():
    """The compact sector model and the embedded model of the JAX package,
    and the port's embedded model from the same couplings (float64)."""
    kw = dict(Jxy=1.0, Jz=0.5, h=np.linspace(-0.2, 0.2, L))
    m_sec = sd.xxz_chain(L, nup=NUP, dtype=jnp.float64, **kw)
    m_emb = sd.build_model(
        L, nup=NUP, hopping=sd.nn_hopping(L, 1.0),
        onsite_field=np.linspace(-0.2, 0.2, L),
        zz=[(i, i + 1, 0.5) for i in range(L - 1)],
        dtype=jnp.float64, layout="embedded")
    m_pt = model_from_numpy(
        m_emb.L, m_emb.nup, m_emb.hop_sites, np.asarray(m_emb.hop_J),
        np.asarray(m_emb.field), m_emb.zz_sites, np.asarray(m_emb.zz_J),
        layout="embedded")
    return m_sec, m_emb, m_pt


def _embed(psi_sec, m_sec):
    out = np.zeros(1 << L, dtype=np.asarray(psi_sec).dtype)
    out[np.asarray(m_sec.states)] = np.asarray(psi_sec)
    return out


def _start(m_sec, seed=0):
    return _embed(np.random.default_rng(seed).standard_normal(
        m_sec.n_states), m_sec)


def test_embedded_mode_basics(models):
    m_sec, m_emb, m_pt = models
    assert m_pt.mode == m_emb.mode == "embedded"
    assert m_pt.n_states == m_emb.n_states == 2 ** L
    mask = m_pt.valid_mask().numpy()
    assert mask.sum() == m_sec.n_states
    assert np.array_equal(np.nonzero(mask)[0], np.asarray(m_sec.states))


def test_embedded_matvec_agrees(models):
    m_sec, m_emb, m_pt = models
    psi = np.random.default_rng(1234).normal(size=m_sec.n_states)
    out_sec = np.asarray(sd.apply_H(jnp.asarray(psi), m_sec))
    out_emb = np.asarray(sd.apply_H(jnp.asarray(_embed(psi, m_sec)), m_emb))
    out_pt = state_to_numpy(pt.apply_H(
        state_from_numpy(_embed(psi, m_sec), "cpu"), m_pt))
    # in-sector values agree with the compact layout and with the JAX
    # embedded apply; out-of-sector stays exactly zero
    states = np.asarray(m_sec.states)
    assert np.allclose(out_pt[states], out_sec, atol=1e-12)
    assert np.allclose(out_pt, out_emb, atol=1e-12)
    assert not out_pt[~m_pt.valid_mask().numpy()].any()


def test_embedded_groundstate(models):
    m_sec, m_emb, m_pt = models
    E_sec, _, _ = sd.lanczos_groundstate(
        sd.matvec_fn(m_sec), m_sec.n_states, lanc_m=60, dtype=jnp.float64)
    v0 = _start(m_sec)
    E_emb, psi_emb, _ = sd.lanczos_groundstate(
        sd.matvec_fn(m_emb), None, lanc_m=60, dtype=jnp.float64,
        v0=jnp.asarray(v0))
    E_pt, psi_pt, info = pt.lanczos_groundstate(
        pt.matvec_fn(m_pt, device="cpu"), None, lanc_m=60,
        dtype=torch.float64, v0=state_from_numpy(v0, "cpu"))
    assert E_pt == pytest.approx(E_sec, abs=1e-9)
    assert E_pt == pytest.approx(E_emb, abs=1e-9)
    assert info["residual"] < 1e-6
    assert np.abs(state_to_numpy(psi_pt) - np.asarray(psi_emb)).max() < 1e-8
    # the port's own masked random start reaches the same energy
    E_r, psi_r, info = pt.lanczos_groundstate(
        pt.matvec_fn(m_pt, device="cpu"), m_pt.n_states, lanc_m=60,
        dtype=torch.float64, mask=m_pt.valid_mask(),
        generator=torch.Generator().manual_seed(0))
    assert E_r == pytest.approx(E_sec, abs=1e-9)
    assert not psi_r[~m_pt.valid_mask()].any()


def test_embedded_initial_states_and_observables(models):
    m_sec, m_emb, m_pt = models
    for name in ("domain_wall_state", "neel_state"):
        v_sec = getattr(sd, name)(m_sec)
        v_pt = getattr(pt, name)(m_pt, device="cpu")
        assert np.array_equal(state_to_numpy(v_pt),
                              np.asarray(getattr(sd, name)(m_emb)))
        mags_sec = np.asarray(sd.magnetization_per_site(v_sec, m_sec))
        mags_pt = pt.magnetization_per_site(v_pt, m_pt).numpy()
        assert np.allclose(mags_sec, mags_pt, atol=1e-12)
    _, Sq_sec = sd.structure_factor_Sq(sd.domain_wall_state(m_sec), m_sec)
    _, Sq_pt = pt.structure_factor_Sq(
        pt.domain_wall_state(m_pt, device="cpu"), m_pt)
    assert np.allclose(np.asarray(Sq_sec), Sq_pt.numpy(), atol=1e-12)


def test_embedded_time_evolution(models):
    m_sec, m_emb, m_pt = models
    psi_sec = sd.domain_wall_state(m_sec, dtype=jnp.complex128)
    psi_pt = pt.domain_wall_state(m_pt, dtype=torch.complex128, device="cpu")
    bounds = (-8.0, 8.0)
    out_sec = np.asarray(sd.chebyshev_time_evolve(
        psi_sec, sd.matvec_fn(m_sec), 0.3, bounds, cheb_n=40))
    out_pt = state_to_numpy(pt.chebyshev_time_evolve(
        psi_pt, pt.matvec_fn(m_pt, device="cpu"), 0.3, bounds, cheb_n=40))
    assert np.allclose(out_pt[np.asarray(m_sec.states)], out_sec, atol=1e-11)
    assert not out_pt[~m_pt.valid_mask().numpy()].any()


def test_embedded_sqw_agrees(models):
    """lanczos_sqw and kpm_sqw of the port's embedded layout against the
    JAX compact layout, from the compact ground state carried across."""
    m_sec, m_emb, m_pt = models
    E_s, psi_s, _ = sd.lanczos_groundstate(
        sd.matvec_fn(m_sec), m_sec.n_states, lanc_m=50, dtype=jnp.float64)
    psi_pt = state_from_numpy(_embed(psi_s, m_sec), "cpu")
    q = [2 * np.pi / 8, np.pi]
    omega = np.linspace(0, 3, 40)
    S_s = sd.lanczos_sqw(psi_s, m_sec, q, omega, lanc_m=40, eta=0.1)
    S_pt = pt.lanczos_sqw(psi_pt, m_pt, q, omega, lanc_m=40, eta=0.1)
    assert np.allclose(S_s, S_pt, atol=1e-6 + 1e-4 * S_s.max())
    K_s = np.asarray(sd.kpm_sqw(psi_s, m_sec, q, omega, a=5.0, b=0.0,
                                kpm_m=64))
    K_pt = pt.kpm_sqw(psi_pt, m_pt, q, omega, a=5.0, b=0.0, kpm_m=64).numpy()
    assert np.allclose(K_s, K_pt, atol=1e-6 + 1e-4 * max(K_s.max(), 1e-9))


# ---- the default device ---------------------------------------------------


def test_default_device_is_the_card(monkeypatch):
    """Without CUDA an entry point called without `device` raises and names
    device="cpu": there is no quiet CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mk = pt.xxz_chain(8, nup=4)
    me = pt.xxz_chain(8, nup=4, layout="embedded")
    from spindynamics_tpu_torch.ops.sector_kron import make_sector_kron_layout
    from spindynamics_tpu_torch.solvers.blockvec import (
        bv_basis_state, bv_random)
    from spindynamics_tpu_torch.solvers.kron_evolve import (
        kron_planes_matvec_fn)

    lay = make_sector_kron_layout(mk, mk.kron_splits)
    calls = [
        lambda: pt.groundstate_kron(mk),
        lambda: pt.kpm_sqw_kron(mk, [np.pi], [0.0, 1.0]),
        lambda: pt.evolve_trajectory_kron(mk, 0b1111, 0.1, 1),
        lambda: pt.typicality_correlation_kron(mk, 1.0, 0, 1, (0.0,)),
        lambda: pt.KronHamiltonian(lay),
        lambda: kron_planes_matvec_fn(lay),
        lambda: pt.matvec_fn(me),
        lambda: pt.FlatHamiltonian(me),
        lambda: pt.run_chebyshev(me, 0.1),
        lambda: pt.run_krylov(me, 0.1),
        lambda: pt.resolve_device(),
        # the state constructors too: the state decides where a solver runs
        lambda: pt.domain_wall_state(me),
        lambda: pt.neel_state(me),
        lambda: pt.polarized_state_with_flips(me, [0, 1, 2, 3]),
        lambda: pt.basis_state_vector(me, 0b1111),
        lambda: pt.evolve_trajectory(me, pt.domain_wall_state(me), 0.1, 1),
        lambda: bv_basis_state(lay, 0b1111),
        lambda: bv_random(lay, torch.Generator().manual_seed(0)),
        # the compact layout, flat typicality, the checkpointed ground state
        lambda: pt.matvec_fn(pt.xxz_chain(8, nup=4, layout="compact")),
        lambda: pt.thermal_state(me, 1.0),
        lambda: pt.typicality_correlation_function(
            me, 1.0, pt.make_spin_operator(0, "z"),
            pt.make_spin_operator(0, "z"), (0.0,)),
        lambda: pt.lanczos_groundstate_checkpointed(
            lambda v: v, me.n_states, "unused"),
    ]
    for f in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            f()
    # a state the caller passes in decides the device
    x = pt.domain_wall_state(me, device="cpu")
    assert pt.resolve_device(None, x) == torch.device("cpu")
    assert pt.resolve_device("cpu") == torch.device("cpu")
    _, obs = pt.evolve_trajectory(me, x, 0.1, 1, Ebounds=(-6.0, 6.0))
    assert obs.shape == (1, 8)


def test_no_entry_point_defaults_to_cpu():
    """No entry point of the port has "cpu" as a default or falls through
    to it: only the functions that make a tensor for a caller do."""
    import inspect

    from spindynamics_tpu_torch.solvers import kron_evolve, runners
    from spindynamics_tpu_torch.solvers import blockvec, kpm, lanczos
    from spindynamics_tpu_torch.utils.convert import blockvec_from_numpy

    fns = [pt.groundstate_kron, pt.kpm_sqw_kron, pt.evolve_trajectory_kron,
           pt.typicality_correlation_kron, kron_evolve.kron_planes_matvec_fn,
           pt.KronHamiltonian.__init__, pt.FlatHamiltonian.__init__,
           pt.matvec_fn, runners.run_chebyshev, runners.run_krylov,
           runners.evolve_trajectory, kpm.run_kpm_dynamical,
           lanczos.lanczos_groundstate, lanczos.lanczos_groundstate_twopass,
           lanczos.lanczos_groundstate_restarted, lanczos.lanczos_extremal,
           lanczos.estimate_energy_bounds, pt.basis_state_vector,
           pt.domain_wall_state, pt.neel_state, pt.polarized_state,
           pt.polarized_state_with_flips, blockvec.bv_random,
           blockvec.bv_basis_state, pt.lanczos_sqw_kron,
           pt.kpm_correlation_matrix_kron,
           # the sharded kron path: the mesh's device, else the card
           pt.ShardedKronHamiltonian.__init__, pt.LocalMesh.__init__,
           pt.sharded_kron_scaling_bv_matvec_fn, pt.mesh_from_topology,
           # flat typicality and the checkpointed ground state
           pt.thermal_state, pt.typicality_correlation_function,
           pt.lanczos_groundstate_checkpointed]
    for f in fns:
        p = inspect.signature(f).parameters["device"]
        assert p.default is None, f
    # the converters take their device from the caller: no default at all
    for f in (state_from_numpy, blockvec_from_numpy):
        p = inspect.signature(f).parameters["device"]
        assert p.default is inspect.Parameter.empty, f


# ---- a user-style drive of the port alone --------------------------------


def test_user_drive_L12_on_cpu():
    """build_model(layout="embedded") -> lanczos_groundstate ->
    evolve_trajectory at L=12 in float32 with device="cpu", checked against
    the dense oracle."""
    Lu = 12
    m = pt.build_model(Lu, nup=Lu // 2, hopping=pt.nn_hopping(Lu, 1.0),
                       zz=[(i, i + 1, 0.5) for i in range(Lu - 1)],
                       layout="embedded")
    mask = m.valid_mask()
    H = pt.build_dense_H(m)
    ev, U = np.linalg.eigh(H[np.ix_(mask.numpy(), mask.numpy())])
    mv = pt.matvec_fn(m, device="cpu")
    assert mv.backend == "blocked"
    E0, psi, info = pt.lanczos_groundstate(
        mv, m.n_states, lanc_m=80, mask=mask, reorth="selective",
        generator=torch.Generator().manual_seed(0), device="cpu")
    assert psi.dtype == torch.float32 and abs(E0 - ev[0]) < 1e-4
    assert info["residual"] < 1e-3 and not psi[~mask].any()
    psi_t, obs = pt.evolve_trajectory(
        m, pt.domain_wall_state(m, device="cpu"), dt=0.1, n_steps=10,
        cheb_n=40,
        generator=torch.Generator().manual_seed(7))
    assert psi_t.dtype == torch.complex64 and obs.shape == (10, Lu)
    c = U[np.searchsorted(np.nonzero(mask.numpy())[0], (1 << 6) - 1)]
    sz = ((np.nonzero(mask.numpy())[0][:, None] >> np.arange(Lu)) & 1) - 0.5
    for k in (1, 10):
        exact = np.abs(U @ (np.exp(-1j * ev * 0.1 * k) * c)) ** 2 @ sz
        assert np.abs(obs[k - 1] - exact).max() < 1e-5
    assert np.abs(obs.sum(axis=1)).max() < 1e-5
    assert not psi_t[~mask].any()
