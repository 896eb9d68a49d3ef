"""Flat quantum typicality of the port (solvers/typicality.py) against the
JAX package on the CPU: the RK4 step, the thermal state from the vector
the port draws, the correlation function against the JAX pieces composed
on the same thermal state, the three evolution methods against each other,
the exact thermal average at L=6, and an embedded thermal state that stays
in its sector (the last case of tests/test_embedded.py).

float64 models and complex128 states: one RK4 step 1e-13, a Krylov
imaginary-time step and the correlations built on it 1e-10; the methods
agree to 1e-5 (RK4's and Chebyshev's truncation at these step counts); the
sample mean of 16 draws to 0.05 of the exact average, the JAX package's
own tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu.solvers import chebyshev as jch
from spindynamics_tpu.solvers import krylov as jkr
from spindynamics_tpu.solvers import typicality as jty
from spindynamics_tpu_torch.solvers import typicality as tty
from spindynamics_tpu_torch.utils.convert import (
    model_from_numpy, state_from_numpy, state_to_numpy)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(L, nup, layout="compact"):
    mj = sd.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=nup, dtype=jnp.float64,
                      h=np.linspace(-0.2, 0.1, L))
    mt = model_from_numpy(mj.L, mj.nup, mj.hop_sites, np.asarray(mj.hop_J),
                          np.asarray(mj.field), mj.zz_sites,
                          np.asarray(mj.zz_J), layout=layout)
    return mj, mt


@pytest.fixture(scope="module")
def models():
    return _pair(8, 4)


def _t(x):
    return state_from_numpy(x, "cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_rk4_step_matches_jax(models):
    mj, mt = models
    rng = np.random.default_rng(2)
    x = rng.standard_normal(mj.n_states) + 1j * rng.standard_normal(
        mj.n_states)
    yj = np.asarray(jty.rk4_time_step(jnp.asarray(x), sd.matvec_fn(mj), 0.05))
    yt = pt.rk4_time_step(_t(x), pt.matvec_fn(mt, device="cpu"), 0.05)
    assert yt.dtype == torch.complex128
    assert np.abs(state_to_numpy(yt) - yj).max() <= 1e-13
    # a real state is lifted to complex, as in the JAX package
    yr = pt.rk4_time_step(_t(x.real), pt.matvec_fn(mt, device="cpu"), 0.05)
    yrj = np.asarray(jty.rk4_time_step(jnp.asarray(x.real), sd.matvec_fn(mj),
                                       0.05))
    assert yr.dtype == torch.complex128
    assert np.abs(state_to_numpy(yr) - yrj).max() <= 1e-13


def test_thermal_state_matches_jax_from_the_drawn_vector(models):
    """The port draws |r> from its generator (real plane, then imaginary);
    the same draw, repeated here, through the JAX package's Krylov
    imaginary-time step gives the same thermal state and Z."""
    mj, mt = models
    beta = 1.3
    psi_b, Z = pt.thermal_state(mt, beta, generator=_gen(4), kry_m=30,
                                dtype=torch.complex128)
    g = _gen(4)
    re = torch.randn(mt.n_states, generator=g, dtype=torch.float64)
    im = torch.randn(mt.n_states, generator=g, dtype=torch.float64)
    r = (re + 1j * im).numpy()
    r = r / np.linalg.norm(r)
    np.testing.assert_array_equal(
        tty.random_start(mt, _gen(4), torch.complex128, "cpu").numpy(), r)
    pj = np.asarray(jkr.krylov_imaginary_time_evolve(
        jnp.asarray(r), sd.matvec_fn(mj), beta / 2, kry_m=30))
    Zj = float(np.vdot(pj, pj).real)
    assert abs(Z - Zj) <= 1e-10 * Zj
    assert psi_b.dtype == torch.complex128
    assert np.abs(state_to_numpy(psi_b) - pj / np.sqrt(Zj)).max() <= 1e-10
    assert abs(float(torch.linalg.vector_norm(psi_b)) - 1) <= 1e-12
    # complex64 draws the same normals in float32
    p32, _ = pt.thermal_state(mt, beta, generator=_gen(4), device="cpu")
    assert p32.dtype == torch.complex64


@pytest.mark.parametrize("method", ["krylov", "chebyshev", "rk4"])
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64],
                         ids=["c128", "c64"])
def test_correlation_matches_jax_pieces(models, method, dtype):
    """C(t) of the port against the JAX package's evolution engines and
    operators composed on the port's thermal state (the same draw):
    complex128 1e-10, complex64 (the default, as in the JAX package) 1e-6."""
    mj, mt = models
    beta, ts, bounds = 0.7, [0.0, 0.2, 0.5], (-7.0, 7.0)
    C = pt.typicality_correlation_function(
        mt, beta, pt.make_spin_operator(2, "z"), pt.make_spin_operator(5, "z"),
        ts, method=method, generator=_gen(9), Ebounds=bounds, kry_m=30,
        cheb_n=40, rk4_substeps=20, dtype=dtype)
    psi_b, _ = pt.thermal_state(mt, beta, generator=_gen(9), kry_m=30,
                                dtype=dtype)
    psi_b = jnp.asarray(state_to_numpy(psi_b))
    mv = sd.matvec_fn(mj)

    def evolve(v, dt):
        if method == "krylov":
            return jkr.krylov_time_evolve(v, mv, dt, kry_m=30,
                                          renormalize=False)
        if method == "chebyshev":
            return jch.chebyshev_time_evolve(v, mv, dt, bounds, cheb_n=40)
        for _ in range(20):
            v = jty.rk4_time_step(v, mv, dt / 20)
        return v

    phi = sd.apply_spin_operator(psi_b, mj, 5, "z")
    xi, prev, want = psi_b, 0.0, []
    for t in ts:
        if t > prev:
            phi, xi = evolve(phi, t - prev), evolve(xi, t - prev)
        prev = t
        want.append(complex(jnp.vdot(xi, sd.apply_spin_operator(phi, mj, 2,
                                                                "z"))))
    assert C.dtype == np.complex128 and C.shape == (3,)
    tol = 1e-10 if dtype == torch.complex128 else 1e-6
    assert np.abs(C - np.asarray(want)).max() <= tol


def test_methods_agree(models):
    """The JAX package's test_typicality_correlation_methods_agree on the
    port: the same sample through three engines, at 1e-5."""
    _, mt = models
    op = pt.make_spin_operator(2, "z")
    kw = dict(generator=None, kry_m=40, cheb_n=40, rk4_substeps=40)
    out = {}
    for method in ("krylov", "chebyshev", "rk4"):
        kw["generator"] = _gen(3)
        out[method] = pt.typicality_correlation_function(
            mt, 0.5, op, op, [0.0, 0.2, 0.4], method=method, **kw)
    for method in ("chebyshev", "rk4"):
        assert np.abs(out[method] - out["krylov"]).max() <= 1e-5
    assert abs(out["krylov"][0].imag) <= 1e-7
    with pytest.raises(ValueError, match="unknown method"):
        pt.typicality_correlation_function(mt, 0.5, op, op, [0.0],
                                           method="euler", generator=_gen(0))


def test_matches_exact_thermal_average():
    """The pattern of tests/test_typicality.py at L=6 (20 states): the mean
    of 16 samples against Tr[e^{-beta H} Sz_a(t) Sz_b] / Z, and the mean
    energy of 12 thermal states against the exact thermal energy."""
    mj, mt = _pair(6, 3)
    H = sd.build_dense_H(mj)
    beta, ts, a, b = 1.0, [0.0, 0.3], 2, 3
    states = mt.basis_states().numpy()
    sza = np.diag(((states >> a) & 1) - 0.5)
    szb = np.diag(((states >> b) & 1) - 0.5)
    rho = scipy.linalg.expm(-beta * H)
    want = []
    for t in ts:
        U = scipy.linalg.expm(-1j * t * H)
        want.append(np.trace(rho @ U.conj().T @ sza @ U @ szb)
                    / np.trace(rho))
    got = np.mean([pt.typicality_correlation_function(
        mt, beta, pt.make_spin_operator(a, "z"), pt.make_spin_operator(b, "z"),
        ts, generator=_gen(seed), kry_m=20) for seed in range(16)], axis=0)
    assert np.allclose(got, want, atol=0.05)
    E = np.trace(rho @ H) / np.trace(rho)
    es = []
    for seed in range(12):
        psi_b, _ = pt.thermal_state(mt, beta, generator=_gen(seed), kry_m=20,
                                    dtype=torch.complex128)
        psi = psi_b.numpy()
        es.append(np.real(np.vdot(psi, H @ psi)))
    assert np.mean(es) == pytest.approx(E, abs=0.25)


def test_embedded_thermal_state_stays_in_sector():
    """tests/test_embedded.py's seventh case on the port: the draw is
    masked to the sector and the Krylov step keeps it there exactly; the
    thermal energy equals the compact layout's to the sampling spread."""
    _, me = _pair(8, 4, layout="embedded")
    psi_b, Z = pt.thermal_state(me, 1.0, generator=_gen(1), kry_m=20,
                                dtype=torch.complex128)
    mask = me.valid_mask()
    assert not psi_b[~mask].any() and Z > 0
    assert abs(float(torch.linalg.vector_norm(psi_b)) - 1) <= 1e-12
    C = pt.typicality_correlation_function(
        me, 1.0, pt.make_spin_operator(3, "z"), pt.make_spin_operator(3, "z"),
        [0.0, 0.4], generator=_gen(1), kry_m=20)
    # <Sz_3^2> = 1/4 on every basis state
    assert abs(C[0] - 0.25) <= 1e-6 and np.all(np.isfinite(C))
