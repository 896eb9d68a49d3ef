"""lanczos_sqw_kron, the Lanczos S(q, omega) on BlockVec kron states,
against the JAX function from the same numpy-carried ground state (both
plane modes), against the port's flat lanczos_sqw on the embedded layout for
the same model, the zero row at q = 0, the sum rule, and the refusals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spindynamics_tpu as sd
import spindynamics_tpu_torch as pt
from spindynamics_tpu.solvers import runners as jrun
from spindynamics_tpu.solvers.blockvec import BlockVec as JBV
from spindynamics_tpu_torch import observables_kron as tok
from spindynamics_tpu_torch.ops import kron_group as kg
from spindynamics_tpu_torch.solvers import runners as trun


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per test process, so
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(Jxy=1.0, Jz=0.7)
OMEGA = np.linspace(0.0, 4.0, 81)


def _ground_state(L, dtype=torch.float64):
    """(model, E0, psi, layout) of the port's kron ground state in float64
    on the CPU, converged far below every tolerance used here."""
    m = pt.xxz_chain(L, nup=L // 2, dtype=dtype, **KW)
    E0, psi, info, lay = pt.groundstate_kron(
        m, lanc_m=40, cycles=30, target_residual=1e-10, device="cpu",
        generator=torch.Generator().manual_seed(0))
    assert info["residual"] < 1e-9
    return m, E0, psi, lay


def _qs(L):
    return [0.0, 2 * np.pi * 3 / L, np.pi]


@pytest.mark.parametrize("plane_mode", ["pair", "split"])
@pytest.mark.parametrize("L,prec,lanc_m", [(12, "f64", 12), (14, "f64", 12),
                                           (10, "f32", 60)])
def test_lanczos_sqw_kron_matches_jax(L, prec, lanc_m, plane_mode):
    """The same ground state (numpy leaves) through both packages: float64
    to 1e-8 of the peak, float32 (the fused apply on both sides: Pallas
    interpret mode there, K1's plain version here) to 1e-4 of the peak.

    The two packages sum in different orders, and a Lanczos recurrence
    amplifies that difference once Ritz values converge (measured here:
    1e-11 of the peak at 12 steps, 1e-8 at 20, 1e-6 at 30 in float64). So
    the float64 cases stop at 12 steps, where a fault of the port would
    still show at 1e-8, and the float32 case runs 60 steps, past the
    dimension of the momentum subspace at L=10, where both spectra have
    converged and the comparison is of the converged answer."""
    m64, E0, psi, lay = _ground_state(L)
    jd, td, tol = ((jnp.float64, torch.float64, 1e-8) if prec == "f64"
                   else (jnp.float32, torch.float32, 1e-4))
    mj = sd.xxz_chain(L, nup=L // 2, dtype=jd, layout="sector_kron", **KW)
    mt = pt.xxz_chain(L, nup=L // 2, dtype=td, **KW)
    leaves = [l.numpy() for l in psi.leaves]
    kw = dict(lanc_m=lanc_m, eta=0.1, E0=E0, plane_mode=plane_mode)
    Sj, ij = jrun.lanczos_sqw_kron(
        mj, _qs(L), OMEGA, psi0=JBV([jnp.asarray(x, jd) for x in leaves]),
        **kw)
    n0 = kg.kernel_launch_count()
    St, it = trun.lanczos_sqw_kron(
        mt, _qs(L), OMEGA, psi0=pt.BlockVec([torch.tensor(x, dtype=td)
                                             for x in leaves]), **kw)
    assert kg.kernel_launch_count() == n0  # CPU tensors: the plain version
    assert St.shape == Sj.shape == (3, OMEGA.shape[0])
    assert it["plane_mode"] == ij["plane_mode"] == plane_mode
    assert it["E0"] == pytest.approx(E0)
    peak = float(np.abs(Sj).max())
    assert peak > 0.1
    assert np.abs(St - np.asarray(Sj)).max() <= tol * peak
    assert not St[0].any()  # q = 0 at Sz = 0: phi = 0, a zero row


def test_lanczos_sqw_kron_matches_flat_embedded():
    """The same model on two layouts: the kron runner from the kron ground
    state and the flat lanczos_sqw from the embedded-layout ground state
    (float64, both converged) give the same spectra: at 12 steps, before
    the recurrence amplifies the two layouts' summation orders."""
    L = 12
    m, E0, psi, lay = _ground_state(L)
    me = pt.xxz_chain(L, nup=L // 2, dtype=torch.float64, layout="embedded",
                      **KW)
    mv = pt.matvec_fn(me, device="cpu")
    Ef, psif, info = pt.lanczos_groundstate_restarted(
        mv, N=me.n_states, lanc_m=40, cycles=30, target_residual=1e-10,
        mask=me.valid_mask(), generator=torch.Generator().manual_seed(1),
        dtype=torch.float64, device="cpu")
    assert abs(Ef - E0) < 1e-9
    qs = _qs(L)[1:]
    Sk, _ = pt.lanczos_sqw_kron(m, qs, OMEGA, lanc_m=12, eta=0.1, psi0=psi,
                                E0=E0)
    Sf = pt.lanczos_sqw(psif, me, qs, OMEGA, lanc_m=12, eta=0.1, matvec=mv)
    peak = float(Sf.max())
    assert np.abs(Sk - Sf).max() <= 1e-7 * peak


@pytest.mark.parametrize("plane_mode", ["pair", "split"])
def test_sum_rule_and_zero_row(plane_mode):
    """The integrated weight of row q is ||S^z_q psi0||^2 (Gaussian poles:
    no tails leave the grid), and q = 0 in the Sz = 0 sector gives exactly
    zero without a division by the zero norm."""
    L = 10
    m, E0, psi, lay = _ground_state(L)
    qs = [0.0, 2 * np.pi * 2 / L, np.pi]
    om = np.arange(-1.0, 8.0, 0.01)
    S, _ = pt.lanczos_sqw_kron(m, qs, om, lanc_m=40, eta=0.05,
                               broaden="gauss", psi0=psi, E0=E0,
                               plane_mode=plane_mode)
    assert np.all(np.isfinite(S)) and not S[0].any()
    for q, row in zip(qs[1:], S[1:]):
        pr, pi = tok.bv_sz_q(psi, lay, q)
        n2 = sum(float((x * x).sum()) for P in (pr, pi) for x in P.leaves)
        assert row.min() >= 0.0
        assert abs(row.sum() * 0.01 - n2) < 1e-6 * n2


def test_runs_its_own_ground_state_and_refusals():
    """Without psi0 the runner solves the ground state first (float32, the
    fused route's plain version on the CPU); a mesh runs the same
    tridiagonalizations on row-sharded states; an unknown plane mode is
    refused; a fused float64 solve on CUDA raises before any tensor is
    made."""
    L = 10
    m = pt.xxz_chain(L, nup=L // 2, **KW)
    S, info = pt.lanczos_sqw_kron(m, [np.pi], OMEGA, lanc_m=30, eta=0.1,
                                  device="cpu")
    _, E0, psi, _ = _ground_state(L)
    assert info["residual"] <= 1e-3 and abs(info["E0"] - E0) < 1e-3
    S64, _ = pt.lanczos_sqw_kron(m, [np.pi], OMEGA, lanc_m=30, eta=0.1,
                                 psi0=psi, E0=E0)
    assert np.abs(S - S64).max() <= 2e-2 * S64.max()
    Sm, _ = pt.lanczos_sqw_kron(m, [np.pi], OMEGA, lanc_m=30, eta=0.1,
                                psi0=psi, E0=E0, mesh=pt.LocalMesh(2, "cpu"))
    assert np.abs(Sm - S64).max() <= 1e-4 * S64.max()
    with pytest.raises(ValueError, match="plane_mode"):
        pt.lanczos_sqw_kron(m, [np.pi], OMEGA, psi0=psi, E0=E0,
                            plane_mode="both")
    m64 = pt.xxz_chain(L, nup=L // 2, dtype=torch.float64, **KW)
    with pytest.raises(ValueError, match="fused=False"):
        pt.lanczos_sqw_kron(m64, [np.pi], OMEGA, device="cuda")
