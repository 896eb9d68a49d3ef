"""The compact layout, flat typicality and checkpoint/resume on the card
(marked `gpu`: they need a CUDA device and skip elsewhere). Imports no jax,
so it also runs where JAX is not installed:
python -m pytest --noconftest tests/test_torch_cuda_compact.py"""

import numpy as np
import pytest
import torch

import spindynamics_tpu_torch as pt
from spindynamics_tpu_torch.model import sector_setup


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the card's torch build runs only on a CUDA device")
    return torch.device("cuda")


def _model(L, kind, dtype=torch.float32):
    if kind == "longrange":
        return pt.build_model(
            L, nup=L // 2, layout="compact", dtype=dtype,
            hopping=pt.long_range_hopping(L, lambda i, j: 1.0 / (j - i)),
            onsite_field=np.linspace(-0.2, 0.3, L))
    return pt.xxz_chain(L, Jxy=1.0, Jz=0.5, h=np.linspace(-0.2, 0.3, L),
                        nup=L // 2, layout="compact", dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("L,kind", [(12, "chain"), (16, "chain"),
                                    (13, "longrange")])
def test_card_build_equals_host_build(cuda_device, L, kind):
    """States and ELL table of the torch build on the card equal the host
    numpy build exactly; the diagonal to float64 rounding."""
    m = _model(L, kind, torch.float64)
    s_d, d_d, t_d = sector_setup(m, cuda_device)
    s_h, d_h, t_h = sector_setup(m, "cpu")
    assert s_d.device.type == "cuda" and t_d.dtype == torch.int32
    assert torch.equal(s_d.cpu(), s_h) and torch.equal(t_d.cpu(), t_h)
    assert (d_d.cpu() - d_h).abs().max() <= 1e-12
    assert torch.equal(m.basis_states(cuda_device).cpu(), s_h)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
def test_ell_apply_on_card_matches_cpu(cuda_device, dtype, tol, cplx):
    """The ell apply on the card (the ell kernel, float64 included) against
    the CPU apply of the same vector, tol of max|y|; repeats
    bit-identical."""
    m = _model(16, "chain", dtype)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(m.n_states, generator=g, device=cuda_device, dtype=dtype)
    if cplx:
        x = torch.complex(x, torch.randn(m.n_states, generator=g,
                                         device=cuda_device, dtype=dtype))
    mv = pt.matvec_fn(m)  # the card by default
    assert mv.backend == "ell" and mv.nbr.device.type == "cuda"
    y = mv(x)
    want = pt.matvec_fn(m, device="cpu")(x.cpu())
    assert (y.cpu() - want).abs().max() <= tol * want.abs().max()
    assert torch.equal(y, mv(x))
    assert torch.equal(y, pt.apply_H(x, m))


@pytest.mark.gpu
def test_checkpoint_resumes_on_card(cuda_device, tmp_path):
    """A checkpointed ground state cut after 2 cycles and resumed to 4, and
    a trajectory cut after 3 of 5 steps and resumed, equal the
    uninterrupted runs bit for bit on the card."""
    m = _model(14, "chain")
    mv = pt.matvec_fn(m)

    def gs(path, cycles):
        return pt.lanczos_groundstate_checkpointed(
            mv, m.n_states, str(tmp_path / path), lanc_m=20, cycles=cycles,
            generator=torch.Generator(device=cuda_device).manual_seed(0))

    E_a, psi_a, _ = gs("a", 4)
    gs("b", 2)
    E_b, psi_b, info = gs("b", 4)
    assert psi_b.device.type == "cuda" and info["resumed_at"] == 2
    assert E_a == E_b and torch.equal(psi_a, psi_b)
    psi0 = pt.domain_wall_state(m)
    kw = dict(dt=0.1, cheb_n=30,
              generator=torch.Generator(device=cuda_device).manual_seed(7))
    p_a, o_a = pt.evolve_trajectory(m, psi0, n_steps=5, **kw)
    ck = str(tmp_path / "traj")
    kw["generator"] = torch.Generator(device=cuda_device).manual_seed(7)
    pt.evolve_trajectory(m, psi0, n_steps=3, checkpoint_dir=ck,
                         checkpoint_every=1, **kw)
    p_b, o_b = pt.evolve_trajectory(m, psi0, n_steps=5, checkpoint_dir=ck,
                                    resume=True, **kw)
    assert torch.equal(p_a, p_b) and np.array_equal(o_a, o_b)


@pytest.mark.gpu
def test_typicality_on_card(cuda_device):
    """One typicality sample on the compact and embedded layouts on the
    card: C(0) = <Sz^2> = 1/4, finite values, the layouts' samples agree in
    kind (both finite, C(0) exact)."""
    op = pt.make_spin_operator(6, "z")
    for layout in ("compact", "embedded"):
        m = pt.xxz_chain(12, nup=6, layout=layout)
        C = pt.typicality_correlation_function(
            m, 1.0, op, op, [0.0, 0.5],
            generator=torch.Generator(device=cuda_device).manual_seed(1))
        assert np.all(np.isfinite(C)) and abs(C[0] - 0.25) <= 1e-6
