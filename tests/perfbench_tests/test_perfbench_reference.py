"""The float64 reference on the CPU: its H against a dense matrix built here
from the model's definition, its reading of the port's two layouts
against the port's own state order, its KPM rows against the port's, and
the bfloat16 control failing the limits the program passes."""

import json
import math

import numpy as np
import pytest
import torch

from _perfbench_tree import REPO
from perfbench import reference as R

F64 = torch.float64


def _dense(L, nup, Jxy, Jz):
    """H on the sector in ascending order, from the definition: each
    antiparallel bond flipped with amplitude Jxy, Jz Sz_i Sz_i+1."""
    states = [s for s in range(1 << L) if bin(s).count("1") == nup]
    idx = {s: i for i, s in enumerate(states)}
    H = np.zeros((len(states), len(states)))
    for s in states:
        i = idx[s]
        for j in range(L - 1):
            a, b = (s >> j) & 1, (s >> (j + 1)) & 1
            H[i, i] += Jz * (a - 0.5) * (b - 0.5)
            if a != b:
                H[idx[s ^ (3 << j)], i] += Jxy
    return H


@pytest.mark.parametrize("L, nup, Jz", [(8, 4, 1.0), (9, 3, 0.5),
                                        (10, 5, 1.0)])
def test_block_apply_is_the_dense_H(L, nup, Jz):
    H = R.BlockChain(L, nup, 1.0, Jz, "cpu")
    x = torch.randn(H.n, dtype=F64, generator=torch.Generator()
                    .manual_seed(L))
    want = H.from_flat(torch.from_numpy(_dense(L, nup, 1.0, Jz)
                                        @ x.numpy()))
    assert torch.allclose(H(H.from_flat(x)), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("L", [12, 16, 18])
def test_from_kron_reads_the_port_order(L):
    """The kron layout's order worked out again from its rule: equal to
    the port's kron_order_states, and the port's plain kron apply read
    through it equals the reference's apply."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops.sector_kron import (
        kron_order_states, make_sector_kron_layout)
    from spindynamics_tpu_torch.solvers.blockvec import BlockVec

    nup = L // 2
    H = R.BlockChain(L, nup, 1.0, 1.0, "cpu")
    m = pt.xxz_chain(L, Jxy=1.0, Jz=1.0, nup=nup, dtype=F64,
                     layout="sector_kron")
    lay = make_sector_kron_layout(m, m.kron_splits, m.kron_pads)
    assert R.kron_splits(L) == tuple(lay.splits)
    st = kron_order_states(L, nup, lay.splits, lay.pads).astype(np.int64)
    pad = st == 0xFFFFFFFF
    flat_states = np.array([s for s in range(1 << L)
                            if bin(s).count("1") == nup])
    x = torch.randn(H.n, dtype=F64, generator=torch.Generator()
                    .manual_seed(1))
    vals = np.where(pad, 0.0, x.numpy()[np.searchsorted(
        flat_states, np.where(pad, 0, st))])
    leaves, off = [], 0
    for (_, _, _, ch, _, _, cmp, clp) in lay.groups:
        n = ch * cmp * clp
        leaves.append(torch.from_numpy(vals[off:off + n]).view(ch, cmp, clp))
        off += n
    blocks, pad_max = H.from_kron(leaves)
    assert pad_max == 0.0 and torch.equal(blocks, H.from_flat(x))
    hk = pt.KronHamiltonian(lay, dtype=F64, device="cpu", fused=False)(
        BlockVec(leaves))
    got, _ = H.from_kron(hk.leaves)
    assert torch.allclose(got, H(blocks), rtol=0, atol=1e-12)
    # a value in a pad slot is seen
    leaves[-1][0, -1, -1] = 1.0
    assert H.from_kron(leaves)[1] == 1.0


def test_moments_with_the_product_identities_are_the_recurrence():
    H = R.BlockChain(10, 5, 1.0, 1.0, "cpu")
    phi = torch.randn(H.n, dtype=F64, generator=torch.Generator()
                      .manual_seed(2))
    phi /= phi.norm()
    a, b = 10.0, -1.0
    t = [phi, (H(phi) - b * phi) / a]
    for _ in range(7):
        t.append(2 * (H(t[-1]) - b * t[-1]) / a - t[-2])
    plain = np.array([float(phi @ v) for v in t])
    assert np.allclose(R.moments(H, phi, a, b, 9), plain, rtol=0,
                       atol=1e-13)


@pytest.mark.parametrize("layout", ["sector_kron", "compact"])
def test_rows_and_ground_state_of_the_port_pass(layout):
    """The port's float32 ground state and KPM row at L=12 (CPU, plain
    applies) read within the cells' limits; the row at 1e-5 of its peak."""
    import spindynamics_tpu_torch as pt

    L, nup = 12, 6
    H = R.BlockChain(L, nup, 1.0, 1.0, "cpu")
    omega = np.linspace(0.0, 6.0, 300)
    q = 2 * math.pi * 4 / L
    g = torch.Generator().manual_seed(0)
    if layout == "compact":
        m = pt.heisenberg_chain(L, nup=nup, layout="compact")
        mv = pt.matvec_fn(m, device="cpu")
        E0, psi, info = pt.lanczos_groundstate_restarted(
            mv, N=m.n_states, lanc_m=40, cycles=6, target_residual=1e-3,
            generator=g, device="cpu")
        a, b = 9.0, -1.0
        S = pt.kpm_sqw(psi, m, [q], omega, a=a, b=b, kpm_m=100, E0=E0,
                       matvec=mv)[0].numpy()
        blocks = H.from_flat(psi)
    else:
        m = pt.xxz_chain(L, Jxy=1.0, Jz=1.0, nup=nup, layout="sector_kron")
        E0, psi, info, _ = pt.groundstate_kron(m, generator=g, device="cpu")
        S, kinfo = pt.kpm_sqw_kron(m, [q], omega, psi0=psi, E0=E0,
                                   info=info, device="cpu")
        S, a, b = S[0], kinfo["a"], kinfo["b"]
        blocks, _ = H.from_kron(psi.leaves)
    E, residual = R.energy(H, blocks)
    assert residual(float(E0)) <= 1e-3 and abs(E - float(E0)) < 1e-5
    S_ref, mu_max = R.sqw_row(H, blocks, q, omega, float(E0), a, b, 100)
    assert R.row_deviation(S, S_ref) <= 1e-5 and mu_max <= 1.0 + 1e-12


def test_bf16_control_fails_the_limits():
    """The control: the reference put in the program's place with
    bfloat16 storage, at L=12. Its ground state misses the residual the
    configurations state, its row at q = pi misses the traffic's limit of
    such a row (the float32 program reads under 1e-5 here, above)."""
    cfg = json.loads((REPO / "perfbench" / "configs"
                      / "heisenberg_open_L32_sz0_kron.json").read_text())
    lim = json.loads((REPO / "perfbench" / "traffic"
                      / "gs_sqw.L32.json").read_text())["limits"]
    H = R.BlockChain(12, 6, 1.0, 1.0, "cpu")
    E, psi, r = R.ground_state(H, torch.Generator().manual_seed(3), m=40,
                               cycles=6, tol=1e-3, store=torch.bfloat16)
    assert r > cfg["guarantees"]["residual_target"]
    E64, psi64, r64 = R.ground_state(H, torch.Generator().manual_seed(3))
    assert r64 <= 1e-9
    omega = np.linspace(0.0, 6.0, 300)
    q = 2 * math.pi * 6 / 12
    S64, _ = R.sqw_row(H, psi64, q, omega, E64, 9.0, -1.0, 100)
    S16, _ = R.sqw_row(H, psi64, q, omega, E64, 9.0, -1.0, 100,
                       store=torch.bfloat16)
    assert R.row_deviation(S16, S64) > lim["row_pi"]  # q = pi
