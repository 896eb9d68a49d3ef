"""Ground state, S(q, omega) and dynamical-correlation entry points on the
sector_kron layout (port of the unsharded kron parts of
spindynamics_tpu/solvers/runners.py), and the flat runners.

groundstate_kron: restarted two-pass Lanczos (+ Chebyshev-filter polish) on
BlockVec states, every H apply through KronHamiltonian (K1 on CUDA when
fused; float32 only). kpm_sqw_kron: Chebyshev moments of S^z_q|psi0> held as
two real planes, through the same apply. lanczos_sqw_kron: the second
spectral path, a basis-free Lanczos tridiagonalization of the same plane
pair. kpm_correlation_matrix_kron: |S_{Sz_i Sz_j}(omega)| for all site
pairs, one Chebyshev recurrence per B site with the moments against every
A site from one marginal pass.

Every kron runner takes `mesh=` (a LocalMesh or a ProcessMesh,
parallel/mesh.py) and then runs the whole solve on row-sharded BlockVecs:
the apply is the block-distributed one (parallel/sharded_kron_scaling.py,
K1 on each shard's local block), the start, psi0 and every recurrence
vector stay in sharded form, every dot ends in the mesh's all-reduce, and
the observables are summed per shard: no state is gathered anywhere.

The flat runners (run_chebyshev, run_krylov, evolve_trajectory) take full,
embedded and compact models; evolve_trajectory and
lanczos_groundstate_checkpointed (flat or BlockVec states) save and resume
through utils/checkpoint.py, bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.kron_group import KronHamiltonian
from ..ops.sector_kron import make_sector_kron_layout
from ..utils.compensated import vdot2
from ..utils.device import resolve_device
from ..utils.dtypes import complex_dtype
from .blockvec import BlockVec, bv_random, bv_reduce

__all__ = ["groundstate_kron", "kpm_sqw_kron", "lanczos_sqw_kron",
           "kpm_correlation_matrix_kron", "run_chebyshev", "run_krylov",
           "evolve_trajectory", "lanczos_groundstate_checkpointed"]


def _kron_matvec_for(lay, fused: bool, dtype, device, mesh=None):
    """The H apply of a kron runner on BlockVec states of `dtype`:
    KronHamiltonian with K1 (`fused`) or the plain blocks apply, or, with
    `mesh`, the ShardedKronHamiltonian over it (K1 on each shard's local
    block, or the plain apply there). K1 takes float32 (and bfloat16)
    states only: on the CPU a `fused` solve in float64 runs the plain
    apply, as in the JAX package; on CUDA it raises."""
    if fused and dtype != torch.float32:
        if device.type == "cuda":
            raise ValueError(f"fused=True runs K1, which takes float32 "
                             f"states, not {dtype}: pass fused=False or "
                             "dtype=torch.float32")
        fused = False
    if mesh is not None:
        from ..parallel.sharded_kron_scaling import ShardedKronHamiltonian

        return ShardedKronHamiltonian(lay, mesh, dtype=dtype, device=device,
                                      fused=fused)
    return KronHamiltonian(lay, dtype=dtype, device=device, fused=fused)


def _state_dtype_of(model):
    """The state dtype of the spectral kron runners: a float64 model keeps
    float64 states (validation runs); everything else runs float32."""
    return (model.dtype if model.dtype in (torch.float32, torch.float64)
            else torch.float32)


def groundstate_kron(model, lanc_m: int = 40, cycles: int = 6,
                     target_residual: float | None = 1e-3,
                     generator: torch.Generator | None = None,
                     fused: bool = True, dtype: torch.dtype | None = None,
                     device=None, v0: BlockVec | None = None, mesh=None,
                     reorth=None):
    """Ground state of a sector_kron model in BlockVec form.

    The apply is K1 (`fused`, float32) or the plain blocks apply. K1 takes
    float32 states only: on the CPU a `fused` solve in another dtype runs
    the plain blocks apply, as in the JAX package; on CUDA it raises (pass
    fused=False or dtype=torch.float32). The start is `v0` (copied, e.g. a
    numpy-made start through utils.convert.blockvec_from_numpy) or a random
    BlockVec from `generator` (default: seed 0 on `device`). `device`
    defaults to v0's device, else the card (utils.device.resolve_device:
    without CUDA it raises; pass device="cpu" for a CPU run).

    `mesh` runs the whole solve sharded: the apply is the block-distributed
    one, the start (the same draw as without a mesh, or `v0`, plain or
    already in sharded form) and the returned Ritz vector stay in sharded
    form on the mesh (under a ProcessMesh each rank holds its rows), and
    the bucketed Ritz finalize asks the sharded apply for a few groups at a
    time. `device` then defaults to the mesh's.

    `reorth` = "selective" | "full" runs ONE stored-basis Lanczos cycle
    with omega-triggered or every-step reorthogonalization
    (lanczos_groundstate on BlockVec states) instead of the restarted
    two-pass; `cycles` and `target_residual` are then ignored, and the
    apply folds no axpy into K1's seed. Memory is O(lanc_m N): use it where
    the basis fits.

    Returns (E0, psi, info, layout)."""
    if dtype is None:
        dtype = model.dtype
    device = resolve_device(device, v0, mesh)
    lay = make_sector_kron_layout(model, model.kron_splits, model.kron_pads)
    mv = _kron_matvec_for(lay, fused, dtype, device, mesh)
    if v0 is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        v0 = bv_random(lay, generator, dtype, device, shard=mv.shard)
    else:
        # the solver normalizes its start in place
        v0 = mv.to_mesh(v0).map(
            lambda l: l.to(device=device, dtype=dtype, copy=True))
    from .lanczos import lanczos_groundstate, lanczos_groundstate_restarted

    if reorth:
        E0, psi, info = lanczos_groundstate(mv, None, lanc_m=lanc_m,
                                            dtype=dtype, reorth=reorth, v0=v0)
        return E0, psi, info, lay
    finalize = _make_bucketed_finalize(lay, mesh)

    E0, psi, info = lanczos_groundstate_restarted(
        mv, v0, lanc_m=lanc_m, cycles=cycles,
        target_residual=target_residual, finalize=finalize)
    return E0, psi, info, lay


def _make_bucketed_finalize(layout, mesh=None, n_buckets: int = 4):
    """Memory-lean Ritz finalize for BlockVec kron states.

    Normalizes psi in place, then two sweeps over group buckets with
    `matvec(psi, groups=bucket)` (H psi for those groups alone: the
    group-filtered plain apply of a KronHamiltonian, or the sharded apply
    on sharded leaves, which exchanges only those groups' windows and
    partials; the dots end in `mesh`'s all-reduce): sweep 1 accumulates E =
    <psi|H|psi>, sweep 2 ||(H psi)_g - E psi_g||^2. Peak memory is psi +
    one bucket of outputs. Kept from the JAX package, where a full H psi
    beside psi brushed the 16 GB ceiling at L=32; on 80 GB it stays for
    parity."""
    n_groups = len(layout.groups)
    edges = np.linspace(0, n_groups, n_buckets + 1).astype(int)
    buckets = [tuple(range(edges[i], edges[i + 1])) for i in range(n_buckets)
               if edges[i] < edges[i + 1]]

    def finalize(matvec, psi_unnorm):
        leaves = list(psi_unnorm.leaves)
        del psi_unnorm

        def apply_groups(leaves, b):
            return matvec(BlockVec(leaves, mesh), groups=b).leaves

        def total(x):  # over this process's rows, then over the mesh
            return x if mesh is None else mesh.all_reduce_sum(x)

        nrm = torch.sqrt(torch.clamp(
            total(sum(vdot2(x, x) for x in leaves)), min=0.0))
        inv = 1.0 / nrm
        for x in leaves:
            x.mul_(inv.to(x.dtype))
        E = 0
        for b in buckets:
            h = apply_groups(leaves, b)
            E = E + sum(vdot2(leaves[g], h[g]) for g in b)
        E = total(E)
        r2 = 0
        for b in buckets:
            h = apply_groups(leaves, b)
            r2 = r2 + sum(vdot2(h[g] - leaves[g] * E, h[g] - leaves[g] * E)
                          for g in b)
        resid = torch.sqrt(torch.clamp(total(r2), min=0.0))
        return BlockVec(leaves, mesh), E, resid

    return finalize


def _norm2_plain(bv: BlockVec):
    """||bv||^2 by plain per-leaf dots (summed over the mesh's processes
    for a sharded state)."""
    return bv_reduce(sum(torch.dot(x.reshape(-1), x.reshape(-1))
                         for x in bv.leaves), bv)


def _phi_planes(psi: BlockVec, weights):
    """phi = S^z_q psi as an (re, im) pair of BlockVecs + per-plane
    ||.||^2."""
    from ..observables_kron import bv_sz_q_apply

    pr, pi = bv_sz_q_apply(psi, weights)
    return pr, pi, _norm2_plain(pr), _norm2_plain(pi)


def kpm_sqw_kron(model, q_list, omega, kpm_m: int = 100, lanc_m: int = 40,
                 cycles: int = 6, target_residual: float | None = 1e-3,
                 kernel: str = "jackson",
                 generator: torch.Generator | None = None, bounds_m: int = 40,
                 doubling_trick: bool = True, fused: bool = True,
                 psi0: BlockVec | None = None, E0=None, info=None,
                 safety: float = 0.01, bounds=None, device=None, mesh=None):
    """T=0 dynamic structure factor S(q, omega) at kron BlockVec scale.

    Ground state via groundstate_kron (unless psi0 and E0 are given), then
    per q: phi_q = S^z_q|psi0> as (re, im) REAL planes, normalized, and the
    diagonal Chebyshev moments of each plane through the same apply
    (T_n(H~) is real symmetric, so the plane moments add). Spectral bounds:
    Emin = E0, Emax from one Lanczos run from a random start (seed 7),
    expanded by `safety`; or `bounds=(lo, hi)` as given. Everything runs in
    float32. The q-points run serially (peak memory independent of
    len(q_list)); kept from the JAX package for parity.

    `mesh` runs the ground state, phi's construction (the hi weights cut
    to each shard's rows) and every moment recurrence on sharded BlockVecs;
    a given psi0 may be plain or already in sharded form.

    `device` defaults to psi0's device, else the mesh's, else the card
    (pass device="cpu" for a CPU run). Returns (S [nq, n_omega] numpy, info
    dict with E0/bounds/a/b)."""
    from .chebyshev import chebyshev_moments, kpm_reconstruct
    from .lanczos import lanczos_iteration, tridiag_eigh
    from ..observables_kron import bv_sz_q_weights

    device = resolve_device(device, psi0, mesh)
    if psi0 is None or E0 is None:
        E0, psi0, info, lay = groundstate_kron(
            model, lanc_m=lanc_m, cycles=cycles,
            target_residual=target_residual, generator=generator,
            fused=fused, device=device, mesh=mesh)
    else:
        lay = make_sector_kron_layout(model, model.kron_splits,
                                      model.kron_pads)
    info = dict(info or {})
    mv = _kron_matvec_for(lay, fused, torch.float32, device, mesh)
    shard, to_mesh = mv.shard, mv.to_mesh

    if bounds is None:
        g7 = torch.Generator(device=device).manual_seed(7)
        fac = lanczos_iteration(
            mv, bv_random(lay, g7, torch.float32, device, shard=shard),
            bounds_m)
        evals, _ = tridiag_eigh(fac.alphas, fac.betas, fac.m_eff)
        lo, hi = min(float(evals.min()), float(E0)), float(evals.max())
        pad = safety * 0.5 * (hi - lo) + 1e-6
    else:
        (lo, hi), pad = bounds, 0.0
    a = (hi - lo + 2 * pad) / 2.0
    b = (hi + lo) / 2.0
    a_inv = torch.tensor(1.0 / a, dtype=torch.float32, device=device)
    bb = torch.tensor(b, dtype=torch.float32, device=device)

    def mvr(bv):
        return (mv(bv) - bv * bb) * a_inv

    psi0 = to_mesh(psi0).map(
        lambda l: l.to(device=device, dtype=torch.float32))
    hi_lens = [l.shape[0] for l in psi0.leaves]

    S_rows, n2s = [], []
    for q in q_list:
        phi_r, phi_i, n2r, n2i = _phi_planes(
            psi0, bv_sz_q_weights(lay, float(q), hi_lens, mesh=mesh))
        n2 = float(n2r) + float(n2i)
        n2s.append(n2)
        if n2 <= 0.0:
            S_rows.append(np.zeros(kpm_m, np.float32))  # placeholder row
            continue
        inv = torch.tensor(1.0 / np.sqrt(n2), dtype=torch.float32,
                           device=device)
        mu = (chebyshev_moments(mvr, phi_r * inv, kpm_m,
                                doubling_trick=doubling_trick)
              + chebyshev_moments(mvr, phi_i * inv, kpm_m,
                                  doubling_trick=doubling_trick))
        S_rows.append(mu.cpu().numpy().astype(np.float32))

    om = np.asarray(omega, np.float64) + float(E0)
    S = np.zeros((len(q_list), len(np.atleast_1d(omega))), np.float32)
    for i, (mu_row, n2) in enumerate(zip(S_rows, n2s)):
        if n2 <= 0.0:
            continue
        S[i] = kpm_reconstruct(torch.as_tensor(mu_row), om, a, b,
                               kernel=kernel, doubling=True,
                               density_2_over_a=False).numpy()
    info.update(E0=float(E0), bounds=(lo - pad, hi + pad), a=a, b=b)
    return S, info


def lanczos_sqw_kron(model, q_list, omega, lanc_m: int = 100,
                     eta: float = 0.05, broaden: str = "lorentz",
                     gs_lanc_m: int = 40, cycles: int = 6,
                     target_residual: float | None = 1e-3,
                     generator: torch.Generator | None = None,
                     fused: bool = True, psi0: BlockVec | None = None,
                     E0=None, info=None, tol: float = 1e-12, mesh=None,
                     plane_mode: str = "pair", device=None):
    """T=0 dynamic structure factor S(q, omega) via Lanczos at kron BlockVec
    scale: the second spectral path at this layout (kpm_sqw_kron is the KPM
    one; ref src/LanczosSqw.jl:49-76).

    Ground state via groundstate_kron (unless psi0 and E0 are given), then
    per q: phi_q = S^z_q|psi0> as an (re, im) pair of REAL planes, a
    basis-free Lanczos tridiagonalization of H from that pair through the
    same apply (kron_evolve.lanczos_tridiag_pair), and pole broadening on
    the host with weights |Q[0, :]|^2 ||phi||^2 at omega = theta - E0.
    The q-points run serially, so peak memory does not grow with
    len(q_list): the ground state plus the pair recurrence, which in eager
    torch holds about a dozen state-sized vectors at its peak (three plane
    pairs and the temporaries of the three-term update).

    plane_mode: "pair" (the default on every device: the reference's
    complex recurrence on the plane pair) or "split" (S_phi = S_re + S_im,
    exact for real H and real psi0, from two independent real-plane
    tridiagonalizations; the same number of applies, another finite-m
    estimator). A phi of zero norm (q = 0 at Sz = 0) gives a zero row; the
    guard runs before any division. A float64 model keeps float64 states;
    everything else runs float32. `mesh` runs the ground state and every
    tridiagonalization on sharded BlockVecs (psi0 plain or in sharded
    form). `device` defaults to psi0's, else the mesh's, else the card.
    Returns (S [nq, n_omega] numpy, info with E0 and plane_mode)."""
    from ..observables_kron import bv_sz_q_weights
    from .kron_evolve import lanczos_tridiag_pair
    from .lanczos import lanczos_iteration
    from .lanczos_sqw import spectral_from_tridiagonal_batched

    if plane_mode not in ("pair", "split"):
        raise ValueError(f"unknown plane_mode {plane_mode!r}")
    device = resolve_device(device, psi0, mesh)
    rdt = _state_dtype_of(model)
    if psi0 is None or E0 is None:
        E0, psi0, info, lay = groundstate_kron(
            model, lanc_m=gs_lanc_m, cycles=cycles,
            target_residual=target_residual, generator=generator,
            fused=fused, device=device, mesh=mesh)
    else:
        lay = make_sector_kron_layout(model, model.kron_splits,
                                      model.kron_pads)
    info = dict(info or {})
    mv = _kron_matvec_for(lay, fused, rdt, device, mesh)

    def pmv(pair):
        return mv(pair[0]), mv(pair[1])

    psi0 = mv.to_mesh(psi0).map(
        lambda l: l.to(device=device, dtype=rdt))
    hi_lens = [l.shape[0] for l in psi0.leaves]
    wdt = np.float64 if rdt == torch.float64 else np.float32

    # (q index, alphas, betas, norm) per tridiagonalization; the spectra
    # of one q add up
    entries = []
    for iq, q in enumerate(q_list):
        phi_r, phi_i, n2r, n2i = _phi_planes(
            psi0, bv_sz_q_weights(lay, float(q), hi_lens, dtype=wdt,
                                  mesh=mesh))
        n2r, n2i = float(n2r), float(n2i)
        if n2r + n2i <= 0.0:
            continue  # zero row
        if plane_mode == "pair":
            al, be, nrm = lanczos_tridiag_pair(
                pmv, (phi_r, phi_i), lanc_m=lanc_m, tol=tol)
            entries.append((iq, al.numpy(), be.numpy(), float(nrm)))
            continue
        for phi, n2 in ((phi_r, n2r), (phi_i, n2i)):
            if n2 <= 1e-12 * (n2r + n2i):
                continue  # e.g. the sin plane at q = pi
            fac = lanczos_iteration(mv, phi, lanc_m, tol=tol)
            entries.append((iq, fac.alphas.numpy(),
                            fac.betas.numpy()[: lanc_m - 1],
                            float(fac.v0_norm)))
    S = np.zeros((len(q_list), len(np.atleast_1d(omega))))
    if entries:
        rows = spectral_from_tridiagonal_batched(
            np.stack([e[1] for e in entries]),
            np.stack([e[2] for e in entries]),
            np.asarray([e[3] for e in entries]),
            float(E0), omega, eta=eta, broaden=broaden)
        for (iq, *_rest), row in zip(entries, rows):
            S[iq] += row
    info.update(E0=float(E0), plane_mode=plane_mode)
    return S, info


def kpm_correlation_matrix_kron(model, omega, n: int = 300,
                                lanc_m: int = 40, cycles: int = 6,
                                target_residual: float | None = 1e-3,
                                kernel: str = "jackson",
                                generator: torch.Generator | None = None,
                                bounds_m: int = 40, fused: bool = True,
                                psi0: BlockVec | None = None, E0=None,
                                info=None, safety: float = 0.01, a=None,
                                b=None, mesh=None, sites=None, device=None):
    """C[i, j, omega] = |S_{Sz_i Sz_j}(omega)| for all site pairs at kron
    BlockVec scale (flat version: solvers/kpm.kpm_correlation_matrix; ref
    src/TimeEvolution/KPM.jl:214-235, 72-116).

    Per B site j, one after another: phi_j = Sz_j|psi0> normalized, the
    Chebyshev recurrence v_n = T_n(H~)|phi_j> through the same apply as the
    ground state, and per step the moments against ALL A sites in one pass
    over the state (observables_kron.bv_site_moments on psi0 * v_n: Sz_i is
    diagonal, so mu_n[i] = <psi0|Sz_i|v_n> is a weighted-Sz sum). Each
    v_{n+1} is written over v_{n-1}'s storage, so the recurrence holds
    psi0 plus three BlockVecs (and the temporaries of one rescaled apply)
    whatever L. The reference's second KPM convention: no
    doubling of the n >= 1 terms, the 2/a density, abs; the flat path uses
    the same, so the two agree.

    `sites` restricts the B loop (C is then [L, len(sites), W]); (a, b)
    given skip the bounds Lanczos (start: seed 7 on `device`). A float64
    model keeps float64 states. `mesh` runs psi0 and every recurrence on
    sharded BlockVecs: each process sums the marginals of its rows, and
    the [L] moments of a step end in one all-reduce. `device` defaults to
    psi0's, else the mesh's, else the card.
    Returns (C [L, n_sites, n_omega] numpy, info)."""
    from ..observables_kron import bv_apply_sz, bv_site_moments
    from .chebyshev import kpm_reconstruct
    from .lanczos import lanczos_iteration, tridiag_eigh

    device = resolve_device(device, psi0, mesh)
    rdt = _state_dtype_of(model)
    if psi0 is None or E0 is None:
        E0, psi0, info, lay = groundstate_kron(
            model, lanc_m=lanc_m, cycles=cycles,
            target_residual=target_residual, generator=generator,
            fused=fused, device=device, mesh=mesh)
    else:
        lay = make_sector_kron_layout(model, model.kron_splits,
                                      model.kron_pads)
    info = dict(info or {})
    mv = _kron_matvec_for(lay, fused, rdt, device, mesh)
    shard = mv.shard
    psi0 = mv.to_mesh(psi0).map(lambda l: l.to(device=device, dtype=rdt))

    if a is None or b is None:
        g7 = torch.Generator(device=device).manual_seed(7)
        fac = lanczos_iteration(
            mv, bv_random(lay, g7, rdt, device, shard=shard), bounds_m)
        evals, _ = tridiag_eigh(fac.alphas, fac.betas, fac.m_eff)
        lo, hi = float(evals.min()), float(evals.max())
        if E0 is not None:
            lo = min(lo, float(E0))
        pad = safety * 0.5 * (hi - lo) + 1e-6
        a = (hi - lo + 2 * pad) / 2.0
        b = (hi + lo) / 2.0
        info.update(bounds=(lo - pad, hi + pad))
    a_inv = torch.tensor(1.0 / a, dtype=rdt, device=device)
    bb = torch.tensor(b, dtype=rdt, device=device)

    def mvr(bv):
        return (mv(bv) - bv * bb) * a_inv

    def mu(v):
        return bv_site_moments(
            [p * x for p, x in zip(psi0.leaves, v.leaves)], lay, mesh)

    def moments_all_A(phi):
        """[n, L] moments of one B state against all A sites."""
        v_prev, v_curr = phi, mvr(phi)
        mus = [mu(v_prev), mu(v_curr)]
        for _ in range(n - 2):
            w = mvr(v_curr)
            # v_next = 2 w - v_prev, over v_prev's storage
            for x, y in zip(v_prev.leaves, w.leaves):
                x.neg_().add_(y, alpha=2.0)
            v_prev, v_curr = v_curr, v_prev
            mus.append(mu(v_curr))
        return torch.stack(mus[:n])

    if sites is None:
        sites = range(model.L)
    mu_rows = []
    for j in sites:
        phi = bv_apply_sz(psi0, lay, int(j))
        n2 = float(_norm2_plain(phi))
        if n2 <= 0.0:
            mu_rows.append(np.zeros((n, model.L), np.float64))
            continue
        nrm = np.sqrt(n2)
        phi = phi * torch.tensor(1.0 / nrm, dtype=rdt, device=device)
        mu_rows.append(moments_all_A(phi).double().cpu().numpy() * nrm)
    mu_all = torch.as_tensor(np.stack(mu_rows).transpose(0, 2, 1))  # [B, A, n]
    S = kpm_reconstruct(mu_all, np.asarray(omega, np.float64), a, b,
                        kernel=kernel, doubling=False, density_2_over_a=True,
                        clamp=None, clip_nonneg=True)
    C = np.abs(S.transpose(0, 1).numpy())  # [i = A, j = B, W]
    info.update(E0=None if E0 is None else float(E0), a=float(a), b=float(b))
    return C, info


# ---------------------------------------------------------------------------
# flat states (full and embedded models)
# ---------------------------------------------------------------------------


def _domain_wall_start(model, device):
    from ..models.initial_states import domain_wall_state

    return domain_wall_state(model, dtype=torch.complex64, device=device)


def run_chebyshev(model, dt: float, cheb_n: int = 50, lanc_m: int = 80,
                  backend: str | None = None, device=None,
                  generator: torch.Generator | None = None):
    """Domain-wall start -> bounds -> one Chebyshev step -> magnetization
    and S(q) (ref src/TimeEvolution/Chebyshev.jl:137-157). `device`
    defaults to the card. Returns (mags, (q, Sq), bounds)."""
    from ..observables import magnetization_per_site, structure_factor_Sq
    from ..ops.apply import matvec_fn
    from .chebyshev import chebyshev_time_evolve
    from .lanczos import estimate_energy_bounds

    device = resolve_device(device)
    mv = matvec_fn(model, backend, device=device)
    psi0 = _domain_wall_start(model, device)
    bounds = estimate_energy_bounds(mv, model.n_states, lanc_m=lanc_m,
                                    generator=generator,
                                    mask=model.valid_mask(device),
                                    device=device)
    psi_t = chebyshev_time_evolve(psi0, mv, dt, bounds, cheb_n=cheb_n)
    return (magnetization_per_site(psi_t, model),
            structure_factor_Sq(psi_t, model), bounds)


def run_krylov(model, dt: float, kry_m: int = 30,
               backend: str | None = None, device=None):
    """Domain-wall start -> one Krylov step -> magnetization and S(q) (a
    working version of the reference's wrapper,
    src/TimeEvolution/Krylov.jl:204-217). Returns (mags, (q, Sq))."""
    from ..observables import magnetization_per_site, structure_factor_Sq
    from ..ops.apply import matvec_fn
    from .krylov import krylov_time_evolve

    device = resolve_device(device)
    mv = matvec_fn(model, backend, device=device)
    psi_t = krylov_time_evolve(_domain_wall_start(model, device), mv, dt,
                               kry_m=kry_m)
    return (magnetization_per_site(psi_t, model),
            structure_factor_Sq(psi_t, model))


def evolve_trajectory(model, psi0: torch.Tensor, dt: float, n_steps: int,
                      method: str = "chebyshev", cheb_n: int = 30,
                      kry_m: int = 30, Ebounds=None,
                      backend: str | None = None, observe=None,
                      device=None,
                      generator: torch.Generator | None = None,
                      checkpoint_dir: str | None = None,
                      checkpoint_every: int = 0, resume: bool = False):
    """Evolve a flat state n_steps of size dt, recording
    `observe(psi, model)` per step (default magnetization_per_site): the
    trajectory pattern of the reference's examples/example.jl:86-105, with
    the coefficients computed once. `device` defaults to psi0's. Chebyshev
    bounds come from estimate_energy_bounds (random start from `generator`)
    unless `Ebounds` is given. Returns (psi_final, obs [n_steps, ...]
    numpy).

    Checkpoint/resume (the reference has none; in the JAX package these
    arguments belong to evolve_trajectory_planes, which the port replaced by
    this complex one): with `checkpoint_dir` the (state, observables, step)
    are saved every `checkpoint_every` steps and at the end
    (utils/checkpoint.py, meta keys step, dt, cheb_n, Ebounds); resume=True
    continues from the saved step, with the saved Ebounds unless others are
    given, so the resumed trajectory equals an uninterrupted one bit for
    bit (the same coefficients, the same recurrence). Resuming a finished
    run returns the saved state."""
    from ..observables import magnetization_per_site
    from ..ops.apply import matvec_fn
    from ..utils.checkpoint import load_checkpoint, save_checkpoint
    from .chebyshev import chebyshev_coefficients, chebyshev_time_evolve
    from .krylov import krylov_time_evolve
    from .lanczos import estimate_energy_bounds

    if method not in ("chebyshev", "krylov"):
        raise ValueError(f"unknown method {method!r}")
    if resume and not checkpoint_dir:
        raise ValueError("resume=True requires checkpoint_dir")
    device = resolve_device(device, psi0)
    saved = load_checkpoint(checkpoint_dir, device) if resume else None
    if saved is not None and Ebounds is None and saved[1]["Ebounds"]:
        Ebounds = tuple(saved[1]["Ebounds"])
    mv = matvec_fn(model, backend, device=device)
    psi = psi0.to(device=device, dtype=complex_dtype(psi0.dtype))
    if observe is None:
        observe = magnetization_per_site
    coeffs = None
    if method == "chebyshev":
        if Ebounds is None:
            Ebounds = estimate_energy_bounds(
                mv, model.n_states, generator=generator,
                mask=model.valid_mask(device), device=device)
        coeffs = chebyshev_coefficients(dt, Ebounds[0], Ebounds[1], cheb_n)
    obs, start = [], 0
    if saved is not None:
        psi, meta, extra = saved
        start = int(meta["step"])
        obs = list(extra["obs"]) if start else []

    def save(step):
        save_checkpoint(
            checkpoint_dir, psi,
            meta={"step": step, "dt": float(dt), "cheb_n": int(cheb_n),
                  "Ebounds": (None if Ebounds is None else
                              [float(Ebounds[0]), float(Ebounds[1])])},
            extra_arrays={"obs": np.asarray(obs) if obs
                          else np.zeros((0,), np.float32)})

    for k in range(start, n_steps):
        if method == "chebyshev":
            psi = chebyshev_time_evolve(psi, mv, dt, Ebounds, cheb_n=cheb_n,
                                        coeffs=coeffs)
        else:
            psi = krylov_time_evolve(psi, mv, dt, kry_m=kry_m)
        o = observe(psi, model)
        obs.append(o.cpu().numpy() if isinstance(o, torch.Tensor)
                   else np.asarray(o))
        if checkpoint_dir and checkpoint_every and (
                (k + 1) % checkpoint_every == 0):
            save(k + 1)
    if checkpoint_dir and start < n_steps:
        save(n_steps)
    return psi, np.asarray(obs)


def lanczos_groundstate_checkpointed(
        matvec, N: int | None, checkpoint_dir: str, lanc_m: int = 40,
        cycles: int = 6, tol: float = 1e-12, dtype=None,
        generator: torch.Generator | None = None, mask=None,
        target_residual: float | None = None, v0=None, save_every: int = 1,
        device=None, mesh=None):
    """Restarted two-pass ground state with per-cycle checkpoint/resume
    (the reference recomputes everything on every run). After each
    `save_every`-th restart cycle (and the last) the Ritz vector and (E0,
    residual, cycle, lanc_m) are saved to `checkpoint_dir`
    (utils/checkpoint.py; the cycle's Ritz values as the extra array
    "evals"). An existing checkpoint there is resumed; each cycle is a
    deterministic function of its start (lanczos.restart_cycle: every apply
    and every dot writes each output once, with no atomics), so a cut and
    resumed run reproduces the uninterrupted one bit for bit. A resumed run
    whose saved residual is already below `target_residual` returns at
    once; a run stops after the cycle that reaches it.

    The state is a flat tensor or a BlockVec: the start is `v0` (copied)
    or a random flat start from (N, dtype, generator, mask) on `device`
    (default: v0's, else the generator's, else the card). A resumed state
    is read onto `device` (and `mesh` for a sharded BlockVec). Returns (E0,
    psi, info)."""
    from ..utils.checkpoint import load_checkpoint, save_checkpoint
    from .lanczos import _random_start, restart_cycle

    device = resolve_device(device, v0 if v0 is not None else generator,
                            mesh)
    if dtype is None:
        dtype = torch.float32 if v0 is None else v0.dtype
    start, info, E0, psi = 0, {}, None, None
    if os.path.exists(os.path.join(checkpoint_dir, "meta.json")):
        psi, meta, _ = load_checkpoint(checkpoint_dir, device, mesh)
        psi = psi.astype(dtype) if isinstance(psi, BlockVec) else psi.to(
            dtype)
        start = int(meta["cycle"])
        E0 = meta.get("E0")
        info = {"residual": meta.get("residual"), "resumed_at": start}
        if (target_residual is not None and meta.get("residual") is not None
                and meta["residual"] < target_residual):
            return E0, psi, dict(info, cycles=start)
    if psi is None:
        if v0 is None:
            psi = _random_start(N, dtype, generator, mask, device)
        elif isinstance(v0, BlockVec):
            # the cycle normalizes its start in place
            psi = v0.map(lambda l: l.to(device=device, dtype=dtype,
                                        copy=True))
        else:
            psi = v0.to(device=device, dtype=dtype, copy=True)
    for c in range(start, cycles):
        E0, psi, cinfo = restart_cycle(matvec, psi, lanc_m, tol=tol)
        info = dict(cinfo, cycles=c + 1, resumed_at=start or None)
        if (c + 1) % save_every == 0 or c + 1 == cycles:
            save_checkpoint(
                checkpoint_dir, psi,
                meta={"cycle": c + 1, "E0": E0,
                      "residual": cinfo["residual"], "lanc_m": lanc_m},
                extra_arrays={"evals": np.asarray(cinfo["evals"])})
        if (target_residual is not None
                and cinfo["residual"] < target_residual):
            break
    return E0, psi, info
