"""Lanczos eigensolvers on BlockVec and flat states (port of
spindynamics_tpu/solvers/lanczos.py).

One recurrence core with options serves the extremal, ground-state,
tridiagonal and spectral paths. A state is a BlockVec (the kron layout) or
one flat tensor, real or complex (the full and embedded layouts); the
stored basis and the reorthogonalization options take both (a BlockVec
basis is a list of stacked leaves).
`lax.scan` becomes a Python loop; per-step scalars stay 0-d tensors on the
state's device, so a step never waits for the device (the selective
reorthogonalization decides on the host and does wait). The seeded (axpy)
branch and the second pass are kept exactly as in the JAX package: pass 2
regenerates pass 1's Krylov basis bit for bit, which holds because every
apply and every dot is deterministic (K1 and K3 write each output once,
with no atomics).

Random starts are real float32 by default on every device (H is real
symmetric, so a real start spans the same Krylov information); the JAX
package's backend-dependent default dtype is not ported.

Row-sharded flat states: a matvec with a `mesh` (FlatHamiltonian over a
LocalMesh or a ProcessMesh) takes and gives the rows of this process's
shards. On a LocalMesh those are the whole padded vector and nothing
changes; on a ProcessMesh every flat dot, norm and projection ends in the
mesh's all-reduce (`_spread`), as BlockVec dots do (bv_reduce), and a
random start is drawn whole, masked, and cut to this rank's rows.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils.dtypes import real_dtype
from .blockvec import BlockVec, bv_reduce, bv_zeros_like

__all__ = [
    "LanczosFactorization",
    "lanczos_iteration",
    "lanczos_tridiag",
    "lanczos_extremal",
    "estimate_energy_bounds",
    "lanczos_groundstate",
    "lanczos_groundstate_twopass",
    "tridiag_eigh",
    "restart_cycle",
    "lanczos_groundstate_restarted",
]


class LanczosFactorization(NamedTuple):
    alphas: torch.Tensor   # [m], on the CPU
    betas: torch.Tensor    # [m] (zeros past breakdown), on the CPU
    m_eff: int             # number of valid Lanczos vectors
    v0_norm: torch.Tensor  # norm of the starting vector
    # [m, N] Krylov basis, or a BlockVec of stacked [m, ...] leaves
    basis: torch.Tensor | BlockVec | None = None


def _flat_mesh(matvec):
    """The mesh of a flat sharded matvec (FlatHamiltonian(mesh=)), or
    None."""
    return getattr(matvec, "mesh", None)


def _spread(mesh) -> bool:
    """True when a flat state's rows are spread over processes (a
    ProcessMesh of more than one rank): its dots need the all-reduce."""
    return mesh is not None and mesh.n_local < mesh.D


def _inner_c(x, y, compensated: bool, mesh=None):
    """Sesquilinear <x|y>. bfloat16 leaves are read as float32: neither a
    Dekker split nor an N-term sum works at 8 mantissa bits. A compensated
    BlockVec dot is one call over all leaves (utils/compensated.
    vdot2_leaves: one dot2 kernel launch on the card), a plain one a dot
    per leaf. A flat state sharded over the processes of `mesh` sums its
    rows, then over the mesh."""
    if isinstance(x, BlockVec):
        if compensated:
            from ..utils.compensated import vdot2_leaves

            return bv_reduce(vdot2_leaves(x.leaves, y.leaves), x, y)
        return bv_reduce(sum(_inner_c(a, b, False)
                             for a, b in zip(x.leaves, y.leaves)), x, y)
    if x.dtype == torch.bfloat16 or y.dtype == torch.bfloat16:
        x, y = x.float(), y.float()
    if compensated:
        from ..utils.compensated import vdot2

        v = vdot2(x, y)
    elif x.is_complex() or y.is_complex():
        cd = torch.promote_types(x.dtype, y.dtype)
        v = torch.vdot(x.reshape(-1).to(cd), y.reshape(-1).to(cd))
    else:
        v = torch.dot(x.reshape(-1), y.reshape(-1))
    return mesh.all_reduce_sum(v) if _spread(mesh) else v


def _re(z):
    """Real part of a 0-d inner product (alpha = Re<v|Hv>)."""
    return z.real if z.is_complex() else z


def _norm_c(x, compensated: bool, mesh=None):
    if isinstance(x, BlockVec):
        return torch.sqrt(torch.clamp(_inner_c(x, x, compensated), min=0))
    if _spread(mesh):
        return torch.sqrt(torch.clamp(
            _re(_inner_c(x, x, compensated, mesh)), min=0))
    if compensated:
        from ..utils.compensated import norm2

        return norm2(x)
    return torch.linalg.vector_norm(x)


def _default_compensated(dtype) -> bool:
    """Compensated dots in f32 (and complex64); f64 already has the
    headroom."""
    return torch.finfo(real_dtype(dtype)).bits <= 32


def _project_out(V, w, j: int, mesh=None):
    """w minus its components along the stored V[0..j] (two products). A
    BlockVec basis is a list of stacked leaves [m, ...]: the coefficients
    sum over the leaves (and over the mesh of a sharded state), a flat
    one's over `mesh` when its rows are spread."""
    if isinstance(w, BlockVec):
        coeffs = bv_reduce(sum(
            torch.tensordot(Vl[: j + 1].conj(), wl, dims=wl.ndim)
            for Vl, wl in zip(V, w.leaves)), w)
        return w.like([wl - torch.tensordot(coeffs.to(wl.dtype), Vl[: j + 1],
                                            dims=1)
                       for wl, Vl in zip(w.leaves, V)])
    Vj = V[: j + 1]
    coeffs = Vj.conj() @ w
    return w - Vj.T @ (mesh.all_reduce_sum(coeffs) if _spread(mesh)
                       else coeffs)


def _store(V, j: int, v):
    """V[j] = v, for a flat basis [m, N] or a list of stacked leaves."""
    if isinstance(v, BlockVec):
        for Vl, l in zip(V, v.leaves):
            Vl[j] = l
    else:
        V[j] = v


def _lanczos_scan(matvec: Callable, v1, m: int, tol, compensated: bool,
                  reorth=False, store_basis: bool = False):
    """m Lanczos steps from normalized v1. Returns (alphas[m], betas[m],
    active[m], V or None) as device tensors; betas[j] couples step j to
    j+1.

    reorth: False | True/"full" (against the whole stored basis, every
    step) | "selective" (Simon's omega recurrence tracks the worst-case
    orthogonality estimate on the host; a full sweep runs only when it
    passes sqrt(eps)). reorth and store_basis keep an [m, N] basis, or for
    BlockVec states one stacked [m, ...] tensor per leaf.

    With `matvec.supports_axpy` (and no stored basis) the recurrence's
    -beta_{j-1} v_{j-1} is folded into the apply's kernel seed, and alpha =
    <v_j|w> then carries -beta <v_j|v_{j-1}> (identical up to the f32
    orthogonality floor, the standard Lanczos form). Both passes take the
    same branch. A flat state's dots go over `matvec`'s mesh (_spread).

    Spans (utils/profiling.py), one per statement group of a step:
    `lanczos.alpha`, `lanczos.orth`, `lanczos.reorth`, `lanczos.beta`,
    `lanczos.next`, beside the apply's own `apply.*`."""
    from ..utils.profiling import annotate, host_read

    dtype = v1.dtype
    rdtype = real_dtype(dtype)
    dev = v1.device
    mesh = _flat_mesh(matvec)
    tol = torch.tensor(tol, dtype=rdtype, device=dev)
    tiny = torch.finfo(rdtype).tiny
    zero = torch.zeros((), dtype=rdtype, device=dev)
    selective = reorth == "selective"
    full_reorth = bool(reorth) and not selective
    use_buffer = bool(reorth) or store_basis
    axpy_ok = getattr(matvec, "supports_axpy", False) and not use_buffer

    V = None
    if use_buffer:
        V = ([torch.zeros((m,) + l.shape, dtype=l.dtype, device=l.device)
              for l in v1.leaves] if isinstance(v1, BlockVec)
             else torch.zeros((m, v1.shape[0]), dtype=dtype, device=dev))
        _store(V, 0, v1)
    if selective:
        # host copies of the recurrence's scalars, in the state's precision
        npdt = np.float32 if rdtype == torch.float32 else np.float64
        eps = npdt(torch.finfo(rdtype).eps)
        sqrt_eps = np.sqrt(eps)
        om_prev = np.zeros(m, npdt)
        om_curr = np.zeros(m, npdt)
        om_curr[0] = eps
        a_hist = np.zeros(m, npdt)
        b_hist = np.zeros(m, npdt)
        idx = np.arange(m)

    v_prev, v_curr = bv_zeros_like(v1), v1
    beta_prev, neg_beta = zero, -zero
    active = torch.ones((), dtype=torch.bool, device=dev)
    last_alpha = zero
    alphas, betas, actives = [], [], []
    for j in range(m):
        if axpy_ok:
            w = matvec(v_curr, neg_beta, v_prev)
            with annotate("lanczos.alpha"):
                alpha = _re(_inner_c(v_curr, w, compensated, mesh))
            with annotate("lanczos.orth"):
                w = w - alpha * v_curr
        else:
            w = matvec(v_curr)
            with annotate("lanczos.alpha"):
                alpha = _re(_inner_c(v_curr, w, compensated, mesh))
            with annotate("lanczos.orth"):
                w = w - alpha * v_curr - beta_prev * v_prev
        if full_reorth:
            with annotate("lanczos.reorth"):
                w = _project_out(V, w, j, mesh)
        with annotate("lanczos.beta"):
            beta = _norm_c(w, compensated, mesh)

        if selective:
            with host_read():
                al, be, bp = npdt(float(alpha)), npdt(float(beta)), npdt(
                    float(beta_prev))
            a_hist[j], b_hist[j] = al, be
            # beta_j om_next[i] = b[i] om[i+1] + (a[i] - a[j]) om[i]
            #                     + b[i-1] om[i-1] - beta_{j-1} om_prev[i]
            b_im1 = np.where(idx > 0, np.roll(b_hist, 1), npdt(0))
            om_ip1 = np.roll(om_curr, -1)
            om_ip1[m - 1] = 0
            om_im1 = np.roll(om_curr, 1)
            om_im1[0] = 0
            raw = (b_hist * om_ip1 + (a_hist - al) * om_curr
                   + b_im1 * om_im1 - bp * om_prev)
            inv_beta = npdt(1) / max(be, eps) if be > 0 else npdt(0)
            noise = eps * (b_hist[0] + be)  # O(eps ||H||) rounding floor
            om_next = np.where(idx <= j, np.abs(raw) * inv_beta + noise,
                               npdt(0)).astype(npdt)
            om_next[j] = eps  # against v_j: locally orthogonal
            if om_next.max() > sqrt_eps:
                with annotate("lanczos.reorth"):
                    w = _project_out(V, w, j, mesh)
                om_next = np.where(idx <= j, eps, npdt(0)).astype(npdt)
                with annotate("lanczos.beta"):
                    beta = _norm_c(w, compensated, mesh)
                # later omega steps couple through b_hist[j]: keep the
                # post-sweep beta there
                with host_read():
                    b_hist[j] = npdt(float(beta))
            om_prev, om_curr = om_curr, om_next

        with annotate("lanczos.next"):
            ok = torch.logical_and(active, beta > tol)
            inv = torch.where(beta > 0, 1.0 / torch.clamp(beta, min=tiny),
                              zero)
            v_next = w * torch.where(ok, inv, zero)
            alpha_out = torch.where(active, alpha, last_alpha)
            beta_out = torch.where(ok, beta, zero)
            if axpy_ok:
                neg_beta = -beta_out  # the next apply's axpy coefficient
            alphas.append(alpha_out)
            betas.append(beta_out)
            actives.append(active)
            if use_buffer and j + 1 < m:
                _store(V, j + 1, v_next)
            # the dropped vectors are freed here, inside the span
            v_prev, v_curr = v_curr, v_next
            beta_prev, active, last_alpha = beta_out, ok, alpha_out
            del w
    if store_basis and isinstance(v1, BlockVec):
        V = v1.like(V)  # stacked [m, ...] leaves
    return (torch.stack(alphas), torch.stack(betas), torch.stack(actives),
            V if store_basis else None)


def _normalize_start(v0, donate: bool = False, mesh=None):
    """(v0 / ||v0||, ||v0||). donate=True scales v0 (its leaves) in place
    (the JAX package donates the buffer; the caller must not reuse v0)."""
    nrm = _norm_c(v0, False, mesh)
    inv = 1.0 / nrm
    if donate:
        for l in (v0.leaves if isinstance(v0, BlockVec) else (v0,)):
            l.mul_(inv.to(real_dtype(l.dtype)))
        return v0, nrm
    return v0 / nrm, nrm


def lanczos_iteration(matvec: Callable, v0, m: int, tol: float = 1e-12,
                      reorth=False, store_basis: bool = False,
                      compensated: bool | None = None
                      ) -> LanczosFactorization:
    """Lanczos tridiagonalization from v0 (need not be normalized; its norm
    is returned). reorth: False | True (full, every step) | "selective".
    compensated=None resolves by dtype (True in f32)."""
    v1, v0_norm = _normalize_start(v0, mesh=_flat_mesh(matvec))
    if compensated is None:
        compensated = _default_compensated(v1.dtype)
    alphas, betas, active, V = _lanczos_scan(matvec, v1, m, tol, compensated,
                                             reorth, store_basis)
    from ..utils.profiling import host_read

    with host_read():
        m_eff = int(active.sum())
        alphas, betas = alphas.cpu(), betas.cpu()
    return LanczosFactorization(alphas, betas, m_eff, v0_norm, V)


def lanczos_tridiag(matvec, v0, lanc_m: int = 100, tol: float = 1e-12):
    """(alphas[lanc_m], betas[lanc_m - 1], ||v0||) for spectral-function
    use (ref src/Lanczos.jl:180-229)."""
    fac = lanczos_iteration(matvec, v0, lanc_m, tol=tol)
    return fac.alphas, fac.betas[: lanc_m - 1], fac.v0_norm


def tridiag_eigh(alphas, betas, m_eff=None):
    """Host eigendecomposition of the (sliced) symmetric tridiagonal."""
    import scipy.linalg

    a = np.asarray(alphas, dtype=np.float64)
    b = np.asarray(betas, dtype=np.float64)
    if m_eff is not None:
        k = int(m_eff)
        a = a[:k]
        b = b[: max(k - 1, 0)]
    else:
        b = b[: a.shape[0] - 1]
    if a.shape[0] == 1:
        return a.copy(), np.ones((1, 1))
    return scipy.linalg.eigh_tridiagonal(a, b)


def _twopass(matvec, v1, lanc_m: int, tol, compensated: bool):
    """Pass 1 (alpha, beta), the host tridiagonal solve, pass 2 (psi =
    sum_j y_j v_j) from the normalized v1. Returns (lowest Ritz value,
    unnormalized psi, m_eff, evals). Spans `lanczos.pass1`,
    `lanczos.tridiag` (the host's eig), `lanczos.pass2`."""
    from ..utils.profiling import annotate, host_read

    with annotate("lanczos.pass1"):
        alphas, betas, active, _ = _lanczos_scan(matvec, v1, lanc_m, tol,
                                                 compensated)
    with host_read():
        m_eff = int(active.sum())
        alphas, betas = alphas.cpu(), betas.cpu()
    with annotate("lanczos.tridiag"):
        evals, evecs = tridiag_eigh(alphas, betas, m_eff)
        idx = int(np.argmin(evals))
        y = np.zeros(lanc_m)
        y[:m_eff] = evecs[:, idx]
    with annotate("lanczos.pass2"):
        psi = _second_pass_accumulate(
            matvec, v1, torch.as_tensor(y, dtype=real_dtype(v1.dtype),
                                        device=v1.device), lanc_m,
            compensated)
    return float(evals[idx]), psi, m_eff, evals


def _random_start(N: int, dtype=torch.float32,
                  generator: torch.Generator | None = None, mask=None,
                  device=None, mesh=None):
    """Random normal start vector on `device` (default: the generator's,
    else the card); `mask` (bool [N]) zeroes the rows outside an embedded
    sector (and a padded model's pad rows), so they are never excited. The
    default generator is seed 0. With a `mesh` whose rows are spread over
    processes, every rank draws the whole [N] start and keeps its rows."""
    from ..utils.device import resolve_device

    device = resolve_device(
        device, generator if device is None else None)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    v = torch.randn(N, generator=generator, dtype=dtype,
                    device=generator.device).to(device)
    if mask is not None:
        v = torch.where(mask.to(device), v, torch.zeros_like(v))
    if _spread(mesh):
        v = v[mesh.row_slice(N // mesh.D)].clone()
    return v


def lanczos_extremal(matvec, N: int, lanc_m: int = 100, tol: float = 1e-12,
                     dtype=torch.float32,
                     generator: torch.Generator | None = None, mask=None,
                     v0=None, device=None):
    """(Emin, Emax) Ritz bounds from one Lanczos run (ref
    src/Lanczos.jl:26-75), from `v0` or a random start (`_random_start`:
    real float32 by default, on the matvec's device)."""
    if v0 is None:
        if device is None:
            device = getattr(matvec, "device", None)
        v0 = _random_start(N, dtype, generator, mask, device,
                           _flat_mesh(matvec))
    fac = lanczos_iteration(matvec, v0, lanc_m, tol=tol)
    evals, _ = tridiag_eigh(fac.alphas, fac.betas, fac.m_eff)
    return float(evals.min()), float(evals.max())


def estimate_energy_bounds(matvec, N: int, lanc_m: int = 80,
                           tol: float = 1e-12, dtype=torch.float32,
                           generator: torch.Generator | None = None,
                           safety: float = 0.01, mask=None, v0=None,
                           device=None):
    """Outer estimates (Emin, Emax) of the spectrum for Chebyshev
    rescaling: one Lanczos run expanded outward by `safety` x half-width,
    because Chebyshev methods diverge if an eigenvalue maps outside
    [-1, 1]."""
    lo, hi = lanczos_extremal(matvec, N, lanc_m=lanc_m, tol=tol, dtype=dtype,
                              generator=generator, mask=mask, v0=v0,
                              device=device)
    pad = safety * 0.5 * (hi - lo) + 1e-6
    return lo - pad, hi + pad


def _start_vector(matvec, N, dtype, generator, mask, v0, device):
    if v0 is not None:
        return v0
    if device is None:
        device = getattr(matvec, "device", None)
    return _random_start(N, dtype, generator, mask, device,
                         _flat_mesh(matvec))


def lanczos_groundstate(matvec, N: int | None, lanc_m: int = 100,
                        tol: float = 1e-12, dtype=torch.float32,
                        generator: torch.Generator | None = None,
                        reorth="full", mask=None,
                        compensated: bool | None = None, v0=None,
                        device=None):
    """Ground-state energy and vector with a stored basis and
    reorthogonalization (ref src/Lanczos.jl:78-165), on flat states or, from
    a BlockVec `v0`, on the kron layout (the basis then stored as stacked
    per-group leaves, the projections as per-leaf tensordots). Returns (E0,
    psi, info with residual). reorth: "full" | "selective" | False. Memory
    is O(lanc_m N): use the restarted or two-pass solvers when the basis
    does not fit. A sharded flat matvec (FlatHamiltonian with a mesh)
    takes N = the padded length and mask = the padded model's valid_mask()
    (which zeroes its pad rows), and returns psi as the rows of this
    process's shards."""
    from ..utils.profiling import annotate, host_read

    v0 = _start_vector(matvec, N, dtype, generator, mask, v0, device)
    if reorth is True:
        reorth = "full"
    with annotate("lanczos.pass1"):
        fac = lanczos_iteration(matvec, v0, lanc_m, tol=tol, reorth=reorth,
                                store_basis=True, compensated=compensated)
    with annotate("lanczos.tridiag"):
        evals, evecs = tridiag_eigh(fac.alphas, fac.betas, fac.m_eff)
        k = fac.m_eff
        idx = int(np.argmin(evals))
        E0 = float(evals[idx])
        y = np.zeros(lanc_m)
        y[:k] = evecs[:, idx]
    V = fac.basis
    mesh = _flat_mesh(matvec)
    with annotate("lanczos.finalize"):
        yt = torch.as_tensor(y, dtype=real_dtype(V.dtype), device=V.device)
        if isinstance(V, BlockVec):
            psi = V.map(lambda l: torch.tensordot(yt.to(l.dtype), l,
                                                  dims=1))
        else:
            psi = yt.to(V.dtype) @ V
        nrm = _norm_c(psi, False, mesh)
        psi = psi / torch.clamp(nrm, min=torch.finfo(nrm.dtype).tiny)
        resid = _norm_c(matvec(psi) - psi * E0, False, mesh)
    with host_read():
        residual = float(resid)
    return E0, psi, {"residual": residual, "m_eff": k, "evals": evals}


def lanczos_groundstate_twopass(matvec, N: int, lanc_m: int = 100,
                                tol: float = 1e-12, dtype=torch.float32,
                                generator: torch.Generator | None = None,
                                mask=None, compensated: bool | None = None,
                                v0=None, device=None):
    """Memory-lean ground state: pass 1 computes (alpha, beta) with O(3N)
    memory, the small tridiagonal is solved on the host, pass 2 re-runs the
    identical recurrence accumulating psi = sum_j y_j v_j. No
    reorthogonalization: use moderate m or check the residual. A passed
    `v0` is normalized in place."""
    v0 = _start_vector(matvec, N, dtype, generator, mask, v0, device)
    if compensated is None:
        compensated = _default_compensated(v0.dtype)
    from ..utils.profiling import annotate, host_read

    v1, _ = _normalize_start(v0, donate=True, mesh=_flat_mesh(matvec))
    del v0
    E0, psi, m_eff, evals = _twopass(matvec, v1, lanc_m, tol, compensated)
    with annotate("lanczos.finalize"):
        psi, _, residual = _ritz_finalize(matvec, psi)
    with host_read():
        residual = float(residual)
    return E0, psi, {"residual": residual, "m_eff": m_eff, "evals": evals}


def restart_cycle(matvec, psi, lanc_m: int, tol: float = 1e-12,
                  compensated: bool | None = None, finalize=None):
    """ONE two-pass Lanczos restart cycle from `psi` (consumed: its leaves
    are normalized in place). Returns (E0, ritz_psi, info).

    finalize(matvec, psi_unnorm) -> (psi, E, resid) overrides _ritz_finalize
    (runners.groundstate_kron passes the bucketed variant). The span
    `lanczos.cycle` and the counter `lanczos.cycles`; the finalize in the
    span `lanczos.finalize`."""
    from ..utils.profiling import annotate, count, host_read

    count("lanczos.cycles")
    if compensated is None:
        compensated = _default_compensated(psi.dtype)
    with annotate("lanczos.cycle"):
        v1, _ = _normalize_start(psi, donate=True, mesh=_flat_mesh(matvec))
        del psi
        E_ritz, psi, m_eff, evals = _twopass(matvec, v1, lanc_m, tol,
                                             compensated)
        del E_ritz
        fin = _ritz_finalize if finalize is None else finalize
        with annotate("lanczos.finalize"):
            psi, E, resid = fin(matvec, psi)
        with host_read():
            E, resid = float(E), float(resid)
    return E, psi, {"residual": resid, "m_eff": m_eff, "evals": evals}


def lanczos_groundstate_restarted(matvec, v0=None, lanc_m: int = 40,
                                  cycles: int = 4, tol: float = 1e-12,
                                  target_residual: float | None = None,
                                  compensated: bool | None = None,
                                  finalize=None, N: int | None = None,
                                  dtype=torch.float32,
                                  generator: torch.Generator | None = None,
                                  mask=None, device=None):
    """Restarted two-pass ground state: O(3N) memory, high accuracy.

    Each cycle runs the two-pass Lanczos from the previous Ritz vector; a
    Chebyshev-filter polish takes over when restarts stall at the rounding
    floor. `v0` (a BlockVec or a flat tensor) is consumed; without it a
    flat random start is drawn from (N, dtype, generator, mask) as in the
    JAX package. Stops early at `target_residual`. Each polish step in
    the span `lanczos.polish` and the counter of that name."""
    from ..utils.profiling import annotate, count, host_read

    if v0 is None:
        if N is None:
            raise ValueError("pass a start vector v0, or N for a random one")
        v0 = _start_vector(matvec, N, dtype, generator, mask, None, device)
    if compensated is None:
        compensated = _default_compensated(v0.dtype)
    E0 = None
    psi = v0
    info = {}
    info_prev_residual = None
    del v0
    for c in range(cycles):
        E0, psi, cinfo = restart_cycle(matvec, psi, lanc_m, tol=tol,
                                       compensated=compensated,
                                       finalize=finalize)
        residual = cinfo["residual"]
        info = dict(cinfo, cycles=c + 1)
        if target_residual is not None and residual < target_residual:
            break
        if cinfo["m_eff"] < lanc_m:  # invariant subspace reached
            break
        if (target_residual is not None and c >= 1
                and residual > 0.5 * info_prev_residual):
            # no-reorth restarts stall once beta_1 ~ residual: switch to
            # the Chebyshev-filter polish below
            break
        info_prev_residual = residual

    # Chebyshev-filter polish: robust at the f32 floor where restarts stall
    if (target_residual is not None
            and info.get("residual", 1.0) > target_residual):
        evals = info["evals"]
        width = float(evals[-1] - evals[0]) if len(evals) > 1 else 1.0
        # gap estimate from the first ghost-free Ritz value
        above = [float(e) for e in evals if float(e) > E0 + 0.01 * width]
        e1 = above[0] if above else E0 + 0.1 * width
        lo_cut = E0 + max(0.5 * (e1 - E0), 0.005 * width)
        hi = float(evals[-1]) + 0.05 * width
        fin = _ritz_finalize if finalize is None else finalize
        for _ in range(max(cycles, 4)):
            count("lanczos.polish")
            with annotate("lanczos.polish"):
                psi = _chebyshev_filter(matvec, psi, lo_cut, hi, lanc_m)
                with annotate("lanczos.finalize"):
                    psi, E, resid = fin(matvec, psi)
                with host_read():
                    E0, resid = float(E), float(resid)
            info["residual"] = resid
            info["polished"] = info.get("polished", 0) + 1
            if resid < target_residual:
                break
    return E0, psi, info


def _chebyshev_filter(matvec, psi, lo_cut: float, hi: float, degree: int):
    """Amplify spectral weight below `lo_cut` by T_degree of H mapped so
    [lo_cut, hi] -> [-1, 1] (single-vector Chebyshev-filtered subspace
    iteration; needs no orthogonality). Renormalizes the pair each step.
    Its vector operations in the span `lanczos.filter`, beside the
    apply's own."""
    from ..utils.profiling import annotate

    dtype, dev = real_dtype(psi.dtype), psi.device
    mesh = _flat_mesh(matvec)
    c = torch.tensor((hi + lo_cut) / 2.0, dtype=dtype, device=dev)
    h = torch.tensor((hi - lo_cut) / 2.0, dtype=dtype, device=dev)
    tiny = torch.finfo(dtype).tiny

    def hmap(v):
        hv = matvec(v)
        with annotate("lanczos.filter"):
            hv = hv - v * c  # H v dropped here, as in one expression
            return hv / h

    t_prev = psi
    t_curr = hmap(psi)
    for _ in range(max(degree - 1, 0)):
        t_next = hmap(t_curr)
        with annotate("lanczos.filter"):
            t_next = 2.0 * t_next  # H~ t dropped here, as in one expression
            t_next = t_next - t_prev
            inv = 1.0 / torch.clamp(_norm_c(t_next, False, mesh), min=tiny)
            t_prev, t_curr = t_curr * inv, t_next * inv
    return t_curr


def _ritz_finalize(matvec, psi_unnorm, compensated: bool = True):
    """Normalize the Ritz vector; return (psi, E = <psi|H|psi>, residual).
    E uses the compensated dot: a naive f32 Rayleigh quotient error is the
    residual floor."""
    tiny = torch.finfo(real_dtype(psi_unnorm.dtype)).tiny
    mesh = _flat_mesh(matvec)
    nrm = _norm_c(psi_unnorm, compensated, mesh)
    psi = psi_unnorm / torch.clamp(nrm, min=tiny)
    hpsi = matvec(psi)
    E = _re(_inner_c(psi, hpsi, compensated, mesh))
    resid = _norm_c(hpsi - E * psi, compensated, mesh)
    return psi, E, resid


def _second_pass_accumulate(matvec, v1, y, m: int, compensated: bool = False):
    """Re-run the Lanczos recurrence from v1 (the same vectors) accumulating
    psi = sum_j y_j v_j without storing the basis. `compensated` and the
    axpy branch must match pass 1 so the basis is reproduced bit for bit."""
    from ..utils.profiling import annotate

    rdtype = real_dtype(v1.dtype)
    tiny = torch.finfo(rdtype).tiny
    zero = torch.zeros((), dtype=rdtype, device=v1.device)
    axpy_ok = getattr(matvec, "supports_axpy", False)
    mesh = _flat_mesh(matvec)
    v_prev, v_curr = bv_zeros_like(v1), v1
    beta_prev, neg_beta = zero, -zero
    acc = bv_zeros_like(v1)
    for j in range(m):
        with annotate("lanczos.accumulate"):
            acc = acc + v_curr * y[j]
        if axpy_ok:
            w = matvec(v_curr, neg_beta, v_prev)
            with annotate("lanczos.alpha"):
                alpha = _re(_inner_c(v_curr, w, compensated, mesh))
            with annotate("lanczos.orth"):
                w = w - alpha * v_curr
        else:
            w = matvec(v_curr)
            with annotate("lanczos.alpha"):
                alpha = _re(_inner_c(v_curr, w, compensated, mesh))
            with annotate("lanczos.orth"):
                w = w - alpha * v_curr - beta_prev * v_prev
        with annotate("lanczos.beta"):
            beta = _norm_c(w, compensated, mesh)
        with annotate("lanczos.next"):
            inv = torch.where(beta > 0, 1.0 / torch.clamp(beta, min=tiny),
                              zero)
            v_prev, v_curr = v_curr, w * inv
            beta_prev = beta
            if axpy_ok:
                neg_beta = -beta
            del w
    return acc
