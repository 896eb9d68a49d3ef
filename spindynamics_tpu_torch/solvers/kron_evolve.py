"""Real- and imaginary-time evolution at kron BlockVec scale (port of the
unsharded parts of spindynamics_tpu/solvers/kron_evolve.py).

A complex state is a pair of real BlockVecs (re, im); H is real, so every
apply acts on each plane alone (`KronPlanes`, K1 per fused group). The
Chebyshev-Bessel step e^{-iH dt} (ref src/TimeEvolution/Chebyshev.jl:62-133)
runs its first two terms through K1 and every later term through K2, the
fused Chebyshev-term kernel (ops/cheb_term.py), when the planes module's
`cheb_fused` field is set; otherwise through the plain recurrence. The
Krylov and imaginary-time variants keep the JAX package's recurrences;
`lax.scan` is a Python loop and the small tridiagonal problems are solved
on the host in float64.

States are float32 (the accumulator is float32 as in the JAX package),
bfloat16 or, off the kernels, float64. A bfloat16 state halves the memory
of every stored recurrence term: the terms are stored bfloat16 through the
bfloat16 instances of K1 and K2, every combine and the accumulator stay
float32, and the accumulator is rounded once per step. Accuracy class: one
rounding of the state per stored term, so observables are good to about
1e-2 absolute over tens of steps.

With `mesh=` (parallel/mesh.py) the entry points run on row-sharded
BlockVecs through the block-distributed apply
(parallel/sharded_kron_scaling.py): K1 on each shard's local block, every
dot finished by the mesh's all-reduce, observables summed per shard. The
Chebyshev terms then run the plain recurrence: the JAX package's sharded
matvec sets no fused-term route either, so K2 does not run on a mesh.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from ..ops.kron_group import KronHamiltonian
from ..ops.sector_kron import SectorKronLayout, default_fused_topk
from ..utils.compensated import vdot2_leaves
from ..utils.device import resolve_device
from .blockvec import (BlockVec, bv_basis_state, bv_random, bv_reduce,
                       bv_zeros_like)

__all__ = [
    "KronPlanes",
    "kron_planes_matvec_fn",
    "pair_dot",
    "pair_norm2",
    "lanczos_tridiag_pair",
    "chebyshev_time_evolve_kron",
    "krylov_time_evolve_kron",
    "krylov_imaginary_time_evolve_kron",
    "chebyshev_imaginary_time_kron",
    "kron_energy_bounds",
    "evolve_trajectory_kron",
    "typicality_correlation_kron",
]

_TINY32 = float(torch.finfo(torch.float32).tiny)


def _check_state_dtype(dtype):
    if dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise ValueError(f"state dtype must be float32, bfloat16 or "
                         f"float64, got {dtype}")


class KronPlanes(nn.Module):
    """(re, im) -> (H re, H im) on BlockVec planes (H is real).

    H is a KronHamiltonian, or a ShardedKronHamiltonian for row-sharded
    planes (then with cheb_fused=False: K2 takes whole groups, not a
    shard's local block).
    Routing is fixed at construction, in fields: the applies are the
    KronHamiltonian's (`H.fused`: K1), and `cheb_fused` (default H.fused)
    sends every Chebyshev term k >= 2 through K2 for the `cheb_top_k`
    largest groups (default: every group of at least 2^15 elements, the
    JAX package's term-kernel cutoff; the rest run plain). The state dtype
    is the leaves': a float32 module evolves float32 and bfloat16 pairs."""

    def __init__(self, H: KronHamiltonian, cheb_fused: bool | None = None,
                 cheb_top_k: int | None = None):
        super().__init__()
        self.H = H
        self.cheb_fused = H.fused if cheb_fused is None else cheb_fused
        if self.cheb_fused and not H.fused:
            raise ValueError("cheb_fused=True needs a fused KronHamiltonian "
                             "(K2 uses K1's per-group calls)")
        self.cheb_top_k = (default_fused_topk(H.layout, min_elems=1 << 15)
                           if cheb_top_k is None else cheb_top_k)

    @property
    def layout(self) -> SectorKronLayout:
        return self.H.layout

    @property
    def mv(self) -> KronHamiltonian:
        """The single-plane apply."""
        return self.H

    def forward(self, pair):
        return self.H(pair[0]), self.H(pair[1])


def kron_planes_matvec_fn(layout: SectorKronLayout, tables=None,
                          fused: bool = True, dtype=torch.float32,
                          device=None, cheb_fused: bool | None = None,
                          cheb_top_k: int | None = None) -> KronPlanes:
    """The planes module over a new KronHamiltonian of `layout`, on
    `device` (default: the card; pass device="cpu" for a CPU run).
    `tables` (the JAX package's argument) are the plain apply's tables of
    the layout, already built (ops/sector_kron.kron_tables, e.g. another
    module's `.tables`); None builds them."""
    H = KronHamiltonian(layout, dtype=dtype, device=device, fused=fused,
                        tables=tables)
    return KronPlanes(H, cheb_fused=cheb_fused, cheb_top_k=cheb_top_k)


def _bv_vdot(x: BlockVec, y: BlockVec):
    """Compensated <x|y> over all leaves in one call (f32 at N ~ 1e8 needs
    it; one dot2 kernel launch on the card); bfloat16 leaves are read as
    float32 (on the CPU each is lifted once, x is y: once for both sides).
    Sharded states: summed over the mesh's processes."""
    return bv_reduce(vdot2_leaves(x.leaves, y.leaves), x, y)


def pair_dot(x, y):
    """(Re<x|y>, Im<x|y>) of (re, im) BlockVec pairs, as 0-d tensors: four
    _bv_vdot sums, one call each."""
    d00, d11, d01, d10 = (_bv_vdot(a, b) for a, b in (
        (x[0], y[0]), (x[1], y[1]), (x[0], y[1]), (x[1], y[0])))
    return d00 + d11, d01 - d10


def pair_norm2(x):
    return _bv_vdot(x[0], x[0]) + _bv_vdot(x[1], x[1])


def _scale(pair, s):
    return pair[0] * s, pair[1] * s


def lanczos_tridiag_pair(planes, pair, lanc_m: int = 100, tol: float = 1e-12):
    """(alphas[lanc_m], betas[lanc_m - 1], ||v0||) of H from a complex start
    held as an (re, im) pair (ref src/Lanczos.jl:180-229), no stored basis.
    H is real symmetric, so alpha = Re<v|Hv> and beta = ||w|| are real.

    Breakdown masking as in the JAX package: once beta <= tol a step emits
    beta = 0 and repeats the last valid alpha, which decouples the spurious
    block with zero spectral weight. alphas and betas come back on the CPU."""
    rdtype = pair[0].dtype
    dev = pair[0].device
    tiny = torch.finfo(rdtype).tiny
    zero = torch.zeros((), dtype=rdtype, device=dev)
    tol = torch.tensor(tol, dtype=rdtype, device=dev)
    nrm = torch.sqrt(pair_norm2(pair))
    v_curr = _scale(pair, 1.0 / torch.clamp(nrm, min=tiny))
    v_prev = (bv_zeros_like(v_curr[0]), bv_zeros_like(v_curr[1]))
    beta_prev, last_alpha = zero, zero
    active = torch.ones((), dtype=torch.bool, device=dev)
    alphas, betas = [], []
    for _ in range(lanc_m):
        hr, hi = planes(v_curr)
        alpha, _ = pair_dot(v_curr, (hr, hi))
        w = (hr - v_curr[0] * alpha - v_prev[0] * beta_prev,
             hi - v_curr[1] * alpha - v_prev[1] * beta_prev)
        beta = torch.sqrt(pair_norm2(w))
        ok = torch.logical_and(active, beta > tol)
        inv = torch.where(ok, 1.0 / torch.clamp(beta, min=tiny), zero)
        alpha_out = torch.where(active, alpha, last_alpha)
        beta_out = torch.where(ok, beta, zero)
        alphas.append(alpha_out)
        betas.append(beta_out)
        v_prev, v_curr = v_curr, _scale(w, inv)
        beta_prev, active, last_alpha = beta_out, ok, alpha_out
    return (torch.stack(alphas).cpu(), torch.stack(betas)[: lanc_m - 1].cpu(),
            nrm)


def _acc_add_(acc, x, c):
    """acc += c x for the (re, im) pairs, in place, leaf by leaf, in the
    JAX package's order: acc_re + c_r x_re - c_i x_im and
    acc_im + c_i x_re + c_r x_im. Leaf by leaf, the temporaries are one
    group large, not one state. c is (c_r, c_i) as one-element float32
    tensors: a bfloat16 x leaf times one is computed in float32 (type
    promotion reads the leaf as float32 in the product itself), so the
    float32 accumulator never sees a rounded product and no lift pass is
    made."""
    cr, ci = c
    for ar, ai, xr, xi in zip(acc[0].leaves, acc[1].leaves, x[0].leaves,
                              x[1].leaves):
        ar.add_(xr * cr).sub_(xi * ci)
        ai.add_(xr * ci).add_(xi * cr)


def _plain_term(planes, p_prev, p_curr, acc, c, ab):
    """One term k >= 2 of the plain recurrence (kron_evolve.py:190-200):
    returns p_next; acc is updated in place. The shifted apply
    (h - b x) a_inv is computed in float32 and stored in the state dtype by
    its last product; p_next = 2 t - p_prev is then computed in the state
    dtype, which for bfloat16 is float32 arithmetic rounded once (2 t is
    exact): the JAX scan's roundings, with no lift or cast pass. b is a
    one-element float32 tensor (so b x is float32 for a bfloat16 x);
    identities for float32 states."""
    a_inv, b = ab
    sdt = p_curr[0].dtype
    nr, ni = planes(p_curr)
    p_next = tuple(
        P.like([_shifted(h, x, b, a_inv, sdt) * 2.0 - pv
                for h, x, pv in zip(H.leaves, P.leaves, V.leaves)])
        for H, P, V in ((nr, p_curr[0], p_prev[0]),
                        (ni, p_curr[1], p_prev[1])))
    _acc_add_(acc, p_next, c)
    return p_next


def _shifted(h, x, b, a_inv, sdt):
    """(h - b x) a_inv in float32 (h and x read as float32 by promotion
    against the float32 b x), stored in `sdt` by the product itself."""
    y = h - x * b
    return torch.mul(y, a_inv, out=torch.empty_like(y, dtype=sdt))


def _cheb_kron_scan(planes: KronPlanes, pair, coeffs_ri, ab, n: int):
    """One Chebyshev-Bessel e^{-iH dt} step on an (re, im) pair (port of
    kron_evolve._cheb_kron_scan; ref recurrence
    src/TimeEvolution/Chebyshev.jl:111-122).

    coeffs_ri: [n, 2] float32 (c_r, c_i) rows; ab = (1/a, b) host floats
    (float32 values). Terms 0 and 1 apply H through the planes module (K1);
    terms k >= 2 run through K2 when `planes.cheb_fused`, else through the
    plain recurrence. The accumulator is float32 and the result is cast to
    the state dtype.

    The pair may be bfloat16: every term is stored in the state dtype (the
    bfloat16 instances of K1 and K2 when fused), every combine and the
    accumulator run in float32, a bfloat16 leaf read as float32 by type
    promotion inside the operation that reads it (no lift pass, and no
    state-sized float32 copy of a bfloat16 pair is ever held), each stored
    term is rounded by the operation that writes it, and the accumulator
    is rounded once, at the end of the step."""
    a_inv, b = ab
    sdt = pair[0].dtype
    dev = pair[0].device
    c = [(float(r), float(i)) for r, i in np.asarray(coeffs_ri, np.float32)]
    # b and the coefficients (float32 values) as one-element float32
    # tensors: a product with a bfloat16 leaf promotes the leaf to float32
    # in the product itself, where a host float would keep a bfloat16
    # product; with float32 and float64 leaves they act as the host floats
    b_t = torch.tensor([b], dtype=torch.float32, device=dev)
    c_t = torch.tensor(np.asarray(coeffs_ri, np.float32), device=dev)

    def coef(k):
        return c_t[k, 0:1], c_t[k, 1:2]

    def mvr(p):
        hr, hi = planes(p)
        return tuple(P.like([_shifted(h, x, b_t, a_inv, sdt)
                             for h, x in zip(H.leaves, P.leaves)])
                     for H, P in ((hr, p[0]), (hi, p[1])))

    def f32(x):
        # the accumulator is float32: a float64 leaf is rounded to it
        # first, a bfloat16 one is read as float32 by the product
        return x if x.dtype == torch.bfloat16 else x.to(torch.float32)

    phi_prev = pair
    c0r, c0i = coef(0)
    pr, pi = phi_prev[0].leaves, phi_prev[1].leaves
    acc = (pair[0].like([f32(r) * c0r - f32(i) * c0i
                         for r, i in zip(pr, pi)]),
           pair[0].like([f32(r) * c0i + f32(i) * c0r
                         for r, i in zip(pr, pi)]))
    phi_curr = mvr(phi_prev)
    _acc_add_(acc, phi_curr, coef(1))
    if n > 2:
        if planes.cheb_fused:
            from ..ops.cheb_term import cheb_scan_terms_fused

            # K2's scan writes the recurrence over phi_curr's storage
            H = planes.H
            acc = cheb_scan_terms_fused(H.layout, H.tables, H.calls,
                                        phi_prev, phi_curr, acc, c[2:], ab,
                                        top_k=planes.cheb_top_k)
        else:
            p_prev, p_curr = phi_prev, phi_curr
            del phi_curr  # the loop holds the only reference
            for k in range(2, n):
                p_next = _plain_term(planes, p_prev, p_curr, acc, coef(k),
                                     (a_inv, b_t))
                p_prev, p_curr = p_curr, p_next
    return acc[0].astype(sdt), acc[1].astype(sdt)


def _coeff_arrays(coeffs):
    c, a, b = coeffs
    c_ri = np.stack([c.real, c.imag], axis=1).astype(np.float32)
    ab = (float(np.float32(1.0 / a)), float(np.float32(b)))
    return c_ri, ab


def chebyshev_time_evolve_kron(pair, planes: KronPlanes, dt, Ebounds,
                               cheb_n: int = 100, coeffs=None):
    """One e^{-iH dt} step of an (re, im) pair. `coeffs` (from
    chebyshev_coefficients) skips the host Bessel evaluation."""
    from .chebyshev import chebyshev_coefficients

    if coeffs is None:
        coeffs = chebyshev_coefficients(dt, Ebounds[0], Ebounds[1], cheb_n)
    c_ri, ab = _coeff_arrays(coeffs)
    return _cheb_kron_scan(planes, pair, c_ri, ab, cheb_n)


def _krylov_kron_factorize(planes, pair, m: int):
    """m Lanczos steps from the normalized pair, storing the basis: (V as a
    list of m (re, im) pairs, alphas[m], betas[m], ||pair||)."""
    dev = pair[0].device
    zero = torch.zeros((), dtype=pair[0].dtype, device=dev)
    nrm = torch.sqrt(pair_norm2(pair))
    v_curr = _scale(pair, 1.0 / torch.clamp(nrm, min=_TINY32))
    v_prev = (bv_zeros_like(v_curr[0]), bv_zeros_like(v_curr[1]))
    beta_prev = zero
    V, alphas, betas = [], [], []
    for _ in range(m):
        hr, hi = planes(v_curr)
        alpha, _ = pair_dot(v_curr, (hr, hi))
        w = (hr - v_curr[0] * alpha - v_prev[0] * beta_prev,
             hi - v_curr[1] * alpha - v_prev[1] * beta_prev)
        beta = torch.sqrt(pair_norm2(w))
        ok = beta > 1e-12
        inv = torch.where(ok, 1.0 / torch.clamp(beta, min=_TINY32), zero)
        beta_out = torch.where(ok, beta, zero)
        V.append(v_curr)
        alphas.append(alpha)
        betas.append(beta_out)
        v_prev, v_curr, beta_prev = v_curr, _scale(w, inv), beta_out
    return V, torch.stack(alphas), torch.stack(betas), nrm


def _tridiag_eigh(alphas, betas):
    """(D, Q) of the m x m tridiagonal, on the host in float64."""
    a = alphas.detach().cpu().double()
    b = betas.detach().cpu().double()[: a.shape[0] - 1]
    T = torch.diag(a) + torch.diag(b, 1) + torch.diag(b, -1)
    return torch.linalg.eigh(T)


def _combine_basis(y, V, plane):
    """sum_k y_k V_k[plane] for host coefficients y [m] (each rounded to
    the leaves' dtype, as the JAX package casts y)."""
    y = [float(v) for v in y]
    out = None
    for yk, v in zip(y, V):
        t = v[plane] * yk
        out = t if out is None else out + t
    return out


def _renormalize(pair):
    inv = 1.0 / torch.clamp(torch.sqrt(pair_norm2(pair)), min=_TINY32)
    return _scale(pair, inv)


def krylov_time_evolve_kron(pair, planes: KronPlanes, dt, kry_m: int = 30,
                            renormalize: bool = True):
    """e^{-iH dt} in an m-dimensional Krylov subspace (ref
    src/TimeEvolution/Krylov.jl); the basis is stored (m plane pairs)."""
    V, alphas, betas, nrm = _krylov_kron_factorize(planes, pair, kry_m)
    D, Q = _tridiag_eigh(alphas, betas)
    q0 = Q[0, :] * float(nrm)
    y_r = Q @ (torch.cos(D * dt) * q0)
    y_i = Q @ (-torch.sin(D * dt) * q0)
    out = (_combine_basis(y_r, V, 0) - _combine_basis(y_i, V, 1),
           _combine_basis(y_i, V, 0) + _combine_basis(y_r, V, 1))
    return _renormalize(out) if renormalize else out


def krylov_imaginary_time_evolve_kron(pair, planes: KronPlanes, tau,
                                      kry_m: int = 30,
                                      renormalize: bool = False):
    """e^{-tau H}|pair> up to an overall scale: the spectrum is shifted by
    its smallest Ritz value inside, so large tau does not overflow. Stores
    a kry_m-pair basis; chebyshev_imaginary_time_kron keeps O(3 pairs)."""
    V, alphas, betas, nrm = _krylov_kron_factorize(planes, pair, kry_m)
    D, Q = _tridiag_eigh(alphas, betas)
    y = Q @ (torch.exp(-tau * (D - D.min())) * (Q[0, :] * float(nrm)))
    out = (_combine_basis(y, V, 0), _combine_basis(y, V, 1))
    return _renormalize(out) if renormalize else out


def _cheb_real_apply(mv, bv: BlockVec, coeffs, ab) -> BlockVec:
    """sum_k c_k T_k(H~) |bv> for real host coefficients."""
    a_inv, b = ab

    def mvr(v):
        return (mv(v) - v * b) * a_inv

    prev = bv
    acc = prev * coeffs[0]
    curr = mvr(prev)
    acc = acc + curr * coeffs[1]
    for c in coeffs[2:]:
        nx = mvr(curr) * 2.0 - prev
        acc = acc + nx * c
        prev, curr = curr, nx
    return acc


def chebyshev_imaginary_time_kron(pair, planes: KronPlanes, tau, Ebounds,
                                  cheb_n: int | None = None,
                                  renormalize: bool = True):
    """e^{-tau H}|pair> up to a positive scale through the expansion
    e^{-tau a x} = I_0 + 2 sum_k (-1)^k I_k(tau a) T_k(x), with exponentially
    scaled Bessel I (scipy ive): the dropped e^{tau a - tau b} factor is
    exact after renormalization. O(3 pairs) memory. cheb_n defaults to
    4 tau a + 40."""
    from scipy.special import ive

    lo, hi = Ebounds
    a = (hi - lo) / 2.0
    b = (hi + lo) / 2.0
    z = float(tau) * a
    if cheb_n is None:
        cheb_n = int(4 * z) + 40
    k = np.arange(cheb_n)
    c = (2.0 - (k == 0)) * ((-1.0) ** k) * ive(k, z)
    coeffs = [float(x) for x in c.astype(np.float32)]
    ab = (float(np.float32(1.0 / a)), float(np.float32(b)))
    mv = planes.mv
    out = (_cheb_real_apply(mv, pair[0], coeffs, ab),
           _cheb_real_apply(mv, pair[1], coeffs, ab))
    if renormalize:
        inv = 1.0 / torch.sqrt(torch.clamp(pair_norm2(out), min=_TINY32))
        out = _scale(out, inv)
    return out


def kron_energy_bounds(layout: SectorKronLayout, planes_or_mv,
                       bounds_m: int = 40, safety: float = 0.02,
                       generator: torch.Generator | None = None, v0=None):
    """(Emin, Emax) of a bounds_m-step Lanczos run, padded outward by
    `safety` of the half-width (Chebyshev diverges outside [-1, 1]; ref
    src/Lanczos.jl:238-254). The start is `v0` or a random float32 BlockVec
    from `generator` (default: seed 7 on the apply's device), in sharded
    form on the apply's mesh when the apply is a sharded one."""
    from .lanczos import lanczos_iteration, tridiag_eigh

    mv = getattr(planes_or_mv, "mv", planes_or_mv)
    if v0 is None:
        dev = resolve_device(getattr(mv, "device", None))
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(7)
        v0 = bv_random(layout, generator, torch.float32, dev,
                       shard=getattr(mv, "shard", None))
    fac = lanczos_iteration(mv, v0, bounds_m)
    evals, _ = tridiag_eigh(fac.alphas, fac.betas, fac.m_eff)
    lo, hi = float(evals.min()), float(evals.max())
    pad = safety * 0.5 * (hi - lo) + 1e-6
    return (lo - pad, hi + pad)


def _planes_for(layout, fused, dtype, device, mesh=None):
    """The planes module of an entry point for states of `dtype`. A fused
    run needs float32 or bfloat16 states (K1 and K2): in float64 it raises
    on CUDA and runs the plain apply on the CPU, as runners.groundstate_kron
    does. The module's tables are float32 for bfloat16 states. With `mesh`
    the apply is the ShardedKronHamiltonian over it and the Chebyshev
    terms run plain."""
    if fused and dtype not in (torch.float32, torch.bfloat16):
        if device.type == "cuda":
            raise ValueError(f"fused=True runs K1 and K2, which take "
                             f"float32 or bfloat16 states, not {dtype}: "
                             "pass fused=False or float32 states")
        fused = False
    tdt = torch.float32 if dtype == torch.bfloat16 else dtype
    if mesh is not None:
        from ..parallel.sharded_kron_scaling import ShardedKronHamiltonian

        return KronPlanes(ShardedKronHamiltonian(
            layout, mesh, dtype=tdt, device=device, fused=fused),
            cheb_fused=False)
    return kron_planes_matvec_fn(layout, fused=fused, dtype=tdt,
                                 device=device)


def _layout_of(model, what):
    from ..ops.sector_kron import make_sector_kron_layout

    if model.kron_splits is None:
        raise ValueError(f"{what} needs a sector_kron model")
    return make_sector_kron_layout(model, model.kron_splits, model.kron_pads)


def evolve_trajectory_kron(model, psi0, dt: float, n_steps: int,
                           cheb_n: int = 60, Ebounds=None, bounds_m: int = 40,
                           fused: bool = True, observe=None,
                           record_norm: bool = True,
                           generator: torch.Generator | None = None,
                           mesh=None, state_dtype=None, device=None):
    """Chebyshev trajectory of a kron state with an observable per step:
    the reference's domain-wall demo (examples/example.jl:86-117) at kron
    scale.

    psi0: an int bitstring, a real BlockVec or an (re, im) pair. The state
    dtype defaults to float32 (as the JAX package resolves a float64 model);
    `state_dtype=torch.bfloat16` stores every recurrence term and the
    returned pair in bfloat16 (half the memory of the stored terms; float32
    combines and accumulator; observables good to about 1e-2, the norm
    drift in the same class: state it per use).
    `device` defaults to psi0's, else the mesh's, else the card. Bounds
    come from a bounds_m-step Lanczos run (kron_energy_bounds, `generator`
    or seed 7; always on a float32 vector, padded by 0.05 instead of 0.02
    for a bfloat16 run) unless `Ebounds` is given. `observe(pair, layout)`
    defaults to magnetization_per_site_kron.

    `mesh` runs the whole trajectory sharded: the state (psi0 plain or in
    sharded form) lives as row-sharded leaves end to end, the apply is the
    block-distributed one (K1 on each shard's local block), the Chebyshev
    terms run the plain recurrence (the JAX package's sharded matvec has no
    fused-term route either, so K2 does not run here), and the default
    observable is magnetization_per_site_kron_sharded: O(L) numbers
    all-reduced per measurement, no gather. A sharded bfloat16 run needs
    no bfloat16 model (the JAX package's does, its kernel dtype following
    the model): K1's instance follows the leaves' dtype here.

    Returns (pair, obs
    [n_steps, ...] numpy, info): info has the bounds, the norm after every
    step (Chebyshev is not unitary at finite cheb_n), the norm drift, the
    bounds-solve seconds and
    the host seconds of every step (each ends in reading the observable, a
    device sync)."""
    from ..observables_kron import magnetization_per_site_kron
    from .chebyshev import chebyshev_coefficients

    sdt = torch.float32 if state_dtype is None else state_dtype
    _check_state_dtype(sdt)
    lay = _layout_of(model, "evolve_trajectory_kron")
    device = resolve_device(
        device, psi0 if isinstance(psi0, (BlockVec, tuple)) else None, mesh)
    planes = _planes_for(lay, fused, sdt, device, mesh)
    shard, to_mesh = planes.H.shard, planes.H.to_mesh

    def place(bv):
        return to_mesh(bv).map(lambda l: l.to(device=device, dtype=sdt))

    if isinstance(psi0, (int, np.integer)):
        psi0 = bv_basis_state(lay, int(psi0), sdt, device, shard=shard)
    if isinstance(psi0, BlockVec):
        re = place(psi0)
        pair = (re, bv_zeros_like(re))
    else:
        pair = tuple(place(p) for p in psi0)
    t0 = time.perf_counter()
    if Ebounds is None:
        # a bfloat16 recurrence sees a slightly perturbed H: pad the
        # interval harder so nothing maps outside [-1, 1]
        Ebounds = kron_energy_bounds(
            lay, planes, bounds_m=bounds_m, generator=generator,
            safety=0.05 if sdt == torch.bfloat16 else 0.02)
    bounds_s = time.perf_counter() - t0
    c_ri, ab = _coeff_arrays(chebyshev_coefficients(dt, Ebounds[0],
                                                    Ebounds[1], cheb_n))
    if observe is None:
        # mesh-aware: a sharded pair is summed per shard and all-reduced
        # (magnetization_per_site_kron_sharded is this on explicit shards)
        observe = magnetization_per_site_kron

    obs, norms, step_s = [], [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        pair = _cheb_kron_scan(planes, pair, c_ri, ab, cheb_n)
        o = observe(pair, lay)
        obs.append(o.cpu().numpy() if isinstance(o, torch.Tensor)
                   else np.asarray(o))
        norms.append(float(pair_norm2(pair)) ** 0.5 if record_norm else 1.0)
        step_s.append(time.perf_counter() - t0)
    info = {"Ebounds": Ebounds, "norms": np.asarray(norms),
            "norm_drift": abs(norms[-1] - 1.0) if norms else 0.0,
            "bounds_seconds": bounds_s, "step_seconds": step_s}
    return pair, np.asarray(obs), info


def typicality_correlation_kron(model, beta: float, site_a: int, site_b: int,
                                t_points, kry_m: int = 30, cheb_n: int = 60,
                                Ebounds=None,
                                generator: torch.Generator | None = None,
                                fused: bool = True, r0=None,
                                imag_method: str = "chebyshev", mesh=None,
                                device=None):
    """<Sz_a(t) Sz_b(0)>_beta by quantum typicality at kron scale: a random
    (re, im) pair -> thermal |psi_beta> = e^{-beta H/2}|r> (Chebyshev or
    Krylov imaginary time) -> Chebyshev co-evolution (K2) of
    |phi> = Sz_b|psi_beta> and |xi> = |psi_beta> -> <xi(t)| Sz_a |phi(t)>.
    Returns complex [T] numpy.

    r0: a given (re, im) pair (copied to `device`, float32), else two
    random BlockVecs from `generator` (default: seed 0 on `device`).
    `mesh` runs the whole computation sharded (the random pair, the
    thermal state and the co-evolved states as row-sharded leaves, the Sz
    applies cut to each shard's rows, the overlaps all-reduced; the
    Chebyshev terms through the plain recurrence, not K2); a given r0 may
    be plain (it is padded and cut here, so runs with and without a mesh
    from the same r0 agree) or already in sharded form.
    `device` defaults to r0's, else the mesh's, else the card. Bounds
    from kron_energy_bounds (`generator`, else seed 7) unless `Ebounds` is
    given. Ref capability: src/TimeEvolution/QuantumTypicality.jl:33-211."""
    from ..observables_kron import bv_apply_sz
    from .chebyshev import chebyshev_coefficients

    lay = _layout_of(model, "typicality_correlation_kron")
    device = resolve_device(device, r0, mesh)
    planes = _planes_for(lay, fused, torch.float32, device, mesh)
    shard, to_mesh = planes.H.shard, planes.H.to_mesh
    if r0 is None:
        g = (generator if generator is not None
             else torch.Generator(device=device).manual_seed(0))
        r0 = (bv_random(lay, g, torch.float32, device, shard=shard),
              bv_random(lay, g, torch.float32, device, shard=shard))
    else:
        r0 = tuple(to_mesh(p).map(
            lambda l: l.to(device=device, dtype=torch.float32)) for p in r0)
    pair = _scale(r0, 1.0 / torch.sqrt(pair_norm2(r0)))
    if Ebounds is None:
        Ebounds = kron_energy_bounds(lay, planes, generator=generator)
    if imag_method == "chebyshev":
        psi_b = chebyshev_imaginary_time_kron(pair, planes, beta / 2.0,
                                              Ebounds, renormalize=True)
    elif imag_method == "krylov":
        psi_b = krylov_imaginary_time_evolve_kron(pair, planes, beta / 2.0,
                                                  kry_m=kry_m,
                                                  renormalize=True)
    else:
        raise ValueError(f"unknown imag_method {imag_method!r}")
    phi = (bv_apply_sz(psi_b[0], lay, site_b),
           bv_apply_sz(psi_b[1], lay, site_b))
    xi = psi_b

    t_points = np.asarray(t_points, np.float64)
    out = np.zeros(t_points.shape[0], np.complex128)
    prev_t = 0.0
    for i, t in enumerate(t_points):
        dt = float(t - prev_t)
        if abs(dt) > 1e-15:
            coeffs = chebyshev_coefficients(dt, Ebounds[0], Ebounds[1],
                                            cheb_n)
            phi = chebyshev_time_evolve_kron(phi, planes, dt, Ebounds,
                                             cheb_n=cheb_n, coeffs=coeffs)
            xi = chebyshev_time_evolve_kron(xi, planes, dt, Ebounds,
                                            cheb_n=cheb_n, coeffs=coeffs)
        prev_t = float(t)
        a_phi = (bv_apply_sz(phi[0], lay, site_a),
                 bv_apply_sz(phi[1], lay, site_a))
        re, im = pair_dot(xi, a_phi)
        out[i] = float(re) + 1j * float(im)
    return out
