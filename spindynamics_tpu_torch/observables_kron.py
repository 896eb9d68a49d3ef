"""Observables on BlockVec kron states (port of the S(q, omega),
magnetization and Sz-apply parts of spindynamics_tpu/observables_kron.py).

S^z_q = L^{-1/2} sum_r e^{iqr} Sz_r is diagonal with a per-axis additive
weight w(h, m, l) = w_hi[h] + w_mid[m] + w_lo[l], so phi = S^z_q |psi> is one
elementwise pass per leaf, held as a real (re, im) plane pair. Every
diagonal one-site moment is a function of the per-axis marginals of a
weight (|psi|^2 for <Sz_i>), so one pass gives all L sites.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.sector_kron import SectorKronLayout, _perm_sector_states, kron_part_perms
from .solvers.blockvec import BlockVec

__all__ = ["bv_sz_q_weights", "bv_sz_q_apply", "bv_probs", "bv_site_moments",
           "magnetization_per_site_kron", "bv_apply_sz"]


def _sz_tables(layout: SectorKronLayout):
    """Per part p, per part-magnetization k: [C_pad, L_p] matrix of Sz values
    (+-1/2) per INTERNAL rank (pad rows zero). Cached on the layout."""
    cached = layout.__dict__.get("_sz_tables")
    if cached is not None:
        return cached
    plen = layout.splits
    perms = kron_part_perms(layout.splits)
    ks = [set(), set(), set()]
    pad_of = [{}, {}, {}]
    for (k_h, k_m, k_l, ch, cm, cl, cmp, clp) in layout.groups:
        ks[0].add(k_l)
        ks[1].add(k_m)
        ks[2].add(k_h)
        pad_of[0][k_l] = clp
        pad_of[1][k_m] = cmp
        pad_of[2][k_h] = ch
    out = [{}, {}, {}]
    for p in range(3):
        for k in sorted(ks[p]):
            phys = _perm_sector_states(plen[p], k, perms[p]).astype(np.uint64)
            bits = ((phys[:, None]
                     >> np.arange(plen[p], dtype=np.uint64)[None, :])
                    & np.uint64(1)).astype(np.float64) - 0.5
            M = np.zeros((pad_of[p][k], plen[p]))
            M[: bits.shape[0]] = bits
            out[p][k] = M
    layout._sz_tables = out
    return out


def bv_sz_q_weights(layout: SectorKronLayout, q: float, hi_lens=None,
                    dtype=np.float32):
    """Host-side per-group weight vectors of S^z_q:
    [(cos_l, cos_m, cos_h, sin_l, sin_m, sin_h), ...] (numpy). hi_lens pads
    the hi vectors to the leaves' hi length."""
    sz = _sz_tables(layout)
    L1, L2, L3 = layout.splits
    s = 1.0 / np.sqrt(layout.L)
    sites = (np.arange(L1), L1 + np.arange(L2), L1 + L2 + np.arange(L3))
    out = []
    for gi, (k_h, k_m, k_l, ch, *_r) in enumerate(layout.groups):
        kp = (k_l, k_m, k_h)
        hi_len = ch if hi_lens is None else hi_lens[gi]

        def wvec(p, trig):
            v = sz[p][kp[p]] @ (s * trig(q * sites[p]))
            if p == 2 and v.shape[0] != hi_len:
                v = np.pad(v, (0, hi_len - v.shape[0]))
            return np.asarray(v, dtype)

        out.append(tuple(wvec(p, np.cos) for p in range(3))
                   + tuple(wvec(p, np.sin) for p in range(3)))
    return out


def bv_sz_q_apply(x: BlockVec, weights):
    """Apply bv_sz_q_weights to a real BlockVec; returns the (re, im)
    BlockVec pair. (The JAX version also takes an (re, im) pair; no caller
    of the port needs it.)"""
    shapes = ((1, 1, -1), (1, -1, 1), (-1, 1, 1))
    out_r, out_i = [], []
    for leaf, wv in zip(x.leaves, weights):

        def w(p):
            return torch.as_tensor(wv[p], device=leaf.device).to(
                leaf.dtype).reshape(shapes[p % 3])

        out_r.append(leaf * sum(w(p) for p in range(3)))
        out_i.append(leaf * sum(w(3 + p) for p in range(3)))
    return BlockVec(out_r), BlockVec(out_i)


def bv_probs(x) -> list:
    """|psi|^2 leaves of a real BlockVec or an (re, im) BlockVec pair.
    bfloat16 leaves are squared in float32."""
    def _f(l):
        return l.float() if l.dtype == torch.bfloat16 else l

    if isinstance(x, tuple):
        re, im = x
        return [_f(r) * _f(r) + _f(i) * _f(i)
                for r, i in zip(re.leaves, im.leaves)]
    return [_f(l) * _f(l) for l in x.leaves]


def _site_map(layout: SectorKronLayout) -> list:
    """site -> (part, rel bit)."""
    L1, L2, L3 = layout.splits
    out = []
    for i in range(layout.L):
        if i < L1:
            out.append((0, i))
        elif i < L1 + L2:
            out.append((1, i - L1))
        else:
            out.append((2, i - L1 - L2))
    return out


def bv_site_moments(w_leaves, layout: SectorKronLayout) -> torch.Tensor:
    """[L] vector m_i = sum_states w(state) sz_i(state) from per-group
    weight leaves, in their dtype and on their device: one pass computes
    the per-axis marginals of each leaf and contracts them with the Sz
    tables of all L sites."""
    sz = _sz_tables(layout)
    L1, L2, L3 = layout.splits
    w0 = w_leaves[0]
    dtype, dev = w0.dtype, w0.device
    parts = [torch.zeros(n, dtype=dtype, device=dev) for n in (L1, L2, L3)]
    for w, (k_h, k_m, k_l, *_r) in zip(w_leaves, layout.groups):
        kp = (k_l, k_m, k_h)
        margs = (w.sum(dim=(0, 1)), w.sum(dim=(0, 2)), w.sum(dim=(1, 2)))
        for p in range(3):
            S = sz[p][kp[p]]
            if p == 2 and S.shape[0] != w.shape[0]:
                S = np.pad(S, ((0, w.shape[0] - S.shape[0]), (0, 0)))
            parts[p] = parts[p] + margs[p] @ torch.as_tensor(
                S, dtype=dtype, device=dev)
    return torch.cat(parts)


def magnetization_per_site_kron(x, layout: SectorKronLayout) -> torch.Tensor:
    """<Sz_i> per site of a BlockVec or an (re, im) BlockVec pair, in one
    pass (ref src/Observables.jl:14-36)."""
    return bv_site_moments(bv_probs(x), layout)


def bv_apply_sz(x: BlockVec, layout: SectorKronLayout, site: int) -> BlockVec:
    """Sz_site |psi> on a real BlockVec: a per-axis diagonal multiply (the
    kron form of create_spin_operator(site, :z), ref
    src/Hamiltonian.jl:49-115)."""
    sz = _sz_tables(layout)
    (p, rel) = _site_map(layout)[site]
    shape = ((1, 1, -1), (1, -1, 1), (-1, 1, 1))[p]
    leaves = []
    for leaf, (k_h, k_m, k_l, *_r) in zip(x.leaves, layout.groups):
        kp = (k_l, k_m, k_h)
        v = sz[p][kp[p]][:, rel]
        if p == 2 and v.shape[0] != leaf.shape[0]:
            v = np.pad(v, (0, leaf.shape[0] - v.shape[0]))
        leaves.append(leaf * torch.as_tensor(
            v, dtype=leaf.dtype, device=leaf.device).reshape(shape))
    return BlockVec(leaves)
