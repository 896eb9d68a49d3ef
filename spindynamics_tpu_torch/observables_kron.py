"""Observables on BlockVec kron states (port of the unsharded parts of
spindynamics_tpu/observables_kron.py).

S^z_q = L^{-1/2} sum_r e^{iqr} Sz_r is diagonal with a per-axis additive
weight w(h, m, l) = w_hi[h] + w_mid[m] + w_lo[l], so phi = S^z_q |psi> is one
elementwise pass per leaf, held as a real (re, im) plane pair. Every
diagonal observable is a function of the per-axis marginals of a weight
(|psi|^2 for <Sz_i> and <Sz_i Sz_j>): the 1-D marginals give all L one-site
moments and the same-part pair correlators, the 2-D marginals the
cross-part ones, so one pass over the state gives all L^2 correlators (ref
src/Observables.jl:14-110 loops scalars).

Row-sharded states (a BlockVec with a `mesh`, parallel/mesh.py) are never
gathered: every per-hi-rank table is zero-padded to the padded hi axis and
cut to the rows the process holds (`_hi_rows`), the marginals are summed
over those rows, and one all-reduce of the O(L^2) accumulators finishes the
observable. szsz_matrix_kron_sharded and
magnetization_per_site_kron_sharded keep the JAX package's signatures over
that.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.sector_kron import SectorKronLayout, _perm_sector_states, kron_part_perms
from .solvers.blockvec import BlockVec

__all__ = ["bv_sz_q_weights", "bv_sz_q_apply", "bv_sz_q", "bv_probs",
           "bv_site_moments", "magnetization_per_site_kron",
           "szsz_matrix_kron", "connected_correlations_kron",
           "structure_factor_Sq_kron", "bv_apply_sz",
           "szsz_matrix_kron_sharded", "magnetization_per_site_kron_sharded"]


def _mesh_of(x):
    """The mesh of a BlockVec or of an (re, im) pair's first plane."""
    return getattr(x[0] if isinstance(x, tuple) else x, "mesh", None)


def _hi_rows(v: np.ndarray, n_rows: int, mesh=None) -> np.ndarray:
    """The rows of a per-hi-rank table v ([C_h] or [C_h, ...]) that belong
    to a leaf with n_rows hi rows: v zero-padded to n_rows, or, on a mesh,
    to the padded hi axis D*b (b = n_rows / the process's shard count) and
    cut to the rows this process holds."""
    total = n_rows if mesh is None else mesh.D * (n_rows // mesh.n_local)
    if v.shape[0] != total:
        v = np.pad(v, ((0, total - v.shape[0]),) + ((0, 0),) * (v.ndim - 1))
    return v if mesh is None else v[mesh.row_slice(n_rows // mesh.n_local)]


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
                    dtype=np.float32, mesh=None):
    """Host-side per-group weight vectors of S^z_q:
    [(cos_l, cos_m, cos_h, sin_l, sin_m, sin_h), ...] (numpy). hi_lens (the
    leaves' hi lengths) pads the hi vectors for sharded-form leaves; with
    `mesh` they are the rows this process holds."""
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
            if p == 2:
                v = _hi_rows(v, hi_len, mesh)
            return np.asarray(v, dtype)

        out.append(tuple(wvec(p, np.cos) for p in range(3))
                   + tuple(wvec(p, np.sin) for p in range(3)))
    return out


def bv_sz_q_apply(x, weights):
    """Apply bv_sz_q_weights to a real BlockVec or an (re, im) BlockVec
    pair; returns the (re, im) BlockVec pair."""
    re_in, im_in = x if isinstance(x, tuple) else (x, None)
    shapes = ((1, 1, -1), (1, -1, 1), (-1, 1, 1))
    out_r, out_i = [], []
    for gi, wv in enumerate(weights):
        leaf = re_in.leaves[gi]

        def w(p):
            return torch.as_tensor(wv[p], device=leaf.device).to(
                leaf.dtype).reshape(shapes[p % 3])

        wr = sum(w(p) for p in range(3))
        wi = sum(w(3 + p) for p in range(3))
        if im_in is None:
            out_r.append(leaf * wr)
            out_i.append(leaf * wi)
        else:
            ileaf = im_in.leaves[gi]
            out_r.append(leaf * wr - ileaf * wi)
            out_i.append(ileaf * wr + leaf * wi)
    return re_in.like(out_r), re_in.like(out_i)


def bv_sz_q(x, layout: SectorKronLayout, q: float):
    """phi = S^z_q |psi> of a real BlockVec or an (re, im) pair, as an
    (re, im) pair (ref Sz_q_vector, src/Hamiltonian.jl:218-234). For many
    q-points make the weights once per q with bv_sz_q_weights and call
    bv_sz_q_apply."""
    re0 = x[0] if isinstance(x, tuple) else x
    hi_lens = [l.shape[0] for l in re0.leaves]
    dtype = np.float64 if re0.dtype == torch.float64 else np.float32
    return bv_sz_q_apply(x, bv_sz_q_weights(layout, q, hi_lens, dtype=dtype,
                                            mesh=re0.mesh))


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


def bv_site_moments(w_leaves, layout: SectorKronLayout, mesh=None
                    ) -> torch.Tensor:
    """[L] vector m_i = sum_states w(state) sz_i(state) from per-group
    weight leaves, in their dtype and on their device: one pass computes
    the per-axis marginals of each leaf and contracts them with the Sz
    tables of all L sites. With `mesh` the leaves are the process's rows
    of a sharded state, and the [L] sums end in one all-reduce."""
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
            if p == 2:
                S = _hi_rows(S, w.shape[0], mesh)
            parts[p] = parts[p] + margs[p] @ torch.as_tensor(
                S, dtype=dtype, device=dev)
    out = torch.cat(parts)
    return out if mesh is None else mesh.all_reduce_sum(out)


def magnetization_per_site_kron(x, layout: SectorKronLayout) -> torch.Tensor:
    """<Sz_i> per site of a BlockVec or an (re, im) BlockVec pair, in one
    pass (ref src/Observables.jl:14-36). A sharded state (one with a mesh)
    is not gathered."""
    return bv_site_moments(bv_probs(x), layout, _mesh_of(x))


def szsz_matrix_kron(x, layout: SectorKronLayout):
    """(SzSz[i, j], S_i): all pair correlators and magnetizations of a
    BlockVec or an (re, im) pair in one pass. Same-part pairs contract the
    1-D axis marginal of |psi|^2 against sz_i sz_j (the diagonal included:
    sz_i^2 = 1/4); cross-part pairs contract the 2-D marginal against
    sz_i x sz_j. The only O(N) work is the marginal sums (replaces the
    O(N L^2) loop of src/Observables.jl:66-72). A sharded state (one with
    a mesh) is not gathered: each process sums the marginals of its rows
    against its rows of the hi Sz table, and the (L + 1, L) accumulator is
    all-reduced once."""
    sz = _sz_tables(layout)
    lens = layout.splits
    L = layout.L
    off = (0, lens[0], lens[0] + lens[1])
    probs = bv_probs(x)
    mesh = _mesh_of(x)
    dtype, dev = probs[0].dtype, probs[0].device
    szsz = torch.zeros((L, L), dtype=dtype, device=dev)
    si = torch.zeros(L, dtype=dtype, device=dev)

    def block(p):
        return slice(off[p], off[p] + lens[p])

    for w, (k_h, k_m, k_l, *_r) in zip(probs, layout.groups):
        kp = (k_l, k_m, k_h)
        S = [torch.as_tensor(
            sz[p][kp[p]] if p < 2 else _hi_rows(sz[2][k_h], w.shape[0], mesh),
            dtype=dtype, device=dev) for p in range(3)]
        M_lm, M_hl, M_hm = w.sum(dim=0), w.sum(dim=1), w.sum(dim=2)
        m1 = (M_lm.sum(dim=0), M_lm.sum(dim=1), M_hm.sum(dim=1))
        for p in range(3):
            si[block(p)] += m1[p] @ S[p]
            szsz[block(p), block(p)] += (S[p] * m1[p][:, None]).T @ S[p]
        # cross-part blocks [L_pa, L_pb] = S_pa^T M2 S_pb, M2 indexed
        # (pa rank, pb rank)
        for pa, pb, M2 in ((0, 1, M_lm.T), (1, 2, M_hm.T), (0, 2, M_hl.T)):
            blk = S[pa].T @ M2 @ S[pb]
            szsz[block(pa), block(pb)] += blk
            szsz[block(pb), block(pa)] += blk.T
    if mesh is not None:
        both = mesh.all_reduce_sum(torch.cat([szsz, si[None]]))
        szsz, si = both[:L], both[L]
    return szsz, si


def connected_correlations_kron(x, layout: SectorKronLayout) -> torch.Tensor:
    """C_r = (1/L) sum_i [<Sz_i Sz_{i+r}> - <Sz_i><Sz_{i+r}>], periodic wrap
    (ref src/Observables.jl:44-95), of a BlockVec or an (re, im) pair."""
    from .observables import _connected_from_szsz

    szsz, si = szsz_matrix_kron(x, layout)
    return _connected_from_szsz(szsz, si, layout.L)


def structure_factor_Sq_kron(x, layout: SectorKronLayout):
    """S(q) = FFT_r C_r at q = 2 pi n / L (ref src/Observables.jl:101-110).
    C_r is L numbers: the FFT runs on the host, and (q, S_q) come back as
    numpy arrays, as from the JAX package."""
    C_r = connected_correlations_kron(x, layout).cpu().numpy()
    S_q = np.real(np.fft.fft(C_r))
    q = 2.0 * np.pi * np.arange(layout.L) / layout.L
    return q, S_q


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
        if p == 2:
            v = _hi_rows(v, leaf.shape[0], x.mesh)
        leaves.append(leaf * torch.as_tensor(
            v, dtype=leaf.dtype, device=leaf.device).reshape(shape))
    return x.like(leaves)


def _as_sharded(x, spec, mesh):
    """A flat sharded vector, a sharded-form BlockVec or an (re, im) pair
    of them, as BlockVec(s) on `mesh`."""
    if isinstance(x, tuple):
        return tuple(_as_sharded(p, spec, mesh) for p in x)
    if isinstance(x, BlockVec):
        return BlockVec(x.leaves, mesh)
    from .parallel.sharded_kron_scaling import flat_to_sharded_leaves

    return BlockVec(flat_to_sharded_leaves(x, spec, mesh), mesh)


def szsz_matrix_kron_sharded(x, spec, mesh, axis_name: str = "rows"):
    """(SzSz[i, j], S_i) from a block-distributed kron state
    (parallel/sharded_kron_scaling layout) without gathering it. `x` is a
    flat sharded vector (the [n_local * local_len] blocks of this process's
    shards), a BlockVec in sharded form, or an (re, im) pair of such
    BlockVecs (the sharded evolution's state). Every marginal is linear in
    |psi|^2, so each process contracts the marginals of its rows with its
    rows of the hi Sz tables and one all-reduce of the (L + 1, L)
    accumulator finishes: O(L^2) numbers per measurement, whatever N.
    `axis_name` is kept from the JAX signature."""
    del axis_name
    return szsz_matrix_kron(_as_sharded(x, spec, mesh), spec.layout)


def magnetization_per_site_kron_sharded(x, spec, mesh,
                                        axis_name: str = "rows"):
    """<Sz_i> from a block-distributed kron state (no gather): the 1-D
    marginals alone, and an all-reduce of L numbers."""
    del axis_name
    return magnetization_per_site_kron(_as_sharded(x, spec, mesh),
                                       spec.layout)
