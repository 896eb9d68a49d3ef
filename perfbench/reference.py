"""The plain float64 reference the cells' outputs are judged against.

Written from the model's definition, with none of the port's code (this
file imports torch and numpy only). The open XXZ chain, in the convention
of the port and of the JAX package it was ported from:

    H = sum_i Jxy (S+_i S-_{i+1} + h.c.) + Jz Sz_i Sz_{i+1}

on one Sz sector (nup up spins; bit j of a state is site j). The sector is
held in blocks: a state s = h << La | l splits into its La low bits l and
its Lb = L - La high bits h, and block k holds the states whose high part
has k up spins as a matrix [C(Lb, k), C(La, nup - k)], rows h and columns
l in ascending order. Bonds inside either half are sparse 0/1 matrices on
one axis of a block, the bond across the cut moves one up spin between
neighbouring blocks, and the diagonal is a sum of one vector per axis and
one outer product. One apply at L=32 (601M amplitudes) reads and writes
each block a few times, with no table of the whole sector.

A state of the program comes in through `from_flat` (the compact layout's
vector: the sector in ascending order) or `from_kron` (the sector_kron
layout's BlockVec leaves). `from_kron` works the kron layout's storage
order out again from its documented rule, not from the program's tables:
the lo part of L1 bits (the largest with C(L1, L1//2) <= 512), then mid
(L2) and hi (L3 = (L - L1) // 2) parts; groups ordered by (k_hi, k_mid);
each group a tensor [C(L3, k_hi), C(L2, k_mid) padded to 8, C(L1, k_lo)
padded to 128] whose part states ascend in an internal bit order that
rotates the mid and hi parts (physical bit r at internal bit r - 1); pad
slots hold zero.

On the states: `energy`, a ground state's Rayleigh quotient and its
residual at a given E0; the KPM moments of S^z_q psi (Chebyshev recurrence
with the product identities, float64 arithmetic, each T_n phi stored in
`store`) and the S(q, omega) row rebuilt from them; and a restarted
two-pass Lanczos ground state (the control runs it with bfloat16
storage).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

F64 = torch.float64


def _popcount(x: torch.Tensor, bits: int) -> torch.Tensor:
    n = torch.zeros_like(x)
    for j in range(bits):
        n += (x >> j) & 1
    return n


def _part_tables(bits: int, device):
    """(popcount, rank among the values of equal popcount) of every
    `bits`-bit value, int64."""
    x = torch.arange(1 << bits, device=device)
    pop = _popcount(x, bits)
    rank = torch.empty_like(x)
    for k in range(bits + 1):
        sel = pop == k
        rank[sel] = torch.arange(int(sel.sum()), device=device)
    return pop, rank


def _sector(bits: int, k: int, pop: torch.Tensor) -> torch.Tensor:
    return torch.nonzero(pop == k).squeeze(1)


def _flips(states: torch.Tensor, bits: int, rank: torch.Tensor, device):
    """The sparse 0/1 matrix of the bonds (j, j+1) inside a part on its
    sector `states`: entry (r, r') where state r' is state r with one
    antiparallel bond flipped. CSR, float64."""
    rows, cols = [], []
    for j in range(bits - 1):
        differ = ((states >> j) ^ (states >> (j + 1))) & 1
        r = torch.nonzero(differ).squeeze(1)
        rows.append(r)
        cols.append(rank[states[r] ^ (3 << j)])
    n = states.numel()
    if not rows or sum(r.numel() for r in rows) == 0:
        return None
    r, c = torch.cat(rows), torch.cat(cols)
    order = torch.argsort(r * n + c)
    r, c = r[order], c[order]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=device)
    crow[1:] = torch.cumsum(torch.bincount(r, minlength=n), 0)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            crow, c, torch.ones(r.numel(), dtype=F64, device=device),
            size=(n, n), check_invariants=False)


def _zz(states: torch.Tensor, bits: int) -> torch.Tensor:
    """sum_j (b_j - 1/2)(b_{j+1} - 1/2) over the bonds inside a part."""
    d = torch.zeros(states.numel(), dtype=F64, device=states.device)
    for j in range(bits - 1):
        d += (((states >> j) & 1).to(F64) - 0.5) * (
            ((states >> (j + 1)) & 1).to(F64) - 0.5)
    return d


class BlockChain:
    """H of the open XXZ chain on the Sz sector of L sites with nup up
    spins, on float64 states in block form (one flat tensor, the blocks
    one after another, each row-major)."""

    def __init__(self, L: int, nup: int, Jxy: float, Jz: float, device):
        self.L, self.nup, self.Jxy, self.Jz = L, nup, float(Jxy), float(Jz)
        self.La = La = L // 2
        self.Lb = Lb = L - La
        self.device = device
        self.popA, self.rankA = _part_tables(La, device)
        self.popB, self.rankB = _part_tables(Lb, device)
        self.ks = [k for k in range(Lb + 1) if 0 <= nup - k <= La]
        self.hs, self.ls, self.off = {}, {}, {}
        off = 0
        for k in self.ks:
            self.hs[k] = _sector(Lb, k, self.popB)
            self.ls[k] = _sector(La, nup - k, self.popA)
            self.off[k] = off
            off += self.hs[k].numel() * self.ls[k].numel()
        self.n = off
        if off != math.comb(L, nup):
            raise AssertionError("blocks do not cover the sector")
        self.Wh = {k: _flips(self.hs[k], Lb, self.rankB, device)
                   for k in self.ks}
        self.Wl = {k: _flips(self.ls[k], La, self.rankA, device)
                   for k in self.ks}
        # the diagonal of each block: the bonds inside each half, and the
        # bond across the cut (site La - 1, the top bit of l; site La, bit
        # 0 of h)
        self.diag = torch.empty(self.n, dtype=F64, device=device)
        for k in self.ks:
            zh = (self.hs[k] & 1).to(F64) - 0.5
            zl = ((self.ls[k] >> (La - 1)) & 1).to(F64) - 0.5
            self.block(self.diag, k).copy_(
                Jz * (_zz(self.hs[k], Lb)[:, None]
                      + _zz(self.ls[k], La)[None, :]
                      + zh[:, None] * zl[None, :]))
        self.up = {}  # k -> (rows src, rows dst, cols src, cols dst), k -> k+1
        for k in self.ks:
            if k + 1 not in self.off:
                continue
            h, lo = self.hs[k], self.ls[k]
            rs = torch.nonzero((h & 1) == 0).squeeze(1)
            cs = torch.nonzero(((lo >> (La - 1)) & 1) == 1).squeeze(1)
            self.up[k] = (rs, self.rankB[h[rs] | 1], cs,
                          self.rankA[lo[cs] ^ (1 << (La - 1))])

    def block(self, v: torch.Tensor, k: int) -> torch.Tensor:
        nh, nl = self.hs[k].numel(), self.ls[k].numel()
        return v[self.off[k]:self.off[k] + nh * nl].view(nh, nl)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        """H v (float64, block form)."""
        out = torch.mul(v, self.diag)
        J = self.Jxy
        for k in self.ks:
            Y, O = self.block(v, k), self.block(out, k)
            if self.Wh[k] is not None:
                O.add_(self.Wh[k] @ Y, alpha=J)
            if self.Wl[k] is not None:
                O.add_((self.Wl[k] @ Y.T.contiguous()).T, alpha=J)
        for k, (rs, rd, cs, cd) in self.up.items():
            for (Y, ri, ci), (O, ro, co) in (
                    ((self.block(v, k), rs, cs),
                     (self.block(out, k + 1), rd, cd)),
                    ((self.block(v, k + 1), rd, cd),
                     (self.block(out, k), rs, cs))):
                # one up spin across the cut: rows ri, columns ci of one
                # block to rows ro, columns co of its neighbour
                moved = Y.index_select(0, ri).index_select(1, ci)
                wide = torch.zeros(ri.numel(), O.shape[1], dtype=F64,
                                   device=O.device)
                wide.index_copy_(1, co, moved)
                O.index_add_(0, ro, wide, alpha=J)
        return out

    # ---- the program's states in block form ------------------------------

    def from_flat(self, x: torch.Tensor) -> torch.Tensor:
        """The sector in ascending order (the compact layout) -> blocks."""
        if x.numel() != self.n:
            raise ValueError(f"{x.numel()} amplitudes, the sector has "
                             f"{self.n}")
        x = x.reshape(-1).to(self.device)
        # start of each high part's row in ascending order
        sizes = torch.tensor([math.comb(self.La, self.nup - int(p))
                              if 0 <= self.nup - int(p) <= self.La else 0
                              for p in range(self.Lb + 1)],
                             device=self.device)[self.popB]
        start = torch.cumsum(sizes, 0) - sizes
        out = torch.empty(self.n, dtype=F64, device=self.device)
        for k in self.ks:
            nl = self.ls[k].numel()
            idx = start[self.hs[k]][:, None] + torch.arange(
                nl, device=self.device)[None, :]
            self.block(out, k).copy_(x[idx])
        return out

    def from_kron(self, leaves) -> tuple:
        """The sector_kron layout's leaves -> (blocks, largest |pad slot|)."""
        groups = kron_groups(self.L, self.nup)
        if len(leaves) != len(groups):
            raise ValueError(f"{len(leaves)} leaves, the layout's rule gives "
                             f"{len(groups)} groups")
        L1, L2, L3 = kron_splits(self.L)
        out = torch.zeros(self.n, dtype=F64, device=self.device)
        pad_max = 0.0
        written = 0
        maskA = (1 << self.La) - 1
        dl = torch.tensor([self.ls[k].numel() if k in self.off else 0
                           for k in range(self.Lb + 1)], device=self.device)
        offs = torch.tensor([self.off.get(k, 0) for k in range(self.Lb + 1)],
                            device=self.device)
        for leaf, (kh, km, kl) in zip(leaves, groups):
            his = part_states(L3, kh, True, self.device)
            mids = part_states(L2, km, True, self.device)
            los = part_states(L1, kl, False, self.device)
            shape = (his.numel(), _pad_up(mids.numel(), 8),
                     _pad_up(los.numel(), 128))
            if tuple(leaf.shape) != shape:
                raise ValueError(f"leaf {tuple(leaf.shape)}, the layout's "
                                 f"rule gives {shape}")
            x = leaf.to(self.device)
            nm, nl = mids.numel(), los.numel()
            for pad in (x[:, nm:, :], x[:, :, nl:]):
                if pad.numel():
                    pad_max = max(pad_max, float(pad.abs().max()))
            for i0 in range(0, his.numel(), 16):  # bounded index memory
                h_sl = his[i0:i0 + 16]
                s = ((h_sl[:, None, None] << (L1 + L2))
                     | (mids[None, :, None] << L1) | los[None, None, :])
                h, lo = s >> self.La, s & maskA
                k = self.popB[h]
                idx = offs[k] + self.rankB[h] * dl[k] + self.rankA[lo]
                out[idx.reshape(-1)] = x[i0:i0 + 16, :nm, :nl].reshape(
                    -1).to(F64)
                written += idx.numel()
        if written != self.n:
            raise ValueError(f"the leaves hold {written} states, the sector "
                             f"{self.n}")
        return out, pad_max

    # ---- what a state is judged by --------------------------------------

    def sz_q_weights(self, q: float) -> tuple:
        """Per axis, sum_j cos(q j) Sz_j and sum_j sin(q j) Sz_j of each
        block's rows and columns: S^z_q = L^(-1/2) sum_j e^(iqj) Sz_j."""
        out = {}
        for k in self.ks:
            h, lo = self.hs[k], self.ls[k]
            w = []
            for f in (math.cos, math.sin):
                wh = sum(f(q * (self.La + j)) * (((h >> j) & 1).to(F64) - 0.5)
                         for j in range(self.Lb))
                wl = sum(f(q * j) * (((lo >> j) & 1).to(F64) - 0.5)
                         for j in range(self.La))
                w.append((wh, wl))
            out[k] = w
        return out

    def phi_q(self, psi: torch.Tensor, q: float) -> tuple:
        """S^z_q psi as its (cos, sin) planes, normalized together."""
        w = self.sz_q_weights(q)
        planes = []
        for p in range(2):
            phi = torch.empty_like(psi)
            for k in self.ks:
                wh, wl = w[k][p]
                torch.mul(self.block(psi, k), wh[:, None] + wl[None, :],
                          out=self.block(phi, k))
            planes.append(phi)
        nrm = math.sqrt(sum(_dot(x, x) for x in planes))
        return tuple(x / nrm for x in planes)


def _dot(x, y) -> float:
    return float(torch.dot(x, y))


def _pad_up(n: int, m: int) -> int:
    return -(-n // m) * m


def kron_splits(L: int) -> tuple:
    """(L1, L2, L3): the largest lo part with C(L1, L1 // 2) <= 512 (and
    L1 <= L - 2), the rest split mid >= hi."""
    L1 = 2
    while L1 + 1 <= L - 2 and math.comb(L1 + 1, (L1 + 1) // 2) <= 512:
        L1 += 1
    L3 = (L - L1) // 2
    return L1, L - L1 - L3, L3


def kron_groups(L: int, nup: int) -> list:
    """[(k_hi, k_mid, k_lo)] in the layout's order."""
    L1, L2, L3 = kron_splits(L)
    return [(kh, km, nup - kh - km)
            for kh in range(min(L3, nup) + 1)
            for km in range(min(L2, nup - kh) + 1)
            if 0 <= nup - kh - km <= L1]


def part_states(bits: int, k: int, rotated: bool, device) -> torch.Tensor:
    """The physical values of a part's states with k up spins, in the
    order they are stored: ascending in the internal bit order, which for
    the mid and hi parts puts physical bit r at internal bit r - 1."""
    x = torch.arange(1 << bits, device=device)
    internal = x[_popcount(x, bits) == k]
    if not rotated or bits < 2:
        return internal
    phys = torch.zeros_like(internal)
    for r in range(bits):
        phys |= ((internal >> ((r - 1) % bits)) & 1) << r
    return phys


def energy(H: BlockChain, psi: torch.Tensor) -> tuple:
    """(<psi|H|psi> / <psi|psi>, ||H psi - E0 psi|| / ||psi|| at the E0
    given by the caller, as a function)."""
    hp = H(psi)
    n2 = _dot(psi, psi)
    E = _dot(psi, hp) / n2

    def residual(E0: float) -> float:
        r = hp - E0 * psi
        return math.sqrt(_dot(r, r) / n2)

    return E, residual


def moments(H: BlockChain, phi: torch.Tensor, a: float, b: float, M: int,
            store=F64) -> np.ndarray:
    """mu_n = <phi|T_n((H - b)/a)|phi>, n < M, by the three-term recurrence
    and the product identities mu_2n = 2<t_n|t_n> - mu_0, mu_2n+1 =
    2<t_n+1|t_n> - mu_1. Arithmetic in float64; each t_n stored in `store`
    (the control: bfloat16)."""
    def hr(v):
        return (H(v) - b * v) / a

    t0 = phi.to(store).to(F64)
    t1 = hr(t0).to(store).to(F64)
    mu = np.zeros(M)
    mu[0] = _dot(t0, t0)
    mu[1] = _dot(t1, t0)
    n = 1
    while 2 * n < M:
        mu[2 * n] = 2.0 * _dot(t1, t1) - mu[0]
        if 2 * n + 1 < M:
            t2 = (2.0 * hr(t1) - t0).to(store).to(F64)
            mu[2 * n + 1] = 2.0 * _dot(t2, t1) - mu[1]
            t0, t1 = t1, t2
        n += 1
    return mu


def jackson(M: int) -> np.ndarray:
    n = np.arange(M)
    d = np.pi / (M + 1)
    return ((M - n + 1) * np.cos(d * n) + np.sin(d * n) / np.tan(d)) / (M + 1)


def rebuild(mu: np.ndarray, energies: np.ndarray, a: float, b: float,
            clamp: float = 0.999) -> np.ndarray:
    """S(E) = (g_0 mu_0 + 2 sum_n g_n mu_n T_n(x)) / (pi sqrt(1 - x^2)),
    x = (E - b) / a clamped to +-clamp, negative values set to 0."""
    M = mu.size
    c = mu * jackson(M)
    c[1:] *= 2.0
    x = np.clip((np.asarray(energies, np.float64) - b) / a, -clamp, clamp)
    T = np.cos(np.outer(np.arccos(x), np.arange(M)))
    return np.maximum(T @ c / (np.pi * np.sqrt(1.0 - x * x)), 0.0)


def sqw_row(H: BlockChain, psi: torch.Tensor, q: float, omega, E0: float,
            a: float, b: float, M: int, store=F64) -> tuple:
    """(S row on omega + E0 in the window (a, b), max |mu_n|): the moments
    of both planes of S^z_q psi added, Jackson damping."""
    mu = sum(moments(H, phi, a, b, M, store) for phi in H.phi_q(psi, q))
    return rebuild(mu, np.asarray(omega) + E0, a, b), float(np.abs(mu).max())


def ground_state(H: BlockChain, generator: torch.Generator, m: int = 40,
                 cycles: int = 8, tol: float = 1e-9, store=F64) -> tuple:
    """(E, psi, residual): restarted two-pass Lanczos, each cycle m steps
    from the last Ritz vector (the first from a normal draw of
    `generator`), until ||H psi - E psi|| <= tol; every Lanczos vector and
    psi stored in `store`, the arithmetic in float64."""
    def st(x):
        return x.to(store).to(F64)

    v0 = torch.randn(H.n, dtype=F64, generator=generator,
                     device=generator.device).to(H.device)
    r = math.inf
    E = psi = None
    for _ in range(cycles):
        v0 = st(v0 / math.sqrt(_dot(v0, v0)))
        al, be = [], []
        prev, v, b = torch.zeros_like(v0), v0, 0.0
        for k in range(m):
            w = H(v) - b * prev
            a = _dot(v, w)
            w -= a * v
            al.append(a)
            b = math.sqrt(_dot(w, w))
            if k == m - 1 or b < 1e-12:
                break
            be.append(b)
            prev, v = v, st(w / b)
        T = np.diag(al) + np.diag(be, 1) + np.diag(be, -1)
        y = np.linalg.eigh(T)[1][:, 0]
        psi = y[0] * v0
        prev, v, b = torch.zeros_like(v0), v0, 0.0
        for k in range(1, len(al)):
            w = H(v) - b * prev - al[k - 1] * v
            b = be[k - 1]
            prev, v = v, st(w / b)
            psi += y[k] * v
        psi = st(psi / math.sqrt(_dot(psi, psi)))
        E, res = energy(H, psi)
        r = res(E)
        if r <= tol:
            break
        v0 = psi
    return E, psi, r


def row_deviation(S: np.ndarray, S_ref: np.ndarray) -> float:
    """max |S - S_ref| over omega, over the reference row's peak."""
    S, S_ref = np.asarray(S, np.float64), np.asarray(S_ref, np.float64)
    return float(np.abs(S - S_ref).max() / np.abs(S_ref).max())
