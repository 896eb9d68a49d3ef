"""K3: the fused matvec H|psi> on a flat 2^L state (port of
spindynamics_tpu/ops/pallas_matvec.py).

For a full or embedded model one kernel launch computes

    y[s] = diag(s) x[s] + sum_b J_b [bit_i(s) != bit_j(s)] x[s ^ (2^i | 2^j)]

over every hopping bond, for a real (float32) or complex (complex64) state.
The kernel is CUDA C++ (`csrc/fused_matvec.cu`), built with nvcc for sm_90a
on first use (`ops/cuda_build.py`) and loaded with ctypes. A block owns a
tile of 2^tile_bits contiguous amplitudes (at most 128 KB: 2^15 float32,
2^14 complex64, so a plan is made for one element type) and stages it in
shared memory by bulk asynchronous copies; partner chunks of 2^chunk_bits
amplitudes (16 KB) stream through a ring beside it. The plan here sorts the
bonds by where their bits fall against that tile (local / straddle /
tile-space) and factors the diagonal into a 2^tile_bits table, per-tile
scalars and the straddle terms, so that no N-sized diagonal is read. What
the JAX package needed on the TPU and this kernel does not: the one-hot
matrix products for every index XOR, the bf16 hi+lo splits and their
`exact_J` switch, and the stacking of a complex state into two planes.

`fused_matvec_apply_reference` is the plain torch version (the blocked
apply, ops/blocked.py): the wrapper `fused_matvec_apply` uses it for tensors
on the CPU and only there; a CUDA tensor launches the kernel or raises.

Floor. K3 wants a tile of at least 32 amplitudes and at least two tiles:
`fused_supported` is False for L < 6 (and for layouts that are not full or
embedded), and `ops/apply.apply_H` routes such a model to the blocked apply
by that rule. Capacity is no such rule: a model with more bonds in one class
or more non-local zz terms than the kernel's shared-memory lists hold makes
`make_fused_plan` raise, and the caller asks for backend="blocked".

One owner of the device tables. `FusedCall` is a plan with its tables on
one device; `ops/apply.FlatHamiltonian` builds one per element type and
keeps the tables as its buffers. `fused_matvec_apply` without a `call`
builds plan and tables for that one apply: keep a FlatHamiltonian (or a
FusedCall) for repeated applies.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..model import SpinModel
from .cuda_build import CSRC, build_shared_library

__all__ = [
    "FusedPlan",
    "FusedCall",
    "make_fused_plan",
    "fused_tables",
    "fused_supported",
    "fused_pass_count",
    "tile_bits_range",
    "fused_matvec_apply",
    "fused_matvec_apply_reference",
    "kernel_launch_count",
    "reset_kernel_launch_count",
    "build_kernel",
]

# The default tile, in bits, of a float32 and of a complex64 state: 32 KB,
# so that two blocks fit an SM and each stages its next tile while it
# computes this one. The largest tiles (128 KB: the TPU kernel's 2^15) fit
# one block per SM and one tile slot, and ran about twice as long on the
# H100 (`chip_smoke.py --k3-tiles`, PERF.md).
DEFAULT_TILE_BITS = {False: 13, True: 12}
FUSED_MIN_L = 6
# csrc/fused_matvec.cu: K3_MAX_TILE_BYTES, K3_MIN_TILE_BYTES,
# K3_CHUNK_BYTES, K3_MAX_BONDS (per class), K3_MAX_ZZ
_MAX_TILE_BYTES = 1 << 17
_MIN_TILE_BYTES = 16
_CHUNK_BYTES = 1 << 14
_MAX_BONDS = 256
_MAX_ZZ = 1024


class _K3Desc(ctypes.Structure):
    _fields_ = [("y", ctypes.c_void_p), ("x", ctypes.c_void_p),
                ("dtab", ctypes.c_void_p),
                ("hop_ij", ctypes.c_void_p), ("hop_J", ctypes.c_void_p),
                ("zz_ij", ctypes.c_void_p), ("zz_J", ctypes.c_void_p),
                ("fh", ctypes.c_void_p),
                ("L", ctypes.c_int), ("k", ctypes.c_int),
                ("chunk_bits", ctypes.c_int), ("is_complex", ctypes.c_int),
                ("n_local", ctypes.c_int), ("n_strad", ctypes.c_int),
                ("n_tile", ctypes.c_int),
                ("n_zs", ctypes.c_int), ("n_zb", ctypes.c_int),
                ("n_hbits", ctypes.c_int), ("hbits", ctypes.c_int * 16)]


class FusedPlan:
    """Host-side plan of K3 for one model, one element type (`is_complex`)
    and one tile size: the bonds sorted into the kernel's three classes, and
    the factored diagonal. chunk_bits: the ring's chunk, 2^chunk_bits
    amplitudes (16 KB, or the whole tile where it is smaller).

    hop_ij [n, 2] int32 / hop_J [n] float32: local bonds (both bits <
    tile_bits), then straddle bonds (i local, j stored as j - tile_bits),
    then tile-space bonds (both stored minus tile_bits); i < j.
    zz_ij / zz_J: the straddle zz terms (i local, j - tile_bits), then the
    tile-space ones. fh [L - tile_bits]: the field on the tile bits.
    dtab [2^tile_bits]: every diagonal term whose bits are local. hbits: the
    local bits that carry a straddle zz term."""

    def __init__(self, L, tile_bits, is_complex, hop_ij, hop_J, n_local,
                 n_strad, n_tile, zz_ij, zz_J, n_zs, n_zb, fh, dtab, hbits):
        self.L = L
        self.tile_bits = tile_bits
        self.is_complex = bool(is_complex)
        elem_bits = 3 if is_complex else 2
        self.chunk_bits = min(tile_bits,
                              _CHUNK_BYTES.bit_length() - 1 - elem_bits)
        self.hop_ij, self.hop_J = hop_ij, hop_J
        self.n_local, self.n_strad, self.n_tile = n_local, n_strad, n_tile
        self.zz_ij, self.zz_J = zz_ij, zz_J
        self.n_zs, self.n_zb = n_zs, n_zb
        self.fh = fh
        self.dtab = dtab
        self.hbits = hbits


def tile_bits_range(is_complex: bool = False) -> tuple[int, int]:
    """(least, most) tile bits K3 takes for a float32 (complex64) state:
    one 16-byte vector to 128 KB of shared memory."""
    eb = 8 if is_complex else 4
    return ((_MIN_TILE_BYTES // eb).bit_length() - 1,
            (_MAX_TILE_BYTES // eb).bit_length() - 1)


def make_fused_plan(model: SpinModel, tile_bits: int | None = None,
                    is_complex: bool = False) -> FusedPlan:
    """Sort the model's bonds and diagonal terms for a tile of 2^tile_bits
    amplitudes of a float32 state, or of a complex64 one for `is_complex`
    (the counterpart of the JAX package's `pallas_default_plan` when
    tile_bits is None). The default tile is 32 KB, 2^13 float32 or 2^12
    complex64 amplitudes (`DEFAULT_TILE_BITS`), or 2^(L-1) where that is
    smaller, so that there are two tiles; up to 128 KB (the TPU kernel's
    256 x 128 block of float32) may be asked for.
    Raises ValueError for a model whose bond or zz lists exceed the
    kernel's: such a model runs through backend="blocked"."""
    L = model.L
    lo, hi = tile_bits_range(is_complex)
    if tile_bits is None:
        tile_bits = min(DEFAULT_TILE_BITS[bool(is_complex)], max(L - 1, lo))
    k = int(tile_bits)
    if not lo <= k <= min(L, hi):
        raise ValueError(f"tile_bits must be in [{lo}, min(L, {hi})] for a "
                         f"{'complex64' if is_complex else 'float32'} "
                         f"state, got {k}")

    classes = ([], [], [])  # local, straddle, tile-space
    for (si, sj), J in zip(model.hop_sites, model.hop_J):
        i, j = min(si, sj), max(si, sj)
        if j < k:
            classes[0].append((i, j, J))
        elif i < k:
            classes[1].append((i, j - k, J))
        else:
            classes[2].append((i - k, j - k, J))
    hop = [b for c in classes for b in c]

    e = np.arange(1 << k)
    dtab = np.zeros(1 << k, np.float64)
    zs, zb = [], []
    for (si, sj), J in zip(model.zz_sites, model.zz_J):
        i, j = min(si, sj), max(si, sj)
        if j < k:
            dtab += float(J) * (((e >> i) & 1) - 0.5) * (((e >> j) & 1) - 0.5)
        elif i < k:
            zs.append((i, j - k, J))
        else:
            zb.append((i - k, j - k, J))
    for i in range(min(k, L)):
        dtab += float(model.field[i]) * (((e >> i) & 1) - 0.5)
    zz = zs + zb
    if max(map(len, classes)) > _MAX_BONDS or len(zz) > _MAX_ZZ:
        raise ValueError(
            f"K3 takes at most {_MAX_BONDS} hopping bonds per class (this "
            f"model at tile 2^{k}: local {len(classes[0])}, straddle "
            f"{len(classes[1])}, tile-space {len(classes[2])}) and "
            f"{_MAX_ZZ} non-local zz terms ({len(zz)}): merge duplicate "
            "bonds or use backend=\"blocked\"")

    def ij(rows):
        return np.asarray([(a, b) for a, b, _ in rows],
                          np.int32).reshape(-1, 2)

    def Jv(rows):
        return np.asarray([c for _, _, c in rows], np.float32)

    fh = np.zeros(max(L - k, 1), np.float32)
    fh[: L - k] = model.field[k:]
    return FusedPlan(
        L, k, is_complex, ij(hop), Jv(hop), len(classes[0]), len(classes[1]),
        len(classes[2]), ij(zz), Jv(zz), len(zs), len(zb), fh,
        dtab.astype(np.float32), tuple(sorted({i for i, _, _ in zs})))


def fused_supported(model: SpinModel) -> bool:
    """The floor of K3: a full or embedded layout with L >= FUSED_MIN_L.
    Below it `ops/apply` uses the blocked apply, by this rule. (A model
    above the kernel's list capacity is not "unsupported": it raises, see
    `make_fused_plan`.)"""
    return model.mode in ("full", "embedded") and model.L >= FUSED_MIN_L


def fused_pass_count(plan: FusedPlan) -> float:
    """State-sized passes of one K3 apply as designed: the own tile's read
    and the write, and the partner chunks staged through the ring. A
    tile-space bond stages its partner tile where the tile's mask is 1 (half
    of the tiles): half a pass. A straddle bond on local bit i stages, for
    i below the chunk bits, the whole partner chunk of every output chunk
    (one pass), else only the chunks of the active half (half a pass). Cache
    hits lower what reaches the memory."""
    strad = sum(0.5 if int(i) >= plan.chunk_bits else 1.0
                for i, _ in plan.hop_ij[plan.n_local:
                                        plan.n_local + plan.n_strad])
    return 2.0 + 0.5 * plan.n_tile + strad


def fused_tables(plan: FusedPlan, device) -> dict:
    """The plan's device tables, as new tensors on `device`."""
    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    return {"dtab": dev(plan.dtab), "hop_ij": dev(plan.hop_ij),
            "hop_J": dev(plan.hop_J), "zz_ij": dev(plan.zz_ij),
            "zz_J": dev(plan.zz_J), "fh": dev(plan.fh)}


class FusedCall:
    """A plan's tables on one device and the cached ctypes descriptor
    whose table pointers never change; per launch only x and y do.
    `tables` default to new ones on `device` (`fused_tables`)."""

    def __init__(self, plan: FusedPlan, tables: dict | None = None,
                 device=None):
        self.plan = plan
        self.tables = (fused_tables(plan, device) if tables is None
                       else tables)
        self.device = self.tables["dtab"].device
        self._desc = None

    def descriptor(self) -> _K3Desc:
        if self._desc is not None:
            return self._desc
        p, t = self.plan, self.tables
        d = _K3Desc()
        d.L, d.k, d.chunk_bits = p.L, p.tile_bits, p.chunk_bits
        d.is_complex = int(p.is_complex)
        d.n_local, d.n_strad, d.n_tile = p.n_local, p.n_strad, p.n_tile
        d.n_zs, d.n_zb = p.n_zs, p.n_zb
        d.n_hbits = len(p.hbits)
        for q, b in enumerate(p.hbits):
            d.hbits[q] = b
        for name in ("dtab", "hop_ij", "hop_J", "zz_ij", "zz_J", "fh"):
            x = t[name]
            want = torch.int32 if name.endswith("_ij") else torch.float32
            if (x.device != self.device or x.dtype != want
                    or not x.is_contiguous() or x.data_ptr() % 16):
                raise ValueError(
                    f"K3 table {name}: {x.dtype} on {x.device}, expected "
                    f"contiguous, 16-byte aligned {want} on {self.device}")
            setattr(d, name, x.data_ptr() if x.numel() else None)
        self._desc = d
        return d


_SRC = CSRC / "fused_matvec.cu"
_LIB = None


def build_kernel() -> dict:
    """Compile K3 (once per source hash) and load it. Returns {"path",
    "seconds" (0 when the library was already built), "log" (nvcc's
    -Xptxas -v report)}."""
    global _LIB
    info = build_shared_library(_SRC, (), "K3")
    if _LIB is None or _LIB._name != info["path"]:
        lib = ctypes.CDLL(info["path"])
        lib.k3_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.k3_launch.restype = ctypes.c_int
        lib.k3_desc_size.argtypes = []
        lib.k3_desc_size.restype = ctypes.c_int
        if lib.k3_desc_size() != ctypes.sizeof(_K3Desc):
            raise RuntimeError(
                f"K3Desc layout mismatch: C {lib.k3_desc_size()} bytes, "
                f"ctypes {ctypes.sizeof(_K3Desc)}")
        _LIB = lib
    return info


def kernel_launch_count() -> int:
    """Number of K3 launches since import (or the last reset): the
    counter `launches.k3` (utils/profiling.py)."""
    from ..utils.profiling import counters

    return counters().get("launches.k3", 0)


def reset_kernel_launch_count() -> None:
    from ..utils.profiling import reset_counters

    reset_counters("launches.k3")


def fused_matvec_apply(psi: torch.Tensor, model: SpinModel,
                       call: FusedCall | None = None) -> torch.Tensor:
    """H|psi> on a flat state: K3 on a CUDA tensor, its plain version on a
    CPU tensor.

    psi: [2^L] float32 or complex64 on CUDA (contiguous; anything else
    raises: K3 computes in float32 and the port does not cast around it;
    use the blocked apply for float64), any dtype on the CPU. call: a tile
    plan for psi's element type with its tables on psi's device; by default
    the model's default plan and its tables are built for this one apply.
    Returns a new tensor; psi is not modified."""
    dev = psi.device
    if dev.type == "cpu":
        return fused_matvec_apply_reference(psi, model)
    if dev.type != "cuda":
        raise ValueError(f"K3 runs on CUDA tensors; got {dev}")
    if psi.dtype not in (torch.float32, torch.complex64):
        raise TypeError(
            f"K3 takes float32 or complex64 states, not {psi.dtype}: use "
            "backend=\"blocked\" for float64 and complex128")
    if not fused_supported(model):
        raise ValueError(
            f"K3 does not take this model (mode {model.mode!r}, L={model.L}, "
            f"floor L >= {FUSED_MIN_L}): use backend=\"blocked\"")
    if call is None:
        call = FusedCall(make_fused_plan(model, is_complex=psi.is_complex()),
                         device=dev)
    plan = call.plan
    if plan.L != model.L:
        raise ValueError(f"plan is for L={plan.L}, model has L={model.L}")
    if plan.is_complex != psi.is_complex():
        raise ValueError("K3 plan is for a "
                         f"{'complex64' if plan.is_complex else 'float32'} "
                         f"state, got {psi.dtype}")
    if psi.dim() != 1 or psi.shape[0] != 1 << plan.L:
        raise ValueError(f"K3 state: shape {tuple(psi.shape)}, expected "
                         f"({1 << plan.L},)")
    if not psi.is_contiguous() or psi.data_ptr() % 16:
        raise ValueError("K3 state: must be contiguous and 16-byte aligned")
    if call.device != dev:
        raise ValueError(f"state on {dev}, K3 tables on {call.device}")
    if _LIB is None:
        build_kernel()
    d = call.descriptor()
    out = torch.empty_like(psi)
    d.y, d.x = out.data_ptr(), psi.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _LIB.k3_launch(ctypes.byref(d), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {err}")
    from ..utils.profiling import count

    count("launches.k3")
    return out


def fused_matvec_apply_reference(psi: torch.Tensor, model: SpinModel,
                                 diag: torch.Tensor | None = None
                                 ) -> torch.Tensor:
    """Plain torch version of K3: the same function of (psi, model), in
    psi's dtype on psi's device, through the blocked apply with the N-sized
    diagonal it needs (`diag`, built for this one apply when None)."""
    from .blocked import apply_H_blocked

    return apply_H_blocked(psi, model, diag=diag)
