"""The ell H apply as one CUDA kernel, and its plain torch version:
out[n] = diag[n] psi[n] + sum_b J_b psi[nbr[n, b]] over the int32 ELL
neighbour table (nbr = -1: no bond).

The kernel (`csrc/ell_apply.cu`) reads the table once, in its int32 form,
staged tile by tile into shared memory, gathers psi in the same pass and
sums each row in the state's precision in a fixed order (diag psi first,
then the bonds in order, by FMA): two calls on the same inputs give the
same bits. It takes float32, complex64, float64 and complex128 states. It
is built with nvcc for sm_90a on first use (`ops/cuda_build.py`) and
loaded with ctypes.

The plain version (`ell_apply_plain`) gathers ELL_CHUNK rows of the table
at a time from psi with one zero appended and adds that block times the
couplings into the rows (addmv): the CPU's apply, and the reference the
kernel is held to. The row-sharded ELL applies of parallel/sharded_apply
keep its chunk loop (`_ell_accumulate`) on every device: they gather from
a halo-extended array, whose index space is not one state's.

The chooser between the two is ops/apply.py's (`apply_H_ell`,
`FlatHamiltonian`): this module's `ell_apply` only launches, and raises on
anything the kernel does not take.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.dtypes import real_dtype
from .cuda_build import CSRC, build_shared_library

__all__ = [
    "ELL_CHUNK",
    "MAX_BONDS",
    "tile_rows",
    "ell_apply",
    "ell_apply_plain",
    "build_kernel",
    "ell_launch_count",
    "reset_ell_launch_count",
]

# rows of the table the plain version gathers at once: the [rows, n_bonds]
# temporary stays ~0.1 GB (float32) whatever N, where the JAX package
# gathers the whole [N, n_bonds] matrix (4 GiB in float32 at L=28)
ELL_CHUNK = 1 << 20
# csrc/ell_apply.cu's element types, by the `kind` it is passed
_KINDS = {torch.float32: 0, torch.complex64: 1, torch.float64: 2,
          torch.complex128: 3}
# rows per tile (= threads per block): 256, halved down to 32 while the
# kernel's two buffers of a tile exceed SMEM_BUDGET (two buffers of 256
# rows of up to 28 bonds; four such blocks share an SM's 228 KB)
MAX_ROWS, MIN_ROWS = 256, 32
SMEM_BUDGET = 56 * 1024
SMEM_MAX = 227 * 1024  # a block's dynamic shared memory on an H100
MAX_BONDS = SMEM_MAX // (2 * MIN_ROWS * 4)


def tile_rows(n_bonds: int) -> int:
    """Rows per tile of the kernel for a table of `n_bonds` columns: from
    n_bonds alone. Raises past MAX_BONDS (two buffers of 32 rows no longer
    fit a block's shared memory)."""
    if n_bonds > MAX_BONDS:
        raise ValueError(f"the ell kernel takes at most {MAX_BONDS} bonds "
                         f"per row, not {n_bonds}")
    rows = MAX_ROWS
    while rows > MIN_ROWS and 2 * rows * n_bonds * 4 > SMEM_BUDGET:
        rows //= 2
    return rows


def _ell_accumulate(out, ext, nbr, J, chunk: int):
    """out[r] += sum_b J_b ext[nbr[r, b]], `chunk` rows of the table at a
    time: one gather of a [chunk, n_bonds] block and one addmv (the plain
    version's loop, and the row-sharded applies' of
    parallel/sharded_apply)."""
    for s0 in range(0, nbr.shape[0], chunk):
        out[s0:s0 + chunk].addmv_(ext[nbr[s0:s0 + chunk]], J)


def ell_apply_plain(psi: torch.Tensor, nbr: torch.Tensor | None,
                    diag: torch.Tensor, J: torch.Tensor,
                    chunk: int = ELL_CHUNK) -> torch.Tensor:
    """The kernel's function in plain torch, on psi's device and in its
    dtype: psi diag, then `chunk` rows of the table at a time gathered from
    psi with one zero appended (an index of -1 reads it: indexing wraps
    negative indices) and added times J (addmv). `nbr` None means no
    bonds."""
    out = psi * diag.to(real_dtype(psi.dtype))
    if nbr is None or nbr.shape[1] == 0:
        return out
    ext = torch.cat([psi, psi.new_zeros(1)])
    _ell_accumulate(out, ext, nbr, J.to(psi.dtype), chunk)
    return out


_SRC = CSRC / "ell_apply.cu"
_LIB = None


def build_kernel() -> dict:
    """Compile the ell kernel (once per source hash) and load it. Returns
    {"path", "seconds" (0 when the library was already built), "log"
    (nvcc's -Xptxas -v report)}."""
    global _LIB
    info = build_shared_library(_SRC, (), "the ell kernel")
    if _LIB is None or _LIB._name != info["path"]:
        lib = ctypes.CDLL(info["path"])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ell_launch.argtypes = [p, p, p, p, p, ctypes.c_longlong, i, i,
                                   i, p]
        lib.ell_launch.restype = i
        _LIB = lib
    return info


def ell_launch_count() -> int:
    """Number of ell kernel launches since import (or the last reset): the
    counters `launches.ell.<dtype>` (utils/profiling.py) summed."""
    from ..utils.profiling import counters

    return sum(n for k, n in counters().items()
               if k.startswith("launches.ell."))


def reset_ell_launch_count() -> None:
    from ..utils.profiling import reset_counters

    reset_counters("launches.ell")


def _check(psi, nbr, diag, J) -> None:
    """Raise on what the kernel does not take; the device last, so that
    every other refusal shows on any device."""
    if psi.dtype not in _KINDS:
        raise TypeError(f"the ell kernel takes float32, complex64, float64 "
                        f"and complex128 states, not {psi.dtype}")
    if psi.dim() != 1 or not psi.is_contiguous():
        raise ValueError("the ell kernel takes a contiguous 1-D state; got "
                         f"shape {tuple(psi.shape)}, strides {psi.stride()}")
    N = psi.shape[0]
    if nbr.dtype != torch.int32 or nbr.dim() != 2 or nbr.shape[0] != N \
            or not nbr.is_contiguous():
        raise ValueError(f"the ell kernel takes a contiguous int32 table "
                         f"[{N}, n_bonds]; got {nbr.dtype} "
                         f"{tuple(nbr.shape)}")
    rdt = real_dtype(psi.dtype)
    if diag.dtype != rdt or diag.shape != (N,) or not diag.is_contiguous():
        raise ValueError(f"the ell kernel takes a contiguous {rdt} diagonal "
                         f"[{N}]; got {diag.dtype} {tuple(diag.shape)}")
    if J.dtype != rdt or J.shape != (nbr.shape[1],) or not J.is_contiguous():
        raise ValueError(f"the ell kernel takes {nbr.shape[1]} contiguous "
                         f"{rdt} couplings, one per column of the table; got "
                         f"{J.dtype} {tuple(J.shape)}")
    if psi.device.type != "cuda":
        raise ValueError(f"the ell kernel runs on CUDA tensors; got "
                         f"{psi.device} (ell_apply_plain is the CPU's)")
    for t in (nbr, diag, J):
        if t.device != psi.device:
            raise ValueError(f"the ell kernel's operands lie on {t.device} "
                             f"and {psi.device}")


def ell_apply(psi: torch.Tensor, nbr: torch.Tensor, diag: torch.Tensor,
              J: torch.Tensor) -> torch.Tensor:
    """H psi by the kernel, one launch on the current stream, no host sync.

    psi: [N] float32, complex64, float64 or complex128 on CUDA, contiguous;
    nbr: [N, n_bonds] int32, contiguous (-1: no bond), n_bonds <=
    MAX_BONDS; diag [N] and J [n_bonds] in psi's real dtype, contiguous;
    all on psi's device. Anything else raises, as does the launch or the
    build on failure. Counted in `launches.ell.<dtype>`."""
    from ..utils.profiling import count

    _check(psi, nbr, diag, J)
    rows = tile_rows(nbr.shape[1])
    out = torch.empty_like(psi)
    if psi.shape[0] == 0:
        return out
    if _LIB is None:
        build_kernel()
    with torch.cuda.device(psi.device):
        stream = torch.cuda.current_stream(psi.device).cuda_stream
        err = _LIB.ell_launch(out.data_ptr(), psi.data_ptr(),
                              diag.data_ptr(), J.data_ptr(), nbr.data_ptr(),
                              psi.shape[0], nbr.shape[1], _KINDS[psi.dtype],
                              rows, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"ell launch failed: cudaError {err}")
    count("launches.ell." + str(psi.dtype).removeprefix("torch."))
    return out
