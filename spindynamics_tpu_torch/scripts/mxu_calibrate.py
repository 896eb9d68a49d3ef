"""Measure the card's matrix-product rate for each float32 precision
setting, and its copy bandwidth (port of scripts/mxu_calibrate.py).

    python -m spindynamics_tpu_torch.scripts.mxu_calibrate [--bf16]

Times C = A[65536, 512] @ W[512, 512] (the kron contraction class, the
JAX script's shape) under two settings of
torch.set_float32_matmul_precision: "highest" (float32 FMAs; JAX highest)
and "high" (TF32 on CUDA; JAX high is a 3-pass bf16 product, TF32 the
card's nearest). With --bf16 also bfloat16 operands with a float32
accumulate (the JAX script's bf16 x bf16, and the numerics of JAX default,
which truncates float32 operands to bf16 on the TPU). torch's "medium" is
not a mode here: for float32 operands on CUDA it runs TF32, as "high"
does. One JSON line per mode: the median CUDA-event time of 20 products
after 3 warm ones, TFLOP/s (2 M K^2 over it) beside the data sheet's rate
for the mode, and the relative error max|C - C64| / max|C64| of the first
1024 rows against float64 products of the same float32 operands. Then the
copy of a float32 vector of the L=32 sector's C(32, 16) amplitudes: its
bytes read and written over its time, beside 3.35 TB/s. Last, one line
with every rate, the relative errors and the card.

These are library calls (cuBLAS, the copy): a calibration of the card, not
a kernel of the port, and nothing on the port's path runs them. The
bench's bounds keep the data sheet's rates; these are printed beside them.
The package pins TF32 off at import: every mode restores the precision
settings it changed. With no CUDA device it exits non-zero before it
prints anything.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from ..utils.profiling import (BF16_TC_FLOPS_PER_S, F32_FLOPS_PER_S,
                               HBM_BYTES_PER_S, card_info, event_ms)

TF32_TC_FLOPS_PER_S = 495e12  # dense TF32 on the tensor cores (data sheet)
# (torch setting or "bf16", the JAX mode's name, the data sheet's rate)
MODES = (("highest", "highest", F32_FLOPS_PER_S),
         ("high", "high", TF32_TC_FLOPS_PER_S))
BF16 = ("bf16", "bf16 x bf16 (default)", BF16_TC_FLOPS_PER_S)
M, K = 65536, 512     # the JAX script's product
COPY_N = 601080390    # C(32, 16), the L=32 sector's amplitudes
REPS, SEED = 20, 0


@contextlib.contextmanager
def precision(mode: str):
    """The float32 matmul precision `mode` inside the block ("bf16":
    bfloat16 operands reduced in float32), the settings before it after."""
    prev = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    red = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    try:
        if mode == "bf16":
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
                = False
        else:
            torch.set_float32_matmul_precision(mode)
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = red


def operands(M: int, K: int, device):
    """A [M, K] normal, W [K, K] normal / sqrt(K), float32 on `device`."""
    g = torch.Generator(device=device).manual_seed(SEED)
    A = torch.randn(M, K, generator=g, device=device)
    W = torch.randn(K, K, generator=g, device=device) / np.sqrt(K)
    return A, W


def stored(A, W, mode: str):
    """The operands as `mode` multiplies them: bfloat16 for "bf16"."""
    if mode == "bf16":
        return A.to(torch.bfloat16), W.to(torch.bfloat16)
    return A, W


def relative_errors(A, W, modes, rows: int = 1024) -> dict:
    """max|C - C64| / max|C64| of the first `rows` rows per mode, C64 the
    float64 product of the same operands."""
    a = A[:rows]
    ref = a.double() @ W.double()
    out = {}
    for mode in modes:
        with precision(mode):
            c = torch.matmul(*stored(a, W, mode)).double()
        out[mode] = float((c - ref).abs().max() / ref.abs().max())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spindynamics_tpu_torch.scripts.mxu_calibrate",
        description=__doc__.splitlines()[0])
    ap.add_argument("--bf16", action="store_true",
                    help="also bfloat16 operands with a float32 accumulate")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the calibration measures the card "
                         "only")
    dev = torch.device("cuda")
    card = card_info()
    A, W = operands(M, K, dev)
    modes = MODES + ((BF16,) if args.bf16 else ())
    errs = relative_errors(A, W, [m[0] for m in modes])
    flops = 2.0 * M * K * K
    rates = {}
    for mode, jax_mode, sheet in modes:
        a, w = stored(A, W, mode)
        with precision(mode):
            C = torch.matmul(a, w)
            ms = event_ms(lambda: torch.matmul(a, w, out=C), reps=REPS,
                          device=dev)
        rates[mode] = flops / ms / 1e9
        print(json.dumps({"mode": mode, "jax_mode": jax_mode,
                          "shape": [M, K, K], "ms": ms,
                          "tflops": rates[mode], "data_sheet_tflops":
                          sheet / 1e12, "rel_err": errs[mode]}), flush=True)
    del A, W, a, w, C
    src = torch.empty(COPY_N, device=dev)
    dst = torch.empty_like(src)
    ms = event_ms(lambda: dst.copy_(src), reps=REPS, device=dev)
    nbytes = 2.0 * COPY_N * 4
    rates["copy_tb_per_s"] = nbytes / ms / 1e9
    print(json.dumps({"copy_elems": COPY_N, "bytes": nbytes, "ms": ms,
                      "tb_per_s": rates["copy_tb_per_s"],
                      "data_sheet_tb_per_s": HBM_BYTES_PER_S / 1e12}),
          flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 left on after the calibration")
    print(json.dumps({"calibration": rates, "rel_err": errs, "data_sheet": {
        "tflops": {m: s / 1e12 for m, _, s in modes},
        "tb_per_s": HBM_BYTES_PER_S / 1e12},
        "device": {k: card[k] for k in ("name", "count", "power_limit_w")}}),
        flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
