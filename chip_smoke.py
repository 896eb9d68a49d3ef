"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path once, through the entry points a user calls:
the sector_kron ground state of the Heisenberg chain in the Sz=0 sector
(groundstate_kron) and its KPM S(q, omega) (kpm_sqw_kron), with every H
apply's fused groups through K1, the hand-written CUDA group-apply kernel.

Phases (one line each; a failed phase raises and the script exits non-zero
with no result line):
  device   require CUDA; the card's name and power limit from nvidia-smi
  build    compile K1 from spindynamics_tpu_torch/csrc/kron_group.cu
  k1       K1 against its plain torch version on the card, at L=16 (every
           group) and at --L (the fused groups), with and without the
           Lanczos axpy seed; pad slots exactly 0; warm CUDA-event times
  oracle   L=16 ground state on the card against the CPU x64 energy
  main     --L ground state + S(q, omega) for q = 2 pi k / L, k in (4, 7, L/2)
  profile  (--profile) torch.profiler kernel table of one KPM moment step
Then one JSON line with the kernel record, and last the device line.

Usage: python3 chip_smoke.py [--L 28] [--profile]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# docs/PARITY.md: L=16 CPU x64; L=28 and L=32 f32 ground states (physical
# energies used as oracles, not speed figures)
E0_REF = {16: -11.67077735, 28: -20.663187, 32: -23.661858}


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _event_ms(fn, reps=20, warm=3):
    """Median CUDA-event time of fn() in ms (warm)."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the chip smoke runs on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)  # name, power limit: every time below is on this card
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} | "
          f"count {torch.cuda.device_count()}")


def phase_build():
    from spindynamics_tpu_torch.ops import kron_group as kg

    info = kg.build_kernel()
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"build: K1 nvcc sm_90a {info['seconds']:.2f} s -> {info['path']}"
          f" | {' ; '.join(regs)}")


def _k1_inputs(L, dev):
    """Layout, kernel calls and main-path-shaped K1 inputs at size L: a
    random state, the Lanczos axpy operands, and each fused group's seed."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import kron_group as kg
    from spindynamics_tpu_torch.ops.sector_kron import (
        apply_H_sector_kron, make_sector_kron_layout)
    from spindynamics_tpu_torch.solvers.blockvec import bv_random

    m = pt.heisenberg_chain(L, nup=L // 2)
    lay = make_sector_kron_layout(m, m.kron_splits)
    H = pt.KronHamiltonian(lay, dtype=torch.float32, device=dev)
    tables, calls = H.tables, H.calls
    g = torch.Generator(device=dev).manual_seed(L)
    bv = bv_random(lay, g, torch.float32, dev)
    b0 = bv_random(lay, g, torch.float32, dev)
    s = torch.tensor(-0.37, device=dev)
    fused = sorted(kg.fused_group_set(lay, H.top_k))
    args = []
    for gi in fused:
        c = calls[gi]
        seed = (apply_H_sector_kron(bv.leaves, None, lay, tables,
                                    terms=c.seed_terms, group_filter=(gi,))[gi]
                if c.has_seed else None)
        seed_ax = s * b0.leaves[gi] if seed is None else seed + s * b0.leaves[gi]
        srcs = [bv.leaves[x[0]] for x in c.cross]
        srcsh = [bv.leaves[x[0]] for x in c.crossh]
        args.append((bv.leaves[gi], seed, seed_ax, srcs, srcsh, c))
    return m, lay, H, bv, args


def phase_k1(L, dev):
    """K1 vs kron_group_apply_reference on the same CUDA tensors. Returns
    (max abs err, max rel err, K1 ms, plain ms) for the kernel part of one
    apply at L (sum over the fused groups)."""
    from spindynamics_tpu_torch.ops import kron_group as kg

    m, lay, H, bv, args = _k1_inputs(L, dev)
    abs_err = rel_err = 0.0
    for (T, seed, seed_ax, srcs, srcsh, c) in args:
        for sd in (seed, seed_ax):
            got = kg.kron_group_apply(T, sd, srcs, srcsh, c)
            want = kg.kron_group_apply_reference(T, sd, srcs, srcsh, c)
            torch.cuda.synchronize()
            (_, _, _, ch, cm, cl, cmp, clp) = lay.groups[c.gi]
            if got[:, cm:, :].any() or got[:, :, cl:].any():
                raise RuntimeError(f"L={L} group {c.gi}: pad slots not 0")
            d = float((got - want).abs().max())
            abs_err = max(abs_err, d)
            rel_err = max(rel_err, d / max(float(want.abs().max()), 1e-30))
    if not rel_err <= 1e-5:
        raise RuntimeError(f"L={L}: K1 vs plain rel err {rel_err:.3e} > 1e-5")

    def run(fn):
        def go():
            for (T, seed, _, srcs, srcsh, c) in args:
                fn(T, seed, srcs, srcsh, c)
        return go

    k_ms = _event_ms(run(kg.kron_group_apply))
    p_ms = _event_ms(run(kg.kron_group_apply_reference))
    k_ms2 = _event_ms(run(kg.kron_group_apply))
    p_ms2 = _event_ms(run(kg.kron_group_apply_reference))
    Hp = type(H)(lay, dtype=torch.float32, device=dev, fused=False)
    full_k = _event_ms(lambda: H(bv))
    full_p = _event_ms(lambda: Hp(bv))
    print(f"k1 L={L} splits={lay.splits}: {len(args)}/{len(lay.groups)} "
          f"groups fused | max|d|/max|y| {rel_err:.3e} (<= 1e-5), max|d| "
          f"{abs_err:.3e}, pads 0 | kernel part of one apply (median of 20, "
          f"plain/K1/K1/plain): plain {p_ms:.3f} ms, K1 {k_ms:.3f} ms, "
          f"K1 {k_ms2:.3f} ms, plain {p_ms2:.3f} ms | full apply: "
          f"KronHamiltonian(fused) {full_k:.3f} ms, plain blocks apply "
          f"{full_p:.3f} ms")
    return abs_err, rel_err, min(k_ms, k_ms2), min(p_ms, p_ms2)


def phase_oracle(dev):
    import spindynamics_tpu_torch as pt

    m = pt.heisenberg_chain(16, nup=8)
    (E0, psi, info, lay), dt = _sync_time(lambda: pt.groundstate_kron(
        m, lanc_m=40, cycles=6, target_residual=1e-3, device=dev))
    err = abs(E0 - E0_REF[16])
    print(f"oracle L=16: E0 {E0:.8f} (ref {E0_REF[16]}, |d| {err:.2e} <= "
          f"2e-4) residual {info['residual']:.2e} cycles {info['cycles']} "
          f"{dt:.2f} s")
    if not err <= 2e-4:
        raise RuntimeError(f"L=16 E0 {E0} off the oracle by {err}")


def phase_main(L, dev):
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import kron_group as kg

    m = pt.heisenberg_chain(L, nup=L // 2)
    qs = [2 * np.pi * k / L for k in (4, 7, L // 2)]
    omega = np.linspace(0.0, 4.0, 200)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kg.reset_kernel_launch_count()
    (E0, psi, info, lay), t_gs = _sync_time(lambda: pt.groundstate_kron(
        m, lanc_m=40, cycles=6, target_residual=1e-3, device=dev))
    n_gs = kg.kernel_launch_count()
    (S, kinfo), t_kpm = _sync_time(lambda: pt.kpm_sqw_kron(
        m, qs, omega, kpm_m=100, psi0=psi, E0=E0, info=info, device=dev))
    launches = kg.kernel_launch_count()
    peak = torch.cuda.max_memory_allocated()
    print(f"main L={L} splits={lay.splits} N={lay.n_basis} padded "
          f"{lay.n_states}: E0 {E0:.6f} E0/L {E0 / L:.6f} residual "
          f"{info['residual']:.3e} cycles {info['cycles']} polished "
          f"{info.get('polished', 0)} | ground state {t_gs:.2f} s, KPM "
          f"(3 q x 100 moments + 40 bounds steps) {t_kpm:.2f} s | peak "
          f"{peak / 2**30:.2f} GiB | K1 launches {launches} "
          f"(ground state {n_gs})")
    if not info["residual"] <= 1e-3:
        raise RuntimeError(f"residual {info['residual']} > 1e-3")
    if L in E0_REF and not abs(E0 - E0_REF[L]) <= 1e-3:
        raise RuntimeError(f"E0 {E0} off the reference {E0_REF[L]}")
    if not launches > 0:
        raise RuntimeError("the main path launched K1 no time")
    smax = float(np.abs(S).max())
    if not (np.all(np.isfinite(S)) and smax > 0
            and S.min() >= -1e-6 * smax):
        raise RuntimeError("S(q, omega) not finite and non-negative")
    print(f"sqw L={L}: shape {S.shape}, max {smax:.4f}, peak omega per q "
          f"{[float(omega[i]) for i in S.argmax(axis=1)]}, "
          f"bounds {tuple(round(b, 4) for b in kinfo['bounds'])}")
    return launches, psi, E0, kinfo


def phase_profile(L, dev, psi, kinfo):
    """Kernel-time table of one KPM moment step (one apply + the doubled
    recurrence's dots) under torch.profiler."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops.sector_kron import make_sector_kron_layout
    from spindynamics_tpu_torch.solvers.chebyshev import chebyshev_moments
    from torch.profiler import ProfilerActivity, profile

    m = pt.heisenberg_chain(L, nup=L // 2)
    lay = make_sector_kron_layout(m, m.kron_splits)
    H = pt.KronHamiltonian(lay, dtype=torch.float32, device=dev)
    a_inv = torch.tensor(1.0 / kinfo["a"], device=dev)
    b = torch.tensor(kinfo["b"], device=dev)

    def mvr(bv):
        return (H(bv) - bv * b) * a_inv

    chebyshev_moments(mvr, psi, 4, doubling_trick=True)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chebyshev_moments(mvr, psi, 4, doubling_trick=True)  # 3 applies
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=15)
    print("profile (3 applies + 6 dots):\n" + table)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--L", type=int, default=28)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    if args.L % 2 or not 16 <= args.L <= 32:
        raise SystemExit("--L must be even, 16..32")

    phase_device()
    dev = torch.device("cuda")
    import spindynamics_tpu_torch  # noqa: F401  (pins TF32 off)

    phase_build()
    phase_k1(16, dev)
    abs_err, rel_err, k_ms, p_ms = phase_k1(args.L, dev)
    phase_oracle(dev)
    launches, psi, E0, kinfo = phase_main(args.L, dev)
    if args.profile:
        phase_profile(args.L, dev, psi, kinfo)
    print(json.dumps({"kernels": [{
        "name": "K1 fused kron group apply",
        "route": "cuda",
        "source": "spindynamics_tpu_torch/csrc/kron_group.cu",
        "replaces": "spindynamics_tpu/ops/pallas_kron.py:217",
        "launches": launches,
        "max_abs_err": abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
