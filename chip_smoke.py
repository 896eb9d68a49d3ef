"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two paths once each, through the entry points a user
calls: the sector_kron ground state of the Heisenberg chain in the Sz=0
sector (groundstate_kron) and its KPM S(q, omega) (kpm_sqw_kron), with
every H apply's fused groups through K1, the hand-written CUDA group-apply
kernel; and the domain-wall trajectory of the XXZ chain
(evolve_trajectory_kron), with every Chebyshev term k >= 2 through K2, the
hand-written CUDA Chebyshev-term kernel.

Phases (one line each; a failed phase raises and the script exits non-zero
with no result line):
  device   require CUDA; the card's name and power limit from nvidia-smi
  build    compile K1 (csrc/kron_group.cu) and K2 (csrc/cheb_term.cu), one
           nvcc each, both at once
  k1       K1 against its plain torch version on the card, at L=16 (every
           group) and at --L (the fused groups), with and without the
           Lanczos axpy seed; pad slots exactly 0; warm CUDA-event times
  k2       K2 against its plain version on the card, at L=16 and at --L
           (the K2-fused groups, seeds as on the main path); pads 0; event
           times of K2's part of a term and of a whole term
  oracle   L=16 ground state on the card against the CPU x64 energy
  main     --L ground state + S(q, omega) for q = 2 pi k / L, k in (4, 7, L/2)
  evolve-oracle  L=12 domain-wall trajectory on the card (K2) against
           exact evolution (dense H, scipy eigh)
  evolve   --L domain-wall trajectory, 5 steps of dt=0.1, cheb_n=40
  typicality  L=20 <Sz_a(t) Sz_a(0)>_beta=1 at t = 0, 0.5, 1
  profile  (--profile) torch.profiler kernel tables of one KPM moment step
           and of one Chebyshev term
Then one JSON line with the kernel records, and last the device line.

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


def dense_sector_H(model):
    """(H, states): the model's Hamiltonian as a dense float64 matrix over
    its Sz sector basis (ascending bitstrings, bit i = site i), built in
    numpy from the couplings alone: diagonal sum_zz J sz_i sz_j +
    sum_i h_i sz_i, and J between states that differ by a flip of a hopping
    bond's two bits."""
    from spindynamics_tpu_torch.basis import build_sector_basis

    L = model.L
    states = build_sector_basis(L, model.nup).astype(np.int64)
    sz = ((states[:, None] >> np.arange(L)) & 1) - 0.5
    diag = sz @ np.asarray(model.field, np.float64)
    for (i, j), J in zip(model.zz_sites, np.asarray(model.zz_J, np.float64)):
        diag = diag + J * sz[:, i] * sz[:, j]
    H = np.diag(diag)
    for (i, j), J in zip(model.hop_sites,
                         np.asarray(model.hop_J, np.float64)):
        src = np.nonzero(sz[:, i] != sz[:, j])[0]
        dst = np.searchsorted(states, states[src] ^ ((1 << i) | (1 << j)))
        H[dst, src] += J
    return H, states


def exact_sz_trajectory(model, bitstring, dt, n_steps):
    """[n_steps, L] <Sz_i> after each of n_steps exact e^{-iH dt} steps
    from |bitstring>, by dense eigendecomposition (scipy.linalg.eigh)."""
    import scipy.linalg

    H, states = dense_sector_H(model)
    E, V = scipy.linalg.eigh(H)
    c = V[np.searchsorted(states, bitstring)].astype(np.complex128)
    sz = ((states[:, None] >> np.arange(model.L)) & 1) - 0.5
    out = []
    for k in range(1, n_steps + 1):
        psi = V @ (np.exp(-1j * E * dt * k) * c)
        out.append((np.abs(psi) ** 2) @ sz)
    return np.asarray(out)


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
    from concurrent.futures import ThreadPoolExecutor

    from spindynamics_tpu_torch.ops import cheb_term as ct
    from spindynamics_tpu_torch.ops import kron_group as kg

    builds = (("K1", kg.build_kernel), ("K2", ct.build_kernel))
    with ThreadPoolExecutor(len(builds)) as ex:  # one nvcc per source
        futs = [(name, ex.submit(fn)) for name, fn in builds]
        infos = [(name, f.result()) for name, f in futs]
    for name, info in infos:
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build: {name} nvcc sm_90a {info['seconds']:.2f} s -> "
              f"{info['path']} | {' ; '.join(regs)}")


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


def _evolve_model(L):
    import spindynamics_tpu_torch as pt

    return pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2)


def phase_k2(L, dev):
    """K2 vs cheb_term_apply_reference on the same CUDA tensors, one term
    of the evolve model at L with main-path seeds. Returns (max abs err,
    max rel err, K2 ms, plain ms) for K2's part of one term (sum over the
    K2-fused groups)."""
    from spindynamics_tpu_torch.ops import cheb_term as ct
    from spindynamics_tpu_torch.ops import kron_group as kg
    from spindynamics_tpu_torch.ops.sector_kron import make_sector_kron_layout
    from spindynamics_tpu_torch.solvers import kron_evolve as ke
    from spindynamics_tpu_torch.solvers.blockvec import bv_random

    m = _evolve_model(L)
    lay = make_sector_kron_layout(m, m.kron_splits)
    planes = ke.kron_planes_matvec_fn(lay, device=dev)
    H = planes.H
    g = torch.Generator(device=dev).manual_seed(L)
    prev, curr, acc = ((bv_random(lay, g, torch.float32, dev),
                        bv_random(lay, g, torch.float32, dev))
                       for _ in range(3))
    fused = kg.fused_group_set(lay, planes.cheb_top_k)
    args = [a for _, a in ct.term_launches(lay, H.tables, H.calls, fused,
                                           prev, curr, acc)]
    scal = (0.083, -0.41, 0.37, -0.62)  # 1/a, b, c_r, c_i
    abs_err = rel_err = 0.0
    for (T, pv, ac, seed, srcs, srcsh, call) in args:
        acc_k = tuple(x.clone() for x in ac)
        acc_p = tuple(x.clone() for x in ac)
        got = ct.cheb_term_apply(T, pv, acc_k, seed, srcs, srcsh, call, scal)
        want = ct.cheb_term_apply_reference(T, pv, acc_p, seed, srcs, srcsh,
                                            call, scal)
        torch.cuda.synchronize()
        (_, _, _, ch, cm, cl, cmp, clp) = lay.groups[call.gi]
        for x in got:
            if x[:, cm:, :].any() or x[:, :, cl:].any():
                raise RuntimeError(f"L={L} group {call.gi}: pad slots not 0")
        for x, y in zip((*got, *acc_k), (*want, *acc_p)):
            d = float((x - y).abs().max())
            abs_err = max(abs_err, d)
            rel_err = max(rel_err, d / max(float(y.abs().max()), 1e-30))
    if not rel_err <= 1e-5:
        raise RuntimeError(f"L={L}: K2 vs plain rel err {rel_err:.3e} > 1e-5")

    def run(fn):
        def go():
            for a in args:
                fn(*a, scal)
        return go

    k_ms = _event_ms(run(ct.cheb_term_apply))
    p_ms = _event_ms(run(ct.cheb_term_apply_reference))
    k_ms2 = _event_ms(run(ct.cheb_term_apply))
    p_ms2 = _event_ms(run(ct.cheb_term_apply_reference))
    del args
    a_inv, b = scal[:2]
    term_f = _event_ms(lambda: ct.cheb_term_fused(
        lay, H.tables, H.calls, fused, prev, curr, acc, scal), reps=10)
    term_p = _event_ms(lambda: ke._plain_term(
        planes, prev, curr, acc, scal[2:], (a_inv, b)), reps=10)
    print(f"k2 L={L} splits={lay.splits}: {len(fused)}/{len(lay.groups)} "
          f"groups fused | max|d|/max|y| {rel_err:.3e} (<= 1e-5), max|d| "
          f"{abs_err:.3e}, pads 0 | K2 part of one term (median of 20, "
          f"K2/plain/K2/plain): K2 {k_ms:.3f} ms, plain {p_ms:.3f} ms, K2 "
          f"{k_ms2:.3f} ms, plain {p_ms2:.3f} ms | whole term (median of "
          f"10): fused (seeds + K2 + tail) {term_f:.3f} ms, unfused (two "
          f"K1 applies + torch combine) {term_p:.3f} ms")
    return abs_err, rel_err, min(k_ms, k_ms2), min(p_ms, p_ms2)


def phase_evolve_oracle(dev):
    """L=12 domain-wall trajectory on the card through K2 against exact
    evolution in float64."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import cheb_term as ct

    m = _evolve_model(12)
    bits = pt.domain_wall_bitstring(m)
    n0 = ct.kernel_launch_count()
    _, obs, info = pt.evolve_trajectory_kron(m, bits, dt=0.1, n_steps=5,
                                             cheb_n=40, device=dev)
    n_k2 = ct.kernel_launch_count() - n0
    ref = exact_sz_trajectory(m, bits, 0.1, 5)
    err = float(np.abs(obs - ref).max())
    print(f"evolve-oracle L=12: max |d<Sz_i>| over 5 steps {err:.2e} "
          f"(<= 1e-4) against exact evolution (924 states, scipy eigh) | "
          f"norm drift {info['norm_drift']:.2e} | K2 launches {n_k2}")
    if not err <= 1e-4:
        raise RuntimeError(f"L=12 trajectory off exact evolution by {err}")
    if not n_k2 > 0:
        raise RuntimeError("the L=12 trajectory launched K2 no time")


def phase_evolve(L, dev):
    """The evolve path at L: evolve_trajectory_kron from the domain wall,
    bounds from its 40-step Lanczos. Returns (K2 launches, planes' args for
    the profile)."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import cheb_term as ct
    from spindynamics_tpu_torch.ops import kron_group as kg

    m = _evolve_model(L)
    bits = pt.domain_wall_bitstring(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kg.reset_kernel_launch_count()
    ct.reset_kernel_launch_count()
    (pair, obs, info), t_all = _sync_time(lambda: pt.evolve_trajectory_kron(
        m, bits, dt=0.1, n_steps=5, cheb_n=40, device=dev))
    n_k1, n_k2 = kg.kernel_launch_count(), ct.kernel_launch_count()
    peak = torch.cuda.max_memory_allocated()
    steps = info["step_seconds"]
    norms = info["norms"]
    tot = obs.sum(axis=1)
    np.set_printoptions(precision=4, suppress=True, linewidth=250)
    print(f"evolve L={L}: Ebounds ({info['Ebounds'][0]:.6f}, "
          f"{info['Ebounds'][1]:.6f}) | seconds per step median "
          f"{float(np.median(steps)):.3f} (steps {[round(x, 3) for x in steps]})"
          f" | bounds solve {info['bounds_seconds']:.2f} s | all "
          f"{t_all:.2f} s | peak {peak / 2**30:.2f} GiB | K1 launches "
          f"{n_k1}, K2 launches {n_k2} | norms "
          f"{[f'{x:.7f}' for x in norms]} | max |sum_i <Sz_i>| "
          f"{float(np.abs(tot).max()):.2e}")
    print(f"evolve L={L}: <Sz_i> after step 1 {obs[0]}")
    print(f"evolve L={L}: <Sz_i> after step 5 {obs[-1]}")
    if not (n_k1 > 0 and n_k2 > 0):
        raise RuntimeError(f"the evolve path launched K1 {n_k1} and K2 "
                           f"{n_k2} times: both must run")
    if not (np.all(np.isfinite(obs)) and np.all(np.isfinite(norms))
            and np.all(np.isfinite(info["Ebounds"]))):
        raise RuntimeError("non-finite trajectory")
    if not np.all(np.abs(norms - 1.0) <= 1e-4):
        raise RuntimeError(f"norms off 1 by more than 1e-4: {norms}")
    if not np.all(np.abs(tot) <= 1e-5):
        raise RuntimeError(f"sum_i <Sz_i> not conserved: {tot}")
    if not (obs[0][0] > 0.49 and obs[0][L - 1] < -0.49):
        raise RuntimeError("the chain's ends moved in the first step")
    return n_k2, info


def phase_typicality(dev):
    import spindynamics_tpu_torch as pt

    L = 20
    m = _evolve_model(L)
    ts = (0.0, 0.5, 1.0)
    (G, dt) = _sync_time(lambda: pt.typicality_correlation_kron(
        m, 1.0, L // 2, L // 2, ts, device=dev))
    print(f"typicality L={L} beta=1 sites ({L // 2}, {L // 2}): "
          f"{[complex(round(z.real, 6), round(z.imag, 6)) for z in G]} at t "
          f"{ts} | {dt:.2f} s")
    if not np.all(np.isfinite(G)):
        raise RuntimeError("non-finite typicality correlation")
    if not (abs(G[0].real - 0.25) <= 1e-3 and abs(G[0].imag) <= 1e-3):
        raise RuntimeError(f"<Sz^2> at t=0 is {G[0]}, not 0.25")


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


def phase_profile_term(L, dev, info):
    """Kernel-time table of one fused Chebyshev term (seeds + K2 + tail) at
    the trajectory's bounds."""
    from spindynamics_tpu_torch.ops import cheb_term as ct
    from spindynamics_tpu_torch.ops import kron_group as kg
    from spindynamics_tpu_torch.ops.sector_kron import make_sector_kron_layout
    from spindynamics_tpu_torch.solvers import kron_evolve as ke
    from spindynamics_tpu_torch.solvers.blockvec import bv_random
    from spindynamics_tpu_torch.solvers.chebyshev import chebyshev_coefficients
    from torch.profiler import ProfilerActivity, profile

    m = _evolve_model(L)
    lay = make_sector_kron_layout(m, m.kron_splits)
    planes = ke.kron_planes_matvec_fn(lay, device=dev)
    H = planes.H
    g = torch.Generator(device=dev).manual_seed(1)
    prev, curr, acc = ((bv_random(lay, g, torch.float32, dev),
                        bv_random(lay, g, torch.float32, dev))
                       for _ in range(3))
    c_ri, (a_inv, b) = ke._coeff_arrays(chebyshev_coefficients(
        0.1, info["Ebounds"][0], info["Ebounds"][1], 40))
    scal = (a_inv, b, float(c_ri[2, 0]), float(c_ri[2, 1]))
    fused = kg.fused_group_set(lay, planes.cheb_top_k)

    def term():
        return ct.cheb_term_fused(lay, H.tables, H.calls, fused, prev, curr,
                                  acc, scal)

    term()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        term()
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=15)
    print("profile (one fused Chebyshev term):\n" + table)


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
    phase_k2(16, dev)
    abs_err2, rel_err2, k2_ms, p2_ms = phase_k2(args.L, dev)
    phase_oracle(dev)
    launches, psi, E0, kinfo = phase_main(args.L, dev)
    if args.profile:
        phase_profile(args.L, dev, psi, kinfo)
    del psi
    phase_evolve_oracle(dev)
    launches2, einfo = phase_evolve(args.L, dev)
    if args.profile:
        phase_profile_term(args.L, dev, einfo)
    phase_typicality(dev)
    print(json.dumps({"kernels": [{
        "name": "K1 fused kron group apply",
        "route": "cuda",
        "source": "spindynamics_tpu_torch/csrc/kron_group.cu",
        "replaces": "spindynamics_tpu/ops/pallas_kron.py:217",
        "launches": launches,
        "max_abs_err": abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "K2 fused Chebyshev term",
        "route": "cuda",
        "source": "spindynamics_tpu_torch/csrc/cheb_term.cu",
        "replaces": "spindynamics_tpu/ops/pallas_cheb.py:64",
        "launches": launches2,
        "max_abs_err": abs_err2,
        "ms": k2_ms,
        "plain_ms": p2_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
