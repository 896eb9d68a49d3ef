"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths once each, through the entry points a user
calls: the sector_kron ground state of the Heisenberg chain in the Sz=0
sector (groundstate_kron) and its KPM S(q, omega) (kpm_sqw_kron), with
every H apply's fused groups through K1, the hand-written CUDA group-apply
kernel; the domain-wall trajectory of the XXZ chain
(evolve_trajectory_kron), with every Chebyshev term k >= 2 through K2, the
hand-written CUDA Chebyshev-term kernel; the same trajectory with
bfloat16 states (state_dtype=torch.bfloat16), through the bfloat16
instances of K1 and K2; the Lanczos S(q, omega) and the correlation
observables on the kron ground state (lanczos_sqw_kron, szsz_matrix_kron,
structure_factor_Sq_kron, kpm_correlation_matrix_kron), every H apply
through K1; and the flat-state path on the
embedded layout (ground state, Lanczos and KPM S(q, omega), domain-wall
trajectory on one vector of 2^L amplitudes), with every H apply through K3,
the hand-written CUDA fused matvec; the same solvers on the compact sector
layout (the ascending Sz sector and its ELL neighbour table, built on the
card; the ell gather apply is plain torch, as the JAX package's is an XLA
gather); flat quantum typicality on both layouts (K3, ell); checkpointed
ground states and trajectories resumed bit for bit; and the sharded kron path (`mesh=`):
the ground state, the KPM S(q, omega) and the trajectory again on
LocalMesh(--shards): four row shards of every kron group on the one card, every
fused group's local block through K1's crossw variant (its mid|hi terms read
from exchanged windows), and one apply and a short solve on a ProcessMesh
over an NCCL group of one rank.

Phases (one line each; a failed phase raises and the script exits non-zero
with no result line):
  device   require CUDA; the card's name and power limit from nvidia-smi
  build    compile K1 (csrc/kron_group.cu), K2 (csrc/cheb_term.cu), K3
           (csrc/fused_matvec.cu), the dot2 kernel (csrc/dot2.cu) and the
           ell kernel (csrc/ell_apply.cu), one nvcc each, all at once
  k1       K1 against its plain torch version on the card, at L=16 (every
           group) and at --L (the fused groups), with and without the
           Lanczos axpy seed; pad slots exactly 0; a second launch on the
           same inputs identical in every byte; warm CUDA-event times
  k2       K2 against its plain version on the card, at L=16 and at --L
           (the K2-fused groups, seeds as on the main path); pads 0; repeats
           identical; event times of K2's part of a term and of a whole term
  k1-bf16  K1's bfloat16 instance against its plain version on the card, at
           L=16 and at --L: the bf16 output against the plain version's
           float32 value before rounding (one rounding: |d| <= 2^-8 |y| +
           1e-5 max|y|, the second term for the float32 reassociation of the
           tile sums); pads 0; event times beside the float32 kernel's
  k2-bf16  K2's bfloat16 instance likewise: next against the float32 x
           before rounding, the float32 accumulator (updated from the
           unrounded x) at K2's float32 tolerance; times beside float32
  k1-fma   K1's FMA route (tables that are not exactly bf16) at L=16 and
           --L: the XXZ chain with Jxy=0.3 against the plain version (1e-5,
           pads 0, repeats identical); the main model's K1 launches and the
           evolve model's K2 launches with every segment forced onto the
           FMAs, held to the tensor-core route and timed beside it
  dot2     the dot2 kernel (every compensated dot of the solvers: one
           launch over all leaves) against its plain version (the per-leaf
           Dot2) and the float64 torch reference on the same CUDA tensors:
           a random --L BlockVec (<x|y> and <x|x> over the kron leaves),
           a flat 2^26 float32 vector and a complex64 one (vdot2, three
           launches); within one float32 ulp of float64, no farther from
           the plain Dot2 than the plain version is from float64, repeats
           equal in every bit, one launch a call; CUDA-graph times of the
           kernel, the plain Dot2, torch.dot of the same numbers (the
           library call: float32 accumulation, less accurate) and a copy of
           the same bytes, beside the bytes bound
  oracle   L=16 ground state on the card against the CPU x64 energy
  main     --L ground state + S(q, omega) for q = 2 pi k / L, k in (4, 7, L/2);
           K1 and the dot2 kernel launched
  evolve-oracle  L=12 domain-wall trajectory on the card (K2) against
           exact evolution (dense H, scipy eigh)
  evolve   --L domain-wall trajectory, 5 steps of dt=0.1, cheb_n=40 (K1,
           K2 and the dot2 kernel launched)
  evolve-bf16  the same trajectory with bfloat16 states and the float32
           run's bounds: every <Sz_i> within 2e-2 of the float32 run, norm
           drift < 5e-2, |sum_i <Sz_i>| <= 1e-2, bf16 leaves, the float32
           run's launch counts, all of them of the bf16 instances; seconds
           per step and peak memory beside float32; before it an L=12 bf16
           trajectory against exact evolution at 2e-2
  kron-sqw --L lanczos_sqw_kron from main's ground state (3 q x 60 steps)
  kron-obs --L szsz_matrix_kron (diagonal 1/4, rows sum to 0), S(q) >= 0,
           kpm_correlation_matrix_kron for one B site x 100 moments
  typicality  L=20 <Sz_a(t) Sz_a(0)>_beta=1 at t = 0, 0.5, 1
  k3       K3 against its plain torch version on the card, real and complex,
           at L=16 (the XXZ chain and an all-pairs model) and at --L-flat:
           exact zeros outside the sector, bit-identical repeats, event
           times of K3, the plain version and an N-sized copy, K3 / copy,
           the designed passes of each type's tile and the rate achieved
           over them; and the time of one torch sparse CSR product H @ psi
           for the same model (at L=22, and at --L-flat where it fits)
  flat-oracle  L=12 ground state and 10-step domain-wall trajectory through
           K3 against the float64 dense oracle on the host
  flat-main  --L-flat embedded XXZ chain, Sz=0: ground state, lanczos_sqw
           and kpm_sqw at 3 q-points, 5-step domain-wall trajectory, and the
           same model through the kron layout (K1, K2) as a cross-check:
           E0, <Sz_i>, and from the kron ground state carried to the flat
           layout, S(q, omega) (lanczos_sqw_kron against lanczos_sqw in
           float64 on the plain applies, held to 1e-4 of the peak and 1e-4
           in each row's weight; the float32 runs through K1 and K3 each
           against its float64 run: after 2 steps at every q, 1e-4 of the
           peak; after 60, 1e-2 in each row's weight and 5e-2 of the peak
           at k = 4, 7), szsz and S(q) (kron
           against flat observables, 1e-5); the flat solvers' dots launch
           the dot2 kernel
  compact-oracle  L=16 compact models (XXZ with a field, all-pairs), float64
           and float32: the card's torch build of the states and ELL table
           equal to the host build bit for bit, the ell apply on the card
           against the CPU apply (1e-12 / 1e-6 of max|y|, real and complex)
  compact-main  --L-compact (default 28) compact Heisenberg chain, Sz=0: the
           torch build's time and table bytes; then the ell phase on its
           module (below); the restarted ground state (E0 within 1e-4 of
           main's kron E0, residual <= 1e-3), kpm_sqw at main's q-points,
           omega grid and rescaling (within 5e-2 of main's peak),
           lanczos_sqw (3 q x 60, rows positive), the 5-step domain-wall
           trajectory of evolve's XXZ chain from its bounds (<Sz_i> within
           1e-5 of the kron run), each solve's ell applies each one kernel
           launch by `launches.ell.<dtype>`, peak memory
  ell      (inside compact-main, or alone with --ell-only) the ell kernel
           (csrc/ell_apply.cu) at --L-compact, float32 and complex64: its
           CUDA-event time beside its bytes bound (the int32 table once,
           the state and diagonal read, the result written), the plain
           version's (the chunked torch gather) and a torch sparse CSR
           product of the same matrix (library_ms), each held to the plain
           result within 1e-6 of max|y|; repeats bit-identical; one launch
           an apply
  flat-typicality  <Sz_a(t) Sz_a(0)>_beta=1 at --L-flat on the embedded
           layout (K3) and the compact layout (ell): finite, Im C(0) ~ 0,
           C(0) = szsz of the thermal state of the same seed; L=12 mean of 8
           samples within 0.05 of dense expm; L=16 krylov, chebyshev and
           rk4 within 1e-4
  checkpoint  L=20 compact: a checkpointed ground state cut after 2 of 4
           cycles and resumed, and a trajectory cut after 4 of 6 steps and
           resumed, each equal to the uninterrupted run bit for bit
  k1-crossw  K1's crossw variant (float32 and bfloat16 states) against its
           plain version on the card, on the local blocks of LocalMesh(D) at
           L=16 (every group fused, D = 2 and 4) and at --L (D = --shards):
           windows
           built by the mesh, seeds reduce-scattered; tile pads and the hi
           padding rows exactly 0; event times of the windowed launches of
           one sharded apply beside K1's unsharded launches of the same
           groups; the bound from the run's shapes (real hi rows only, of
           each window the rows of its mid runs)
  shard-apply  --L, LocalMesh(D) for D = 1, 2, 4, 8: the sharded fused apply
           against the unsharded fused apply of the same state (1e-5 of
           max|y|); ms per apply and its parts (windows, seeds = partials +
           reduce-scatter, kernels, tails); the mesh's byte counters equal to
           collective_traffic_model; peak memory of one apply; D = 1 launches
           no crossw instance
  shard-main  --L ground state + KPM S(q, omega) with mesh=LocalMesh(--shards),
           the main phase's q-points and depth: E0 within 1e-4 of main's,
           residual <= 1e-3, S within 5e-2 of main's peak
  shard-evolve  --L 5-step domain-wall trajectory with mesh=LocalMesh(--shards)
           from the evolve phase's bounds, observed through
           magnetization_per_site_kron_sharded: <Sz_i> within 1e-5 of the
           evolve phase's; no K2 launch (the sharded terms run plain)
  dist-1   ProcessMesh over an NCCL group of world size 1: one --L apply and
           an L=16 ground state equal to LocalMesh(1)'s (skipped, and said
           so, where torch.distributed has no NCCL)
  sector-blocked  --L Heisenberg chain on the sector_blocked layout,
           float32: the card's torch build of its states and diagonal equal
           to the host build bit for bit; the apply against ell on the
           compact model of the same couplings (1e-5 of max|y|, float32 and
           complex64), timed in turns with ell and a torch sparse CSR
           product beside its bytes bound, and the device's busy time in
           one apply (torch.profiler); a restarted ground state within
           1e-4 of main's E0 (plain torch: no kernel)
  cli      the port's command line, each command in its own process
           (python -m spindynamics_tpu_torch.cli through runpy, so that the
           process reports its kernels' launch counts and peak memory at
           exit): groundstate and sqw --method kpm --kpm-m 10 at --L (auto:
           sector_kron, K1; E0 within 1e-4 of main's, S finite and >= 0),
           evolve at --L (K2; 5 steps of the evolve phase's trajectory,
           <Sz_i> within 1e-5 of it), groundstate --layout embedded at
           --L-flat (K3; E0 within 1e-4 of flat-main's), typicality and sqw
           --method lanczos at L=20 (auto: embedded, K3), groundstate
           --twopass --lanc-m 40 at L=24 with and without --mesh 4 (K1's
           crossw variant; E0 within 1e-4), groundstate --layout
           sector_blocked at --L (E0 within 1e-4
           of main's); a non-zero exit, or a kernel of the command's path
           launched no time, fails the phase
  examples the port's examples (spindynamics_tpu_torch/examples/) as a user
           runs them, each module's main(argv) in this process with K1's
           and K2's counts set to 0 just before it and read just after,
           example_large_L as a `python -m` process: example_large_L 24 and
           gs_ladder 16 24 (E0 within 1e-4 of docs/PARITY.md),
           example_kron_sqw 28 100 8 (E0 within 1e-4 of PARITY's and of
           main's, S finite and >= -1e-6 max, each row's weight on the
           omega grid 0.9-1.01 of a, the sum rule; S_max printed beside
           PARITY's 21.30, not held: PERF.md, section 6),
           example_kron_lanczos_sqw 28 100 2, example_kron_evolve
           28 20 (<Sz_i> within 1e-4 of the first rows of
           examples/example_kron_evolve_L28.npz, |norm - 1| and |sum_i
           <Sz_i>| <= 1e-5), example_kron_typicality 28 (the script's
           checks, C(0) = 1/4 to 1e-5, C(t) within 1e-2 of PARITY's),
           example_kron_corr 24, and the five flat modules on the compact
           layout held to the same modules on the CPU; a kron example that
           launches no K1, or a trajectory or typicality run no K2, fails
           the phase. --examples-full adds the published depth: 60 steps
           at L=28 and 40 at L=30 against their .npz files, the L=32
           ground state (E0/L within 1e-5 of PARITY's)
  bench    the port's bench as a user runs it, each in its own process:
           python -m spindynamics_tpu_torch.bench --time-budget 300 (the
           L=32 headline and bench.py's default matrix, every point held
           to its plain version before it prints; held here: bench.py's
           seven names in order, the headline first and last, every
           vs_baseline in (0, 1.05] against bounds that count the same work
           whatever implements it, the card's name on every line, K1, K2
           and K3 launched and K1's crossw variant not), then
           scripts.bench_kron 24 and scripts.mxu_calibrate --bf16 (the
           card's product and copy rates beside the data sheet's)
  profile  (--profile) torch.profiler kernel tables of one KPM moment step,
           of one Chebyshev term, and of flat Lanczos and Chebyshev steps
  k3-tiles (--k3-tiles) K3's time at --L-flat for tiles of 2^8..2^15
           (2^14 complex64), each held to the default tile's result
  kron-tiles (--kron-tiles) K1's and K2's time at --L with 32- and 64-row
           output tiles beside the kernel's rule; results identical
Then one JSON line with the cli commands' records (wall and solve
seconds, peak memory, launches per kernel), one with the examples' records
(argv, wall seconds, peak memory, K1 and K2 launches, checks), one with
the sector_blocked apply's numbers (plain torch, not a kernel) and one
with the compact path's (the ell kernel's times, bounds, CSR time, and
each solve's applies and kernel launches), one with the bench phase's records (`bench`: the bench's
lines; its process's launches, bench_kron's and the calibration's
records), one with the kernel
records (`cli_launches`, `examples_launches`: the kernel's launches in
the cli and examples phases), and last the device line.

The bounds in the kernel records are the larger of bytes over 3.35 TB/s
(each input read once, each output written once) and the operations of the
route each K segment took: bf16 tensor-core products (two passes for a
float32 state, one for a bfloat16 state) over 989 TFLOP/s and float32 FMAs
over 67 TFLOP/s (the H100 SXM data sheet). `fma_route_bound_ms` is the
bound with every product on the FMAs; `fma_ms` the FMA route's time on the
same launches, measured beside the tensor-core route (`tc_ms_beside_fma`).
The dot2 kernel's record is the main path's <x|y> at --L (its bound the
bytes alone; `launches` from the main phase) with the phase's other
readings beside it; it replaces no pl.pallas_call, so `replaces` names the
JAX package's compensated dot, an XLA fusion there. The ell kernel's
record is the ell phase's, its `launches` the kernel launches counted over
compact-main's solves (one an apply, or the phase raises).

The sharded, compact, sector-blocked, cli, examples and bench phases come
on top of the earlier ones, none of which is cut in depth for them (the cli
phase cuts its own: --kpm-m 10, and --twopass --lanc-m 40 for the L=24
pair; the examples phase its own: nq 2 for the Lanczos S(q, omega), 20 of
the 60 trajectory steps, no L=30 or L=32 without --examples-full; the bench
runs its defaults): with the defaults the whole script takes about 15
minutes on an H100 80GB HBM3 (the examples phase about 4.5, the bench
phase about 1; the limit is 20), with --examples-full about 2 more.

Usage: python3 chip_smoke.py [--L 28] [--L-flat 26] [--L-compact 28]
                             [--shards 4] [--profile] [--k3-tiles]
                             [--kron-tiles] [--examples-full]
       python3 chip_smoke.py --bench-only | --shard-flat | --bf16-steps
                             | --dot2-only [--L 28] | --ell-only
                             [--L-compact 28]
       python3 chip_smoke.py --k3-against DIR [--L-flat 26]
(--k3-against runs only the k3 phase, of the checkout at DIR and of this
one in turns; --bench-only, --shard-flat, --bf16-steps, --dot2-only and
--ell-only build the kernels and run their phases alone; none of them
prints a result line.)
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from spindynamics_tpu_torch.utils.dtypes import err_ratio
from spindynamics_tpu_torch.utils.profiling import (
    BF16_TC_FLOPS_PER_S, F32_FLOPS_PER_S, HBM_BYTES_PER_S, card_info,
    event_ms, graph_ms, sync_time)

# docs/PARITY.md: L=16 CPU x64; L=28 and L=32 f32 ground states (physical
# energies used as oracles, not speed figures)
E0_REF = {16: -11.67077735, 28: -20.663187, 32: -23.661858}


def _bound(n_bytes, flops, tc_flops=0.0):
    """(bound_ms, bound_by): the least time the card could take for
    `n_bytes` of traffic, `flops` float32 operations on the CUDA cores and
    `tc_flops` bf16 operations on the tensor cores."""
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = (flops / F32_FLOPS_PER_S + tc_flops / BF16_TC_FLOPS_PER_S) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _bounds(works):
    """The bound of a list of _group_work records summed, on the routes
    the segments took, and (the FMA route's bound) with every product on
    the CUDA cores. Returns (route bound, FMA-route bound, GB, GFLOP of
    products once, of which GFLOP on the tensor cores per pass)."""
    nb, fma, tc, fma_all, prod, tc1 = (sum(w[i] for w in works)
                                       for i in range(6))
    return (_bound(nb, fma, tc), _bound(nb, fma_all), nb / 1e9, prod / 1e9,
            tc1 / 1e9)


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
    # name, power limit: every time below is on this card
    print(card_info()["smi"])
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} | "
          f"count {torch.cuda.device_count()}")


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from spindynamics_tpu_torch.ops import cheb_term as ct
    from spindynamics_tpu_torch.ops import dot2 as d2
    from spindynamics_tpu_torch.ops import ell_apply as ea
    from spindynamics_tpu_torch.ops import fused_matvec as fm
    from spindynamics_tpu_torch.ops import kron_group as kg

    builds = (("K1", kg.build_kernel), ("K2", ct.build_kernel),
              ("K3", fm.build_kernel), ("dot2", d2.build_kernel),
              ("ell", ea.build_kernel))
    with ThreadPoolExecutor(len(builds)) as ex:  # one nvcc per source
        futs = [(name, ex.submit(fn)) for name, fn in builds]
        infos = [(name, f.result()) for name, f in futs]
    for name, info in infos:
        regs = [ln.strip() for ln in info["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build: {name} nvcc sm_90a {info['seconds']:.2f} s -> "
              f"{info['path']} | {' ; '.join(regs)}")


def _dot2_leaves_on(lay, dev, seed):
    """Two random float32 BlockVecs of `lay`'s group shapes on `dev`, each
    leaf a view into one buffer at a 16-byte aligned offset (the gaps hold
    zeros): (x leaves, y leaves, x buffer, y buffer). torch.dot of the two
    buffers is then one library call over the same numbers."""
    shapes = [(ch, cmp, clp) for (_, _, _, ch, _, _, cmp, clp) in lay.groups]
    sizes = [int(np.prod(s)) for s in shapes]
    offs = np.concatenate([[0], np.cumsum([-(-n // 4) * 4 for n in sizes])])
    g = torch.Generator(device=dev).manual_seed(seed)
    bufs = []
    for _ in range(2):
        b = torch.zeros(int(offs[-1]), device=dev)
        for o, n in zip(offs[:-1], sizes):
            b[o:o + n] = torch.randn(n, generator=g, device=dev)
        bufs.append(b)
    leaves = [[b[o:o + n].view(s) for o, n, s in zip(offs[:-1], sizes,
                                                      shapes)]
              for b in bufs]
    return leaves[0], leaves[1], bufs[0], bufs[1]


def _dot2_check(xs, ys, what):
    """The kernel's sum against its plain version and the float64 torch
    reference on the same CUDA tensors: within one float32 ulp of the
    reference, no farther from the plain Dot2 than the plain version is
    from the reference plus one ulp, a second call equal in every bit, one
    launch. Returns (|kernel - reference|, kernel value)."""
    from spindynamics_tpu_torch.ops import dot2 as d2
    from spindynamics_tpu_torch.utils import compensated as comp

    n0 = d2.dot2_launch_count()
    k = comp.dot2_leaves(xs, ys)
    k2 = comp.dot2_leaves(xs, ys)
    torch.cuda.synchronize()
    n_launch = d2.dot2_launch_count() - n0
    plain = float(comp.dot2_leaves_plain(xs, ys))
    ref = float(sum(torch.dot(a.reshape(-1).double(), b.reshape(-1).double())
                    for a, b in zip(xs, ys)))
    kv = float(k)
    ulp = float(np.spacing(np.float32(abs(ref))))
    err = abs(kv - ref)
    print(f"dot2 {what}: kernel {kv!r} plain {plain!r} float64 {ref!r} | "
          f"|kernel - f64| {err:.3e} (1 ulp {ulp:.3e}), |plain - f64| "
          f"{abs(plain - ref):.3e} | launches per call {n_launch / 2:g}")
    if not (k.dtype == torch.float32 and torch.equal(k, k2)):
        raise RuntimeError(f"dot2 {what}: repeat not bit-equal")
    if not err <= ulp:
        raise RuntimeError(f"dot2 {what}: {err} off float64 (> 1 ulp {ulp})")
    if not abs(kv - plain) <= abs(plain - ref) + ulp:
        raise RuntimeError(f"dot2 {what}: kernel {kv} farther from plain "
                           f"{plain} than Dot2's own error")
    if n_launch != 2 * -(-len(xs) // d2.MAX_LEAVES):
        raise RuntimeError(f"dot2 {what}: {n_launch} launches for 2 calls")
    return err, kv


def phase_dot2(L, dev, n_flat=1 << 26):
    """The dot2 kernel (csrc/dot2.cu) against its plain version and the
    float64 reference on the card: a random --L BlockVec (the kron groups'
    leaves, the main path's dots <v|w> and <w|w>), a flat float32 vector
    and a complex64 one of n_flat amplitudes (vdot2: three launches).
    Times from CUDA-graph replays (the device's time, not the host's
    enqueue): the kernel, the plain Dot2, torch.dot of the same numbers
    (the library call: float32 accumulation, less accurate), a copy of the
    same bytes; the bound is the bytes read once at 3.35 TB/s (one float64
    FMA per element is far below any listed rate)."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import sector_kron as tsk
    from spindynamics_tpu_torch.utils import compensated as comp

    m = pt.heisenberg_chain(L, nup=L // 2)
    lay = tsk.make_sector_kron_layout(m, m.kron_splits)
    xs, ys, bx, by = _dot2_leaves_on(lay, dev, 0)
    n = sum(x.numel() for x in xs)
    errs = [_dot2_check(xs, ys, f"L={L} <x|y> ({len(xs)} leaves, {n} "
                                "amplitudes)")[0],
            _dot2_check(xs, xs, f"L={L} <x|x>")[0]]
    fx = torch.randn(n_flat, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1))
    fy = torch.randn(n_flat, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))
    errs.append(_dot2_check([fx], [fy], f"flat 2^{n_flat.bit_length() - 1}"
                                        " float32")[0])
    z = torch.complex(fx, fy)
    w = torch.complex(fy, -fx[torch.randperm(
        n_flat, device=dev, generator=torch.Generator(device=dev)
        .manual_seed(3))])
    zk = comp.vdot2(z, w)
    zr = torch.vdot(z.cdouble(), w.cdouble()).item()
    for part, got, want in (("re", zk.real, zr.real), ("im", zk.imag,
                                                        zr.imag)):
        e = abs(float(got) - want)
        ulp = float(np.spacing(np.float32(abs(want))))
        print(f"dot2 flat complex64 vdot2 {part}: kernel {float(got)!r} "
              f"float64 {want!r} | |d| {e:.3e} (1 ulp {ulp:.3e})")
        if not e <= ulp:
            raise RuntimeError(f"dot2 complex vdot2 {part}: {e} > 1 ulp")
        errs.append(e)

    def plain_vdot2():
        r, i, wr, wi = z.real, z.imag, w.real, w.imag
        return torch.complex(comp.dot2_leaves_plain([r, i], [wr, wi]),
                             comp.dot2_leaves_plain([r], [wi])
                             - comp.dot2_leaves_plain([i], [wr]))

    dst = torch.empty_like(bx)
    fdst = torch.empty_like(fx)
    zdst = torch.empty_like(z)
    t = {}
    for turn in range(2):  # plain, kernel, kernel, plain
        order = (("plain", "kernel") if turn == 0 else ("kernel", "plain"))
        for who in order:
            if who == "kernel":
                t.setdefault("ms", []).append(
                    graph_ms(lambda: comp.dot2_leaves(xs, ys)))
                t.setdefault("norm_ms", []).append(
                    graph_ms(lambda: comp.dot2_leaves(xs, xs)))
                t.setdefault("flat_ms", []).append(
                    graph_ms(lambda: comp.dot2(fx, fy)))
                t.setdefault("complex_ms", []).append(
                    graph_ms(lambda: comp.vdot2(z, w)))
            else:
                t.setdefault("plain_ms", []).append(
                    graph_ms(lambda: comp.dot2_leaves_plain(xs, ys)))
                t.setdefault("norm_plain_ms", []).append(
                    graph_ms(lambda: comp.dot2_leaves_plain(xs, xs)))
                t.setdefault("flat_plain_ms", []).append(
                    graph_ms(lambda: comp.dot2_leaves_plain([fx], [fy])))
                t.setdefault("complex_plain_ms", []).append(
                    graph_ms(plain_vdot2))
    t = {k: min(v) for k, v in t.items()}
    t["library_ms"] = graph_ms(lambda: torch.dot(bx, by))
    t["norm_library_ms"] = graph_ms(lambda: torch.dot(bx, bx))
    t["flat_library_ms"] = graph_ms(lambda: torch.dot(fx, fy))
    t["complex_library_ms"] = graph_ms(lambda: torch.vdot(z, w))
    t["copy_ms"] = graph_ms(lambda: dst.copy_(bx))
    t["flat_copy_ms"] = graph_ms(lambda: fdst.copy_(fx))
    t["complex_copy_ms"] = graph_ms(lambda: zdst.copy_(z))
    b = {"bound": _bound(2 * 4 * n, 0.0),
         "norm_bound_ms": _bound(4 * n, 0.0)[0],
         "flat_bound_ms": _bound(2 * 4 * n_flat, 0.0)[0],
         "complex_bound_ms": _bound(2 * 8 * n_flat, 0.0)[0]}
    print(f"dot2 L={L} ({n} amplitudes, {len(xs)} leaves): <x|y> kernel "
          f"{t['ms']:.4f} ms, plain Dot2 {t['plain_ms']:.4f} ms, torch.dot "
          f"(float32 accumulation, less accurate) {t['library_ms']:.4f} ms, "
          f"copy of the same bytes {t['copy_ms']:.4f} ms, bound "
          f"{b['bound'][0]:.4f} ms by {b['bound'][1]} | <x|x> kernel "
          f"{t['norm_ms']:.4f} ms, plain {t['norm_plain_ms']:.4f} ms, "
          f"torch.dot {t['norm_library_ms']:.4f} ms, bound "
          f"{b['norm_bound_ms']:.4f} ms")
    print(f"dot2 flat 2^{n_flat.bit_length() - 1}: float32 kernel "
          f"{t['flat_ms']:.4f} ms, plain {t['flat_plain_ms']:.4f} ms, "
          f"torch.dot {t['flat_library_ms']:.4f} ms, copy "
          f"{t['flat_copy_ms']:.4f} ms, bound {b['flat_bound_ms']:.4f} ms | "
          f"complex64 vdot2 kernel (3 launches) {t['complex_ms']:.4f} ms, "
          f"plain {t['complex_plain_ms']:.4f} ms, torch.vdot "
          f"{t['complex_library_ms']:.4f} ms, copy "
          f"{t['complex_copy_ms']:.4f} ms, bound "
          f"{b['complex_bound_ms']:.4f} ms")
    return dict(t, max_abs_err=max(errs), bound=b["bound"],
                **{k: v for k, v in b.items() if k != "bound"},
                L=L, leaves=len(xs), amplitudes=n, n_flat=n_flat)


def _k1_inputs(L, dev, sdt=torch.float32, model=None):
    """Layout, kernel calls and main-path-shaped K1 inputs at size L (the
    Heisenberg chain unless `model` is given): a random state of dtype
    `sdt`, the Lanczos axpy operands, and each fused group's seed (summed
    in float32, stored in `sdt`, as the apply does)."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import kron_group as kg
    from spindynamics_tpu_torch.ops.sector_kron import (
        apply_H_sector_kron, make_sector_kron_layout)
    from spindynamics_tpu_torch.solvers.blockvec import bv_random

    m = pt.heisenberg_chain(L, nup=L // 2) if model is None else model
    lay = make_sector_kron_layout(m, m.kron_splits)
    H = pt.KronHamiltonian(lay, dtype=torch.float32, device=dev)
    tables, calls = H.tables, H.calls
    g = torch.Generator(device=dev).manual_seed(L)
    bv = bv_random(lay, g, sdt, dev)
    b0 = bv_random(lay, g, sdt, dev)
    s = torch.tensor(-0.37, device=dev)
    fused = sorted(kg.fused_group_set(lay, H.top_k))
    args = []
    for gi in fused:
        c = calls[gi]
        seed = (apply_H_sector_kron(bv.leaves, None, lay, tables,
                                    terms=c.seed_terms, group_filter=(gi,))[gi]
                if c.has_seed else None)
        ax = s * b0.leaves[gi].float()
        seed_ax = (ax if seed is None else seed + ax).to(sdt)
        seed = None if seed is None else seed.to(sdt)
        srcs = [bv.leaves[x[0]] for x in c.cross]
        srcsh = [bv.leaves[x[0]] for x in c.crossh]
        args.append((bv.leaves[gi], seed, seed_ax, srcs, srcsh, c))
    return m, lay, H, bv, args


def _pow2(x):
    """x (as float32) is 0 or a power of two: a bf16 state times x is a
    bf16 (kron_tile.cuh segment())."""
    return float(np.frexp(np.float32(x))[0]) in (0.5, -0.5, 0.0)


def _group_work(call, seeded, planes=1, state_bytes=4, rows=None):
    """(bytes, FMA flops, tensor-core flops, flops with every product on
    the FMAs, product flops, tensor-core product flops) of one fused
    group's kernel launch: the group's own tensor read and written once
    (cross sources are other groups' tensors, counted with their own
    group), the seed and the tables read once (an exactly-bf16 table as its
    bf16 copy), and the matrix products of the hi-local terms on the route
    each segment takes (kron_tile.cuh segment()): a segment whose table is
    exactly bf16 runs on the tensor cores, twice for a float32 state (the
    hi/lo split) and once for a bfloat16 state (a bfloat16 state under a
    lo|mid value that is not a power of two takes the FMAs); every other
    segment runs float32 FMAs. K2 (planes=2) runs the products per plane,
    also reads prev and acc and writes acc, per plane, and runs the 10-flop
    epilogue. States take `state_bytes` an element (2 for bfloat16); D1-D3
    and K2's accumulator are float32 whatever the state. `rows` counts that
    many hi rows instead of the call's (a shard's last block: its real
    rows, not the zero padding)."""
    ch, cmp, clp = call.shape
    if rows is not None:
        ch = rows
    n = ch * cmp * clp
    passes = 1 if state_bytes == 2 else 2
    e_lo, e_mid, e_cross = call.exact
    fma = tc = tc1 = prod = tab = 0

    def seg(flops, size, exact, pow2=True):
        nonlocal fma, tc, tc1, prod, tab
        prod += flops
        on_tc = exact and (state_bytes == 4 or pow2)
        tab += (2 if exact else 4) * size
        if on_tc:
            tc += passes * flops
            tc1 += flops
        else:
            fma += flops

    if call.W_lo is not None:
        seg(2 * n * clp, clp * clp, e_lo)
    if call.W_mid_T is not None:
        seg(2 * n * cmp, cmp * cmp, e_mid)
    for (_, r0, c0, ln, val), (_, cmps, clps), ex in zip(
            call.cross, call.cross_shapes, e_cross):
        seg(2 * ch * ln * clps * clp, clps * clp, ex, _pow2(val))
    for t in (call.D1, call.D2, call.D3):
        tab += 0 if t is None else 4 * t.numel()
    sd = 1 if seeded else 0
    if planes == 1:
        return (state_bytes * n * (2 + sd) + tab, fma + 2 * n, tc,
                prod + 2 * n, prod, tc1)
    # per plane: T, prev and the seed in, next out (state); acc in and out
    return (2 * n * (state_bytes * (3 + sd) + 8) + tab, 2 * fma + 20 * n,
            2 * tc, 2 * prod + 20 * n, 2 * prod, 2 * tc1)


def phase_k1(L, dev):
    """K1 vs kron_group_apply_reference on the same CUDA tensors. Returns
    (max abs err, max rel err, K1 ms, plain ms, bound) for the kernel part
    of one apply at L (sum over the fused groups)."""
    from spindynamics_tpu_torch.ops import kron_group as kg

    m, lay, H, bv, args = _k1_inputs(L, dev)
    abs_err, rel_err = _k1_check(L, lay, args)

    def run(fn):
        def go():
            for (T, seed, _, srcs, srcsh, c) in args:
                fn(T, seed, srcs, srcsh, c)
        return go

    k_ms = event_ms(run(kg.kron_group_apply))
    p_ms = event_ms(run(kg.kron_group_apply_reference))
    k_ms2 = event_ms(run(kg.kron_group_apply))
    p_ms2 = event_ms(run(kg.kron_group_apply_reference))
    Hp = type(H)(lay, dtype=torch.float32, device=dev, fused=False)
    full_k = event_ms(lambda: H(bv))
    full_p = event_ms(lambda: Hp(bv))
    print(f"k1 L={L} splits={lay.splits}: {len(args)}/{len(lay.groups)} "
          f"groups fused | max|d|/max|y| {rel_err:.3e} (<= 1e-5), max|d| "
          f"{abs_err:.3e}, pads 0 | kernel part of one apply (median of 20, "
          f"plain/K1/K1/plain): plain {p_ms:.3f} ms, K1 {k_ms:.3f} ms, "
          f"K1 {k_ms2:.3f} ms, plain {p_ms2:.3f} ms | full apply: "
          f"KronHamiltonian(fused) {full_k:.3f} ms, plain blocks apply "
          f"{full_p:.3f} ms")
    bound, bound_fma, gb, gf, gtc = _bounds(
        [_group_work(c, seed is not None) for (_, seed, _, _, _, c) in args])
    print(f"k1 L={L}: kernel part moves {gb:.3f} GB and does {gf:.1f} GFLOP "
          f"of products ({gtc:.1f} of them per pass on the tensor cores, two "
          f"passes): bound {bound[0]:.3f} ms by {bound[1]} on the routes taken "
          f"(FMA route: {bound_fma[0]:.3f} ms by {bound_fma[1]})")
    return (abs_err, rel_err, min(k_ms, k_ms2), min(p_ms, p_ms2), bound,
            bound_fma)


def _k1_check(L, lay, args, tol=1e-5):
    """Every launch of `args` (_k1_inputs) with its seed and its axpy seed
    against the plain version on the same tensors: max|d|/max|y| <= tol,
    pad slots exactly 0, and a second launch on the same inputs identical
    in every byte. Returns (max|d|, max|d|/max|y|)."""
    from spindynamics_tpu_torch.ops import kron_group as kg

    abs_err = rel_err = 0.0
    for (T, seed, seed_ax, srcs, srcsh, c) in args:
        for sd in (seed, seed_ax):
            got = kg.kron_group_apply(T, sd, srcs, srcsh, c)
            again = kg.kron_group_apply(T, sd, srcs, srcsh, c)
            want = kg.kron_group_apply_reference(T, sd, srcs, srcsh, c)
            torch.cuda.synchronize()
            (_, _, _, ch, cm, cl, cmp, clp) = lay.groups[c.gi]
            if got[:, cm:, :].any() or got[:, :, cl:].any():
                raise RuntimeError(f"L={L} group {c.gi}: pad slots not 0")
            if not torch.equal(got, again):
                raise RuntimeError(f"L={L} group {c.gi}: two K1 launches on "
                                   "the same inputs differ")
            d = float((got - want).abs().max())
            abs_err = max(abs_err, d)
            rel_err = max(rel_err, d / max(float(want.abs().max()), 1e-30))
    if not rel_err <= tol:
        raise RuntimeError(f"L={L}: K1 vs plain rel err {rel_err:.3e} > "
                           f"{tol}")
    return abs_err, rel_err


def _call_as(call, exact=None, tile_rows=None):
    """A copy of a kernel call with its descriptor rebuilt: `exact=False`
    clears every exactness flag (the same group, tables and inputs with
    every segment on the float32 FMAs, the route a table that is not
    exactly bf16 takes), `tile_rows` fixes the output tile's height (32 or
    64; 0 is the kernel's rule)."""
    import copy

    c = copy.copy(call)
    if exact is False:
        c.exact = (False, False, (False,) * len(call.cross))
    if tile_rows is not None:
        c.tile_rows = tile_rows
    c._desc = c._desc_device = c.term_desc = None
    return c


def _fma_call(call):
    return _call_as(call, exact=False)


def phase_kron_tiles(L, dev):
    """(--kron-tiles) K1's and K2's time at L with 32- and 64-row output
    tiles against the kernel's rule (kron_tile.cuh tile_rows), on the main
    path's launches: every result identical in every byte to the rule's."""
    from spindynamics_tpu_torch.ops import cheb_term as ct
    from spindynamics_tpu_torch.ops import kron_group as kg
    from spindynamics_tpu_torch.ops.sector_kron import make_sector_kron_layout
    from spindynamics_tpu_torch.solvers import kron_evolve as ke

    _, lay, _, _, args = _k1_inputs(L, dev)
    me = _evolve_model(L)
    lay2 = make_sector_kron_layout(me, me.kron_splits)
    planes = ke.kron_planes_matvec_fn(lay2, device=dev)
    _, _, args2 = _k2_inputs(lay2, planes, dev, torch.float32, L)
    scal = (0.083, -0.41, 0.37, -0.62)
    rows = {}
    for bm in (0, 32, 64, 0):
        a1 = [(T, sd, srcs, srcsh, _call_as(c, tile_rows=bm))
              for (T, sd, _, srcs, srcsh, c) in args]
        a2 = [(*a[:6], _call_as(a[6], tile_rows=bm)) for a in args2]
        got = [kg.kron_group_apply(*a) for a in a1]
        if bm == 0 and "ref" not in rows:
            rows["ref"] = got
        elif not all(torch.equal(x, y) for x, y in zip(got, rows["ref"])):
            raise RuntimeError(f"K1 with {bm}-row tiles differs from the rule")
        del got
        k1 = event_ms(lambda: [kg.kron_group_apply(*a) for a in a1])
        k2 = event_ms(lambda: [ct.cheb_term_apply(*a, scal) for a in a2])
        rows.setdefault(bm, []).append((k1, k2))
    print(f"kron-tiles L={L}: K1 / K2 ms (median of 20) with 32-row tiles "
          f"{rows[32][0][0]:.3f} / {rows[32][0][1]:.3f}, 64-row "
          f"{rows[64][0][0]:.3f} / {rows[64][0][1]:.3f}, the rule "
          + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in rows[0])
          + " | K1 results identical in every byte")


def phase_k1_fma(L, dev):
    """K1's FMA route on the card. (a) The XXZ chain with Jxy = 0.3 at L,
    whose tables (W_lo, W_mid and the lo|mid factors) are not exactly bf16:
    every fused group against the plain version at K1's float32 limit, pads
    0, repeats identical. (b) The main model's K1 launches at L and the
    evolve model's K2 launches with every segment forced onto the FMAs
    (_fma_call), timed in turns with the tensor-core route on the same
    inputs, and held to it (1e-5 of max|y|). Returns {"xxz03": (max|d|,
    max rel), "k1": (fma ms, tc ms, FMA-route bound), "k2": (...)}."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import cheb_term as ct
    from spindynamics_tpu_torch.ops import kron_group as kg
    from spindynamics_tpu_torch.ops.sector_kron import make_sector_kron_layout
    from spindynamics_tpu_torch.solvers import kron_evolve as ke

    m = pt.xxz_chain(L, Jxy=0.3, Jz=0.5, nup=L // 2)
    _, lay, H, _, args = _k1_inputs(L, dev, model=m)
    n_fma = sum(not c.exact[0] for (*_, c) in args if c.W_lo is not None)
    if n_fma == 0:
        raise RuntimeError("Jxy=0.3: no W_lo segment took the FMA route")
    x_abs, x_rel = _k1_check(L, lay, args)
    x_ms = event_ms(lambda: [kg.kron_group_apply(T, sd, srcs, srcsh, c)
                              for (T, sd, _, srcs, srcsh, c) in args])
    del H, args

    # (b) K1: the main model, both routes on the same launches
    _, lay, _, _, args = _k1_inputs(L, dev)
    fargs = [(T, sd, srcs, srcsh, _fma_call(c))
             for (T, sd, _, srcs, srcsh, c) in args]
    rel = 0.0
    for (T, sd, srcs, srcsh, c), a in zip(fargs, args):
        y_f = kg.kron_group_apply(T, sd, srcs, srcsh, c)
        y_t = kg.kron_group_apply(T, sd, srcs, srcsh, a[5])
        rel = max(rel, float((y_f - y_t).abs().max())
                  / max(float(y_t.abs().max()), 1e-30))
    if not rel <= 1e-5:
        raise RuntimeError(f"K1 FMA route vs tensor cores: {rel:.3e} > 1e-5")

    def k1(fma):
        def go():
            for (T, sd, srcs, srcsh, c), a in zip(fargs, args):
                kg.kron_group_apply(T, sd, srcs, srcsh, c if fma else a[5])
        return go

    t1, f1, f1b, t1b = (event_ms(k1(x)) for x in (False, True, True, False))
    b1 = _bounds([_group_work(c, sd is not None)
                  for (_, sd, _, _, c) in fargs])[0]
    del args, fargs

    # K2: the evolve model, both routes on the same launches
    me = _evolve_model(L)
    lay = make_sector_kron_layout(me, me.kron_splits)
    planes = ke.kron_planes_matvec_fn(lay, device=dev)
    _, _, args2 = _k2_inputs(lay, planes, dev, torch.float32, L)
    scal = (0.083, -0.41, 0.37, -0.62)
    rel2 = 0.0
    for (T, pv, ac, seed, srcs, srcsh, call) in args2:
        a1 = tuple(x.clone() for x in ac)
        a2 = tuple(x.clone() for x in ac)
        y_f = ct.cheb_term_apply(T, pv, a1, seed, srcs, srcsh,
                                 _fma_call(call), scal)
        y_t = ct.cheb_term_apply(T, pv, a2, seed, srcs, srcsh, call, scal)
        for x, y in zip((*y_f, *a1), (*y_t, *a2)):
            rel2 = max(rel2, float((x - y).abs().max())
                       / max(float(y.abs().max()), 1e-30))
    if not rel2 <= 1e-5:
        raise RuntimeError(f"K2 FMA route vs tensor cores: {rel2:.3e} > 1e-5")
    fcalls = [_fma_call(a[6]) for a in args2]

    def k2(fma):
        def go():
            for a, fc in zip(args2, fcalls):
                ct.cheb_term_apply(*a[:6], fc if fma else a[6], scal)
        return go

    t2, f2, f2b, t2b = (event_ms(k2(x)) for x in (False, True, True, False))
    b2 = _bounds([_group_work(fc, a[3] is not None, planes=2)
                  for a, fc in zip(args2, fcalls)])[0]
    print(f"k1-fma L={L}: XXZ Jxy=0.3 ({n_fma} W_lo segments on the FMAs): "
          f"max|d|/max|y| {x_rel:.3e} (<= 1e-5), max|d| {x_abs:.3e}, pads 0, "
          f"launches repeat bit for bit, K1 part {x_ms:.3f} ms | the main "
          f"model's K1 launches, every segment forced onto the FMAs, against "
          f"the tensor-core route on the same inputs: max|d|/max|y| "
          f"{rel:.3e} (<= 1e-5); ms (median of 20, tc/fma/fma/tc) "
          f"{t1:.3f} / {f1:.3f} / {f1b:.3f} / {t1b:.3f}, FMA-route bound "
          f"{b1[0]:.3f} ms by {b1[1]} | the evolve model's K2 launches the "
          f"same way: max|d|/max|y| {rel2:.3e} (<= 1e-5); ms {t2:.3f} / "
          f"{f2:.3f} / {f2b:.3f} / {t2b:.3f}, FMA-route bound {b2[0]:.3f} ms "
          f"by {b2[1]}")
    return {"xxz03": (x_abs, x_rel), "k1": (min(f1, f1b), min(t1, t1b), b1),
            "k2": (min(f2, f2b), min(t2, t2b), b2)}


def _evolve_model(L):
    import spindynamics_tpu_torch as pt

    return pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2)


def phase_k2(L, dev):
    """K2 vs cheb_term_apply_reference on the same CUDA tensors, one term
    of the evolve model at L with main-path seeds. Returns (max abs err,
    max rel err, K2 ms, plain ms) for K2's part of one term (sum over the
    K2-fused groups), and its bound."""
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
        acc_r = tuple(x.clone() for x in ac)
        got = ct.cheb_term_apply(T, pv, acc_k, seed, srcs, srcsh, call, scal)
        again = ct.cheb_term_apply(T, pv, acc_r, seed, srcs, srcsh, call,
                                   scal)
        want = ct.cheb_term_apply_reference(T, pv, acc_p, seed, srcs, srcsh,
                                            call, scal)
        torch.cuda.synchronize()
        (_, _, _, ch, cm, cl, cmp, clp) = lay.groups[call.gi]
        for x in got:
            if x[:, cm:, :].any() or x[:, :, cl:].any():
                raise RuntimeError(f"L={L} group {call.gi}: pad slots not 0")
        if not all(torch.equal(x, y) for x, y in zip((*got, *acc_k),
                                                     (*again, *acc_r))):
            raise RuntimeError(f"L={L} group {call.gi}: two K2 launches on "
                               "the same inputs differ")
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

    k_ms = event_ms(run(ct.cheb_term_apply))
    p_ms = event_ms(run(ct.cheb_term_apply_reference))
    k_ms2 = event_ms(run(ct.cheb_term_apply))
    p_ms2 = event_ms(run(ct.cheb_term_apply_reference))
    bound, bound_fma, gb, gf, gtc = _bounds(
        [_group_work(a[6], a[3] is not None, planes=2) for a in args])
    del args
    a_inv, b = scal[:2]
    term_f = event_ms(lambda: ct.cheb_term_fused(
        lay, H.tables, H.calls, fused, prev, curr, acc, scal), reps=10)
    term_p = event_ms(lambda: ke._plain_term(
        planes, prev, curr, acc, scal[2:], (a_inv, b)), reps=10)
    print(f"k2 L={L} splits={lay.splits}: {len(fused)}/{len(lay.groups)} "
          f"groups fused | max|d|/max|y| {rel_err:.3e} (<= 1e-5), max|d| "
          f"{abs_err:.3e}, pads 0 | K2 part of one term (median of 20, "
          f"K2/plain/K2/plain): K2 {k_ms:.3f} ms, plain {p_ms:.3f} ms, K2 "
          f"{k_ms2:.3f} ms, plain {p_ms2:.3f} ms | whole term (median of "
          f"10): fused (seeds + K2 + tail) {term_f:.3f} ms, unfused (two "
          f"K1 applies + torch combine) {term_p:.3f} ms | K2 part moves "
          f"{gb:.3f} GB and does {gf:.1f} GFLOP of products ({gtc:.1f} per "
          f"pass on the tensor cores): bound {bound[0]:.3f} ms by {bound[1]} "
          f"(FMA route: {bound_fma[0]:.3f} ms by {bound_fma[1]}); launches "
          f"repeat bit for bit")
    return (abs_err, rel_err, min(k_ms, k_ms2), min(p_ms, p_ms2), bound,
            bound_fma)


def _lift(x):
    """float32 copies of a tensor, or of a (nested) list or tuple of
    tensors; None stays None."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.float()
    return type(x)(_lift(y) for y in x)


def phase_k1_bf16(L, dev):
    """K1's bfloat16 instance vs the plain version's float32 value before
    rounding, on the same CUDA tensors. Returns (max abs err, worst ratio
    to the one-rounding limit, K1 bf16 ms, plain ms, bound) for the kernel
    part of one apply at L."""
    from spindynamics_tpu_torch.ops import kron_group as kg

    bf16 = torch.bfloat16
    m, lay, H, bv, args = _k1_inputs(L, dev, bf16)
    abs_err = worst = 0.0
    n0 = kg.kernel_launch_count(bf16)
    for (T, seed, seed_ax, srcs, srcsh, c) in args:
        for sd in (seed, seed_ax):
            got = kg.kron_group_apply(T, sd, srcs, srcsh, c)
            if not torch.equal(got, kg.kron_group_apply(T, sd, srcs, srcsh,
                                                        c)):
                raise RuntimeError(f"L={L} group {c.gi}: two K1 bf16 "
                                   "launches on the same inputs differ")
            y32 = kg.kron_group_apply_reference(
                T.float(), _lift(sd), _lift(srcs), _lift(srcsh), c)
            torch.cuda.synchronize()
            (_, _, _, ch, cm, cl, cmp, clp) = lay.groups[c.gi]
            if got.dtype != bf16:
                raise RuntimeError(f"L={L} group {c.gi}: K1 bf16 returned "
                                   f"{got.dtype}")
            if got[:, cm:, :].any() or got[:, :, cl:].any():
                raise RuntimeError(f"L={L} group {c.gi}: pad slots not 0")
            d, r = err_ratio(got, y32, rounded=True)
            abs_err, worst = max(abs_err, d), max(worst, r)
            del got, y32
    if kg.kernel_launch_count(bf16) - n0 != 4 * len(args):
        raise RuntimeError("K1's bf16 launches were not counted as bf16")
    if not worst <= 1.0:
        raise RuntimeError(f"L={L}: K1 bf16 is {worst:.2f}x its one-rounding "
                           f"limit off the plain float32 value")
    _, _, H32, bv32, args32 = _k1_inputs(L, dev, torch.float32)

    def run(fn, a):
        def go():
            for (T, seed, _, srcs, srcsh, c) in a:
                fn(T, seed, srcs, srcsh, c)
        return go

    kb = event_ms(run(kg.kron_group_apply, args))
    k32 = event_ms(run(kg.kron_group_apply, args32))
    pb = event_ms(run(kg.kron_group_apply_reference, args), reps=10)
    kb2 = event_ms(run(kg.kron_group_apply, args))
    k322 = event_ms(run(kg.kron_group_apply, args32))
    full_b = event_ms(lambda: H(bv))
    full_32 = event_ms(lambda: H32(bv32))
    bound, bound_fma, gb, gf, gtc = _bounds(
        [_group_work(c, seed is not None, state_bytes=2)
         for (_, seed, _, _, _, c) in args])
    print(f"k1-bf16 L={L}: {len(args)}/{len(lay.groups)} groups | worst "
          f"|d| / (2^-8 |y| + 1e-5 max|y|) {worst:.3f} (<= 1) against the "
          f"plain float32 value, max|d| {abs_err:.3e}, pads 0 | kernel part "
          f"of one apply (median of 20, bf16/f32/plain/bf16/f32): K1 bf16 "
          f"{kb:.3f} ms, K1 f32 {k32:.3f} ms, plain bf16 {pb:.3f} ms, K1 "
          f"bf16 {kb2:.3f} ms, K1 f32 {k322:.3f} ms | full apply: bf16 "
          f"{full_b:.3f} ms, f32 {full_32:.3f} ms | moves {gb:.3f} GB and "
          f"does {gf:.1f} GFLOP of products ({gtc:.1f} on the tensor cores, "
          f"one pass): bound {bound[0]:.3f} ms by {bound[1]} (FMA route: "
          f"{bound_fma[0]:.3f} ms by {bound_fma[1]}); launches repeat bit for "
          f"bit")
    return abs_err, worst, min(kb, kb2), pb, bound, bound_fma


def _k2_inputs(lay, planes, dev, sdt, seed):
    """(prev, curr, acc) random pairs, prev and curr in `sdt`, acc float32,
    and K2's main-path launch arguments for them."""
    from spindynamics_tpu_torch.ops import cheb_term as ct
    from spindynamics_tpu_torch.ops import kron_group as kg
    from spindynamics_tpu_torch.solvers.blockvec import bv_random

    g = torch.Generator(device=dev).manual_seed(seed)
    prev, curr, acc = ((bv_random(lay, g, dt, dev), bv_random(lay, g, dt, dev))
                       for dt in (sdt, sdt, torch.float32))
    fused = kg.fused_group_set(lay, planes.cheb_top_k)
    H = planes.H
    args = [a for _, a in ct.term_launches(lay, H.tables, H.calls, fused,
                                           prev, curr, acc)]
    return (prev, curr, acc), fused, args


def phase_k2_bf16(L, dev):
    """K2's bfloat16 instance vs the plain version on the lifted inputs:
    next against the float32 x before rounding, the float32 accumulator at
    K2's float32 tolerance. Returns (max abs err of next, worst ratio, K2
    bf16 ms, plain ms, bound) for K2's part of one term at L."""
    from spindynamics_tpu_torch.ops import cheb_term as ct
    from spindynamics_tpu_torch.ops.sector_kron import make_sector_kron_layout
    from spindynamics_tpu_torch.solvers import kron_evolve as ke

    bf16 = torch.bfloat16
    m = _evolve_model(L)
    lay = make_sector_kron_layout(m, m.kron_splits)
    planes = ke.kron_planes_matvec_fn(lay, device=dev)
    H = planes.H
    pairs, fused, args = _k2_inputs(lay, planes, dev, bf16, L)
    scal = (0.083, -0.41, 0.37, -0.62)  # 1/a, b, c_r, c_i
    abs_err = worst = acc_rel = 0.0
    n0 = ct.kernel_launch_count(bf16)
    for (T, pv, ac, seed, srcs, srcsh, call) in args:
        acc_k = tuple(x.clone() for x in ac)
        acc_p = tuple(x.clone() for x in ac)
        acc_r = tuple(x.clone() for x in ac)
        got = ct.cheb_term_apply(T, pv, acc_k, seed, srcs, srcsh, call, scal)
        again = ct.cheb_term_apply(T, pv, acc_r, seed, srcs, srcsh, call,
                                   scal)
        if not all(torch.equal(x, y) for x, y in zip((*got, *acc_k),
                                                     (*again, *acc_r))):
            raise RuntimeError(f"L={L} group {call.gi}: two K2 bf16 launches "
                               "on the same inputs differ")
        x32 = ct.cheb_term_apply_reference(
            _lift(T), _lift(pv), acc_p, _lift(seed), _lift(srcs),
            _lift(srcsh), call, scal)
        torch.cuda.synchronize()
        (_, _, _, ch, cm, cl, cmp, clp) = lay.groups[call.gi]
        for x, y in zip(got, x32):
            if x.dtype != bf16:
                raise RuntimeError(f"L={L} group {call.gi}: K2 bf16 stored "
                                   f"next as {x.dtype}")
            if x[:, cm:, :].any() or x[:, :, cl:].any():
                raise RuntimeError(f"L={L} group {call.gi}: pad slots not 0")
            d, r = err_ratio(x, y, rounded=True)
            abs_err, worst = max(abs_err, d), max(worst, r)
        for x, y in zip(acc_k, acc_p):
            acc_rel = max(acc_rel, float((x - y).abs().max())
                          / max(float(y.abs().max()), 1e-30))
        del got, again, x32, acc_k, acc_p, acc_r
    if ct.kernel_launch_count(bf16) - n0 != 2 * len(args):
        raise RuntimeError("K2's bf16 launches were not counted as bf16")
    if not worst <= 1.0:
        raise RuntimeError(f"L={L}: K2 bf16 next is {worst:.2f}x its "
                           f"one-rounding limit off the plain float32 x")
    if not acc_rel <= 1e-5:
        raise RuntimeError(f"L={L}: K2 bf16 acc rel err {acc_rel:.3e} > 1e-5")
    pairs32, _, args32 = _k2_inputs(lay, planes, dev, torch.float32, L)

    def run(fn, a):
        def go():
            for x in a:
                fn(*x, scal)
        return go

    kb = event_ms(run(ct.cheb_term_apply, args))
    k32 = event_ms(run(ct.cheb_term_apply, args32))
    pb = event_ms(run(ct.cheb_term_apply_reference, args), reps=10)
    kb2 = event_ms(run(ct.cheb_term_apply, args))
    k322 = event_ms(run(ct.cheb_term_apply, args32))
    bound, bound_fma, gb, gf, gtc = _bounds(
        [_group_work(a[6], a[3] is not None, planes=2, state_bytes=2)
         for a in args])
    del args, args32
    term_b = event_ms(lambda: ct.cheb_term_fused(
        lay, H.tables, H.calls, fused, *pairs, scal), reps=10)
    term_32 = event_ms(lambda: ct.cheb_term_fused(
        lay, H.tables, H.calls, fused, *pairs32, scal), reps=10)
    print(f"k2-bf16 L={L}: {len(fused)}/{len(lay.groups)} groups | next: "
          f"worst |d| / (2^-8 |x| + 1e-5 max|x|) {worst:.3f} (<= 1) against "
          f"the plain float32 x, max|d| {abs_err:.3e}; acc (float32, from "
          f"the unrounded x) max|d|/max|y| {acc_rel:.3e} (<= 1e-5); pads 0 "
          f"| K2 part of one term (median of 20, bf16/f32/plain/bf16/f32): "
          f"K2 bf16 {kb:.3f} ms, K2 f32 {k32:.3f} ms, plain bf16 {pb:.3f} "
          f"ms, K2 bf16 {kb2:.3f} ms, K2 f32 {k322:.3f} ms | whole term "
          f"(median of 10): bf16 {term_b:.3f} ms, f32 {term_32:.3f} ms | "
          f"moves {gb:.3f} GB and does {gf:.1f} GFLOP of products ({gtc:.1f} "
          f"on the tensor cores, one pass): bound {bound[0]:.3f} ms by "
          f"{bound[1]} (FMA route: {bound_fma[0]:.3f} ms by {bound_fma[1]}); "
          f"launches repeat bit for bit")
    return abs_err, worst, min(kb, kb2), pb, bound, bound_fma


def phase_evolve_oracle(dev, sdt=torch.float32):
    """L=12 domain-wall trajectory on the card through K2 against exact
    evolution in float64: within 1e-4 for float32 states, within 2e-2 (the
    accuracy class of one rounding per stored term) for bfloat16 states."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import cheb_term as ct

    tag, tol = (("evolve-oracle", 1e-4) if sdt == torch.float32
                else ("evolve-bf16 oracle", 2e-2))
    m = _evolve_model(12)
    bits = pt.domain_wall_bitstring(m)
    n0 = ct.kernel_launch_count(sdt)
    _, obs, info = pt.evolve_trajectory_kron(m, bits, dt=0.1, n_steps=5,
                                             cheb_n=40, device=dev,
                                             state_dtype=sdt)
    n_k2 = ct.kernel_launch_count(sdt) - n0
    ref = exact_sz_trajectory(m, bits, 0.1, 5)
    err = float(np.abs(obs - ref).max())
    print(f"{tag} L=12: max |d<Sz_i>| over 5 steps {err:.2e} "
          f"(<= {tol:g}) against exact evolution (924 states, scipy eigh) | "
          f"norm drift {info['norm_drift']:.2e} | K2 launches {n_k2}")
    if not err <= tol:
        raise RuntimeError(f"L=12 trajectory off exact evolution by {err}")
    if not n_k2 > 0:
        raise RuntimeError("the L=12 trajectory launched K2 no time")


def phase_evolve(L, dev):
    """The evolve path at L: evolve_trajectory_kron from the domain wall,
    bounds from its 40-step Lanczos. Returns (K2 launches, the run's info
    with its observables, launch counts and peak memory added, for the
    profile and the bfloat16 run beside it)."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import cheb_term as ct
    from spindynamics_tpu_torch.ops import dot2 as d2
    from spindynamics_tpu_torch.ops import kron_group as kg

    m = _evolve_model(L)
    bits = pt.domain_wall_bitstring(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kg.reset_kernel_launch_count()
    ct.reset_kernel_launch_count()
    d2.reset_dot2_launch_count()
    (pair, obs, info), t_all = sync_time(lambda: pt.evolve_trajectory_kron(
        m, bits, dt=0.1, n_steps=5, cheb_n=40, device=dev))
    n_k1, n_k2 = kg.kernel_launch_count(), ct.kernel_launch_count()
    n_dot2 = d2.dot2_launch_count()
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
          f"{n_k1}, K2 launches {n_k2}, dot2 launches {n_dot2} | norms "
          f"{[f'{x:.7f}' for x in norms]} | max |sum_i <Sz_i>| "
          f"{float(np.abs(tot).max()):.2e}")
    print(f"evolve L={L}: <Sz_i> after step 1 {obs[0]}")
    print(f"evolve L={L}: <Sz_i> after step 5 {obs[-1]}")
    if not (n_k1 > 0 and n_k2 > 0 and n_dot2 > 0):
        raise RuntimeError(f"the evolve path launched K1 {n_k1}, K2 {n_k2} "
                           f"and dot2 {n_dot2} times: all must run")
    if not (np.all(np.isfinite(obs)) and np.all(np.isfinite(norms))
            and np.all(np.isfinite(info["Ebounds"]))):
        raise RuntimeError("non-finite trajectory")
    if not np.all(np.abs(norms - 1.0) <= 1e-4):
        raise RuntimeError(f"norms off 1 by more than 1e-4: {norms}")
    if not np.all(np.abs(tot) <= 1e-5):
        raise RuntimeError(f"sum_i <Sz_i> not conserved: {tot}")
    if not (obs[0][0] > 0.49 and obs[0][L - 1] < -0.49):
        raise RuntimeError("the chain's ends moved in the first step")
    info = dict(info, obs=obs, launches=(n_k1, n_k2), peak=peak)
    return n_k2, info


def phase_evolve_bf16(L, dev, ref):
    """The same trajectory with bfloat16 states, from the float32 run's
    bounds (`ref`: phase_evolve's info). Returns the (K1, K2) launch counts
    of the bfloat16 instances."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import cheb_term as ct
    from spindynamics_tpu_torch.ops import kron_group as kg
    from spindynamics_tpu_torch.ops.sector_kron import (
        default_fused_topk, make_sector_kron_layout)

    bf16 = torch.bfloat16
    m = _evolve_model(L)
    bits = pt.domain_wall_bitstring(m)
    # the float32 run's K1 count holds its 40-step bounds Lanczos as well
    lay = make_sector_kron_layout(m, m.kron_splits)
    n_bounds = 40 * len(kg.fused_group_set(lay, default_fused_topk(lay)))
    want = (ref["launches"][0] - n_bounds, ref["launches"][1])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kg.reset_kernel_launch_count()
    ct.reset_kernel_launch_count()
    (pair, obs, info), t_all = sync_time(lambda: pt.evolve_trajectory_kron(
        m, bits, dt=0.1, n_steps=5, cheb_n=40, Ebounds=ref["Ebounds"],
        state_dtype=bf16, device=dev))
    n_k1, n_k2 = kg.kernel_launch_count(bf16), ct.kernel_launch_count(bf16)
    n_f32 = (kg.kernel_launch_count(torch.float32)
             + ct.kernel_launch_count(torch.float32))
    peak = torch.cuda.max_memory_allocated()
    leaves_bf16 = all(x.dtype == bf16 for P in pair for x in P.leaves)
    del pair
    steps, steps32 = info["step_seconds"], ref["step_seconds"]
    norms = info["norms"]
    tot = obs.sum(axis=1)
    dS = float(np.abs(obs - ref["obs"]).max())
    print(f"evolve-bf16 L={L}: max |d<Sz_i>| against the float32 run over 5 "
          f"steps {dS:.2e} (<= 2e-2) | norm drift {info['norm_drift']:.2e} "
          f"(< 5e-2), norms {[f'{x:.5f}' for x in norms]} | max |sum_i "
          f"<Sz_i>| {float(np.abs(tot).max()):.2e} (<= 1e-2) | seconds per "
          f"step median {float(np.median(steps)):.3f} (steps "
          f"{[round(x, 3) for x in steps]}) beside float32 "
          f"{float(np.median(steps32)):.3f} | all {t_all:.2f} s | peak "
          f"{peak / 2**30:.2f} GiB beside float32 "
          f"{ref['peak'] / 2**30:.2f} GiB | bf16 launches K1 {n_k1}, K2 "
          f"{n_k2} (float32 run without its {n_bounds} bounds launches: "
          f"{want[0]}, {want[1]}), float32 launches {n_f32}")
    print(f"evolve-bf16 L={L}: <Sz_i> after step 5 {obs[-1]}")
    if not leaves_bf16:
        raise RuntimeError("the bf16 trajectory returned other leaves")
    if not (np.all(np.isfinite(obs)) and np.all(np.isfinite(norms))):
        raise RuntimeError("non-finite bf16 trajectory")
    if not dS <= 2e-2:
        raise RuntimeError(f"bf16 <Sz_i> off the float32 run by {dS}")
    if not info["norm_drift"] < 5e-2:
        raise RuntimeError(f"bf16 norm drift {info['norm_drift']}")
    if not np.all(np.abs(tot) <= 1e-2):
        raise RuntimeError(f"bf16 sum_i <Sz_i> not conserved: {tot}")
    if not (n_k1 > 0 and n_k2 > 0 and n_f32 == 0):
        raise RuntimeError(f"the bf16 run launched K1 {n_k1} and K2 {n_k2} "
                           f"times in bf16 and {n_f32} kernels in float32")
    if (n_k1, n_k2) != want:
        raise RuntimeError(f"bf16 launch counts ({n_k1}, {n_k2}) differ "
                           f"from the float32 run's {want}")
    return n_k1, n_k2


def phase_kron_sqw(L, dev, psi, E0, info):
    """lanczos_sqw_kron at L from the main path's ground state: 3 q-points
    x 60 pair steps, every apply through K1. Returns K1's launch count."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import kron_group as kg

    m = pt.heisenberg_chain(L, nup=L // 2)
    qs = [2 * np.pi * k / L for k in (4, 7, L // 2)]
    omega = np.linspace(0.0, 4.0, 200)
    lanc_m = 60
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kg.reset_kernel_launch_count()
    (S, sinfo), t = sync_time(lambda: pt.lanczos_sqw_kron(
        m, qs, omega, lanc_m=lanc_m, eta=0.1, psi0=psi, E0=E0, info=info,
        device=dev))
    launches = kg.kernel_launch_count(torch.float32)
    peak = torch.cuda.max_memory_allocated()
    smax = float(np.abs(S).max())
    print(f"kron-sqw L={L}: lanczos_sqw_kron 3 q x {lanc_m} pair steps "
          f"(plane_mode {sinfo['plane_mode']}) {t:.2f} s, "
          f"{t / (len(qs) * lanc_m) * 1e3:.2f} ms per pair step | peak "
          f"{peak / 2**30:.2f} GiB | K1 launches {launches} | S shape "
          f"{S.shape}, max {smax:.4f}, peak omega per q "
          f"{[float(omega[i]) for i in S.argmax(axis=1)]}")
    if not launches > 0:
        raise RuntimeError("lanczos_sqw_kron launched K1 no time")
    if not (S.shape == (len(qs), omega.shape[0]) and np.all(np.isfinite(S))
            and smax > 0 and S.min() >= -1e-6 * smax
            and np.all(S.max(axis=1) > 0)):
        raise RuntimeError("kron S(q, omega) not finite, positive rows")
    return launches


def phase_kron_obs(L, dev, psi, E0, info):
    """The correlation observables of the main path's ground state at L:
    szsz_matrix_kron (diagonal 1/4 to 1e-5, rows sum to 0 to 1e-4 in the
    Sz=0 sector), S(q) >= 0, and kpm_correlation_matrix_kron for the middle
    site as B, 100 moments."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import kron_group as kg
    from spindynamics_tpu_torch.ops.sector_kron import make_sector_kron_layout

    m = pt.heisenberg_chain(L, nup=L // 2)
    lay = make_sector_kron_layout(m, m.kron_splits)
    (szsz, si), t_zz = sync_time(lambda: pt.szsz_matrix_kron(psi, lay))
    (q, Sq), t_sq = sync_time(lambda: pt.structure_factor_Sq_kron(psi, lay))
    diag = float((torch.diagonal(szsz) - 0.25).abs().max())
    rows = float(szsz.sum(dim=1).abs().max())
    sym = float((szsz - szsz.T).abs().max())
    nn = float(torch.diagonal(szsz, 1).mean())
    omega = np.linspace(-2.0, 6.0, 200)
    kg.reset_kernel_launch_count()
    (C, cinfo), t_c = sync_time(lambda: pt.kpm_correlation_matrix_kron(
        m, omega, n=100, psi0=psi, E0=E0, info=info, sites=(L // 2,),
        device=dev))
    launches = kg.kernel_launch_count(torch.float32)
    np.set_printoptions(precision=4, suppress=True, linewidth=250)
    print(f"kron-obs L={L}: szsz_matrix_kron {t_zz:.3f} s, max |diag - 1/4| "
          f"{diag:.2e} (<= 1e-5), max |row sum| {rows:.2e} (<= 1e-4), "
          f"asymmetry {sym:.1e}, mean <Sz_i Sz_i+1> {nn:.5f}, max |<Sz_i>| "
          f"{float(si.abs().max()):.2e} | structure_factor_Sq_kron "
          f"{t_sq:.3f} s, min {Sq.min():.2e}, S(pi) {Sq[L // 2]:.4f} | "
          f"kpm_correlation_matrix_kron (B = site {L // 2}, 100 moments + 40 "
          f"bounds steps) {t_c:.2f} s, C shape {C.shape}, max {C.max():.4f} "
          f"at A = site {int(C.max(axis=(1, 2)).argmax())}, K1 launches "
          f"{launches}")
    print(f"kron-obs L={L}: S(q) {Sq}")
    if not (diag <= 1e-5 and rows <= 1e-4 and sym <= 1e-6):
        raise RuntimeError("szsz matrix: diagonal, row sums or symmetry off")
    if not (np.all(np.isfinite(Sq)) and Sq.min() >= -1e-5):
        raise RuntimeError(f"S(q) negative or not finite: {Sq}")
    if not (C.shape == (L, 1, omega.shape[0]) and np.all(np.isfinite(C))
            and C.max() > 0 and launches > 0):
        raise RuntimeError("kpm_correlation_matrix_kron: not finite, zero "
                           "or without K1")
    # the on-site column carries the largest weight
    if int(C.max(axis=(1, 2)).argmax()) != L // 2:
        raise RuntimeError("the on-site correlation is not the largest")


def kron_to_flat(psi, lay, dev):
    """The flat vector of 2^L amplitudes (bit i = site i) of a kron
    BlockVec: kron_order_states names the basis state of every slot of the
    kron-order vector (tile pads excepted)."""
    from spindynamics_tpu_torch.ops import sector_kron as sk

    states = sk.kron_order_states(lay.L, lay.nup, lay.splits, lay.pads)
    real = torch.as_tensor(states != sk.PAD_SENTINEL, device=dev)
    idx = torch.as_tensor(states.astype(np.int64), device=dev)
    out = torch.zeros(1 << lay.L, dtype=psi.dtype, device=dev)
    out[idx[real]] = sk.blocks_to_flat(psi.leaves, lay)[real]
    return out


def phase_typicality(dev):
    import spindynamics_tpu_torch as pt

    L = 20
    m = _evolve_model(L)
    ts = (0.0, 0.5, 1.0)
    (G, dt) = sync_time(lambda: pt.typicality_correlation_kron(
        m, 1.0, L // 2, L // 2, ts, device=dev))
    print(f"typicality L={L} beta=1 sites ({L // 2}, {L // 2}): "
          f"{[complex(round(z.real, 6), round(z.imag, 6)) for z in G]} at t "
          f"{ts} | {dt:.2f} s")
    if not np.all(np.isfinite(G)):
        raise RuntimeError("non-finite typicality correlation")
    if not (abs(G[0].real - 0.25) <= 1e-3 and abs(G[0].imag) <= 1e-3):
        raise RuntimeError(f"<Sz^2> at t=0 is {G[0]}, not 0.25")


# ---------------------------------------------------------------------------
# the flat-state path (embedded layout, K3)
# ---------------------------------------------------------------------------


def _flat_model(L, kind="chain"):
    """Embedded Sz=0 models of the flat path: the XXZ chain (Jxy=1, Jz=0.5,
    a non-uniform field when `kind` is "chain-field") or an all-pairs
    model."""
    import spindynamics_tpu_torch as pt

    if kind == "longrange":
        return pt.build_model(
            L, nup=L // 2, layout="embedded",
            hopping=pt.long_range_hopping(L, lambda i, j: 1.0 / (j - i)),
            zz=pt.long_range_hopping(L, lambda i, j: 0.3 / (j - i) ** 2),
            onsite_field=np.linspace(-0.2, 0.3, L))
    h = np.linspace(-0.2, 0.3, L) if kind == "chain-field" else None
    return pt.xxz_chain(L, Jxy=1.0, Jz=0.5, h=h, nup=L // 2,
                        layout="embedded")


def _flat_state(m, dev, cplx, seed, dtype=torch.float32):
    """A random state in the model's sector (zero outside it where the
    model has a mask)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m.n_states, generator=g, device=dev, dtype=dtype)
    if cplx:
        x = torch.complex(x, torch.randn(m.n_states, generator=g, device=dev,
                                         dtype=dtype))
    mask = m.valid_mask(dev)
    return x if mask is None else torch.where(mask, x, torch.zeros_like(x))


def csr_hamiltonian(model, dev):
    """H of a full or embedded model as a torch sparse CSR tensor on `dev`
    (int32 indices, float32 values), built row by row on the device: the
    diagonal first, then one entry per hopping bond whose two bits differ.
    The library yardstick of K3: it is timed, never used by the port."""
    N = model.n_states
    s = torch.arange(N, device=dev, dtype=torch.int32)
    bonds = [(int(i), int(j), float(J)) for i, j, J in
             zip(model.hop_i, model.hop_j, model.hop_J)]
    cnt = torch.ones(N, device=dev, dtype=torch.int32)
    for i, j, _ in bonds:
        cnt += ((s >> i) ^ (s >> j)) & 1
    crow = torch.zeros(N + 1, device=dev, dtype=torch.int32)
    crow[1:] = torch.cumsum(cnt, 0, dtype=torch.int32)
    nnz = int(crow[-1])
    col = torch.empty(nnz, device=dev, dtype=torch.int32)
    val = torch.empty(nnz, device=dev, dtype=torch.float32)
    pos = crow[:-1].to(torch.int64)
    col[pos] = s
    val[pos] = model.diag(dev, torch.float32)
    pos = pos + 1
    for i, j, J in bonds:
        on = (((s >> i) ^ (s >> j)) & 1).bool()
        p = pos[on]
        col[p] = s[on] ^ ((1 << i) | (1 << j))
        val[p] = J
        pos = pos + on
    return torch.sparse_csr_tensor(crow, col, val, size=(N, N),
                                   check_invariants=False)


def _k3_call(m, dev, tile_bits=None, cplx=False):
    """K3's plan for `m` and a float32 (complex64) state with its tables on
    `dev`, held for many applies (the wrapper alone builds both anew for
    every apply)."""
    from spindynamics_tpu_torch.ops import fused_matvec as fm

    return fm.FusedCall(fm.make_fused_plan(m, tile_bits, is_complex=cplx),
                        device=dev)


def _time_csr(L, dev):
    """(CSR ms, K3 ms, nnz) of one H @ psi for the chain-field model at L,
    real float32, with the two results compared."""
    from spindynamics_tpu_torch.ops import fused_matvec as fm

    m = _flat_model(L, "chain-field")
    x = _flat_state(m, dev, False, seed=L)
    H = csr_hamiltonian(m, dev)
    call = _k3_call(m, dev)
    y = H @ x
    want = fm.fused_matvec_apply(x, m, call)
    err = float((y - want).abs().max()) / float(want.abs().max())
    if not err <= 1e-6:
        raise RuntimeError(f"L={L}: CSR product off K3 by {err:.3e}")
    c_ms = event_ms(lambda: H @ x, reps=10)
    k_ms = event_ms(lambda: fm.fused_matvec_apply(x, m, call), reps=10)
    nnz = H.values().shape[0]
    del H
    torch.cuda.empty_cache()
    return c_ms, k_ms, nnz


def _k3_check(m, dev, cplx, seed, what):
    """One K3 comparison: (max abs err, max rel err) against the plain
    version on the same CUDA tensor, exact zeros outside the sector,
    bit-identical repeats."""
    from spindynamics_tpu_torch.ops import fused_matvec as fm

    x = _flat_state(m, dev, cplx, seed)
    call = _k3_call(m, dev, cplx=cplx)
    got = fm.fused_matvec_apply(x, m, call)
    torch.cuda.synchronize()
    want = fm.fused_matvec_apply_reference(x, m)
    d = float((got - want).abs().max())
    rel = d / max(float(want.abs().max()), 1e-30)
    if not rel <= 1e-6:
        raise RuntimeError(f"{what}: K3 vs plain rel err {rel:.3e} > 1e-6")
    if torch.view_as_real(got)[~m.valid_mask(dev)].any() if cplx else (
            got[~m.valid_mask(dev)].any()):
        raise RuntimeError(f"{what}: weight outside the sector")
    if not torch.equal(got, fm.fused_matvec_apply(x, m, call)):
        raise RuntimeError(f"{what}: two applies of one input differ")
    # the wrapper alone (plan and tables built for the one apply) agrees
    if not torch.equal(got, fm.fused_matvec_apply(x, m)):
        raise RuntimeError(f"{what}: the wrapper without a held call differs")
    return d, rel, x


def phase_k3(L, dev):
    """K3 vs fused_matvec_apply_reference on the same CUDA tensors. Returns
    the kernel record's numbers at L: real and complex times, bounds, the
    copy time and the CSR yardstick."""
    from spindynamics_tpu_torch.ops import fused_matvec as fm

    for kind in ("chain-field", "longrange"):
        m = _flat_model(16, kind)
        errs = [_k3_check(m, dev, c, 16, f"L=16 {kind}")[1]
                for c in (False, True)]
        plan = fm.make_fused_plan(m)
        print(f"k3 L=16 {kind}: bonds local/straddle/tile "
              f"{plan.n_local}/{plan.n_strad}/{plan.n_tile} | max|d|/max|y| "
              f"real {errs[0]:.3e} complex {errs[1]:.3e} (<= 1e-6), exact 0 "
              f"outside the sector, repeats bit-identical")
    m = _flat_model(L, "chain-field")
    N = m.n_states
    out = {}
    for cplx in (False, True):
        call = _k3_call(m, dev, cplx=cplx)
        plan = call.plan
        passes = fm.fused_pass_count(plan)
        d, rel, x = _k3_check(m, dev, cplx, L, f"L={L}")
        # the plain version is timed with its N-sized diagonal held, as a
        # blocked FlatHamiltonian holds it
        dg = m.diag(dev, torch.float32)
        k_ms = event_ms(lambda: fm.fused_matvec_apply(x, m, call), reps=10)
        p_ms = event_ms(
            lambda: fm.fused_matvec_apply_reference(x, m, dg), reps=3, warm=1)
        del dg
        k_ms2 = event_ms(lambda: fm.fused_matvec_apply(x, m, call), reps=10)
        y = torch.empty_like(x)
        c_ms = event_ms(lambda: y.copy_(x), reps=10)
        comps = 2 if cplx else 1
        state_bytes = N * 4 * comps
        # every bond is active on half of the states: 2 flops per component
        bound = _bound(2 * state_bytes, 2 * comps * N * (1 + m.n_bonds / 2))
        copy_bw = 2 * state_bytes / (c_ms * 1e-3)
        ms = min(k_ms, k_ms2)
        tag = "complex" if cplx else "real"
        out[tag] = dict(abs_err=d, rel_err=rel, ms=ms, plain_ms=p_ms,
                        copy_ms=c_ms, bound=bound, passes=passes,
                        tile_bits=plan.tile_bits)
        print(f"k3 L={L} {tag}: tile 2^{plan.tile_bits} (chunks "
              f"2^{plan.chunk_bits}), bonds local/straddle/tile "
              f"{plan.n_local}/{plan.n_strad}/{plan.n_tile}, {passes:.1f} "
              f"designed passes | max|d|/max|y| {rel:.3e} (<= 1e-6), max|d| "
              f"{d:.3e}, exact 0 outside the sector, repeats bit-identical | "
              f"median of 10, K3/plain/K3: K3 {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms, K3 {k_ms2:.3f} ms | N-sized copy {c_ms:.3f} "
              f"ms ({copy_bw / 1e12:.2f} TB/s) | K3 / copy {ms / c_ms:.2f} | "
              f"achieved {2 * state_bytes / ms * 1e-9:.2f} TB/s over the "
              f"bound's two passes, {passes * state_bytes / ms * 1e-9:.2f} "
              f"TB/s over the designed passes | bound {bound[0]:.3f} ms by "
              f"{bound[1]} (data sheet), {2 * state_bytes / copy_bw * 1e3:.3f}"
              f" ms at the copy's rate")
        del x, y
    torch.cuda.empty_cache()
    c22, k22, nnz = _time_csr(22, dev)
    print(f"k3 L=22: torch sparse CSR H @ psi ({nnz} non-zeros) "
          f"{c22:.3f} ms against K3 {k22:.3f} ms")
    # the record's library time is one on the record's own inputs, or
    # none: at L=28 the matrix has 3.9e9 non-zeros, more than the int32
    # indices of csr_hamiltonian address, and 47 GB of them in int64
    out["library_ms"] = None
    if L <= 26:
        out["library_ms"], kL, nnz = _time_csr(L, dev)
        print(f"k3 L={L}: torch sparse CSR H @ psi ({nnz} non-zeros) "
              f"{out['library_ms']:.3f} ms against K3 {kL:.3f} ms")
    else:
        print(f"k3 L={L}: no library time (the CSR matrix is not built "
              f"above L=26: {N * (1 + m.n_bonds / 2):.2e} non-zeros)")
    return out


def phase_k3_tiles(L, dev):
    """(--k3-tiles) K3's time at L for every tile size 2^8..2^15 float32
    and 2^8..2^14 complex64 (128 KB), each checked against the default
    tile's result."""
    from spindynamics_tpu_torch.ops import fused_matvec as fm

    m = _flat_model(L, "chain-field")
    for cplx in (False, True):
        x = _flat_state(m, dev, cplx, seed=L)
        want = fm.fused_matvec_apply(x, m)
        scale = float(want.abs().max())
        rows = []
        for k in range(8, fm.tile_bits_range(cplx)[1] + 1):
            call = _k3_call(m, dev, k, cplx)
            plan = call.plan
            got = fm.fused_matvec_apply(x, m, call)
            rel = float((got - want).abs().max()) / scale
            if not rel <= 1e-6:
                raise RuntimeError(f"tile 2^{k}: off the default tile's "
                                   f"result by {rel:.3e}")
            ms = event_ms(lambda: fm.fused_matvec_apply(x, m, call), reps=10)
            rows.append(f"2^{k}: {ms:.3f} ms "
                        f"({fm.fused_pass_count(plan):.1f} passes)")
        print(f"k3-tiles L={L} {'complex' if cplx else 'real'}: "
              + " | ".join(rows))


def k3_turns(root, L):
    """(--k3-against ROOT) The k3 phase at L of the checkout at ROOT and
    of this one, in turns (ROOT, this, this, ROOT), each in a process of
    its own that imports that checkout's chip_smoke and package: two
    versions of K3 compared on one card in one call."""
    here = str(Path(__file__).resolve().parent)
    there = str(Path(root).resolve())
    code = ("import sys, torch; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke as cs; cs.phase_device(); cs.phase_build(); "
            "cs.phase_k3(int(sys.argv[2]), torch.device('cuda'))")
    for r in (there, here, here, there):
        print(f"k3-turns: {r}", flush=True)
        subprocess.run([sys.executable, "-c", code, r, str(L)], cwd=r,
                       check=True)


def phase_profile_flat(L, dev):
    """(--profile) Kernel-time tables of three flat Lanczos steps (real
    float32 state, compensated dots) and of a four-term Chebyshev step
    (complex64 state), both through K3."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.solvers.chebyshev import chebyshev_time_evolve
    from spindynamics_tpu_torch.solvers.lanczos import lanczos_iteration
    from torch.profiler import ProfilerActivity, profile

    m = _flat_model(L)
    mv = pt.matvec_fn(m)
    x = _flat_state(m, dev, False, seed=1)
    z = pt.domain_wall_state(m, dtype=torch.complex64, device=dev)
    runs = (("three Lanczos steps, float32",
             lambda: lanczos_iteration(mv, x, 3)),
            ("one Chebyshev step of 4 terms, complex64",
             lambda: chebyshev_time_evolve(z, mv, 0.1, (-20.0, 20.0),
                                           cheb_n=4)))
    for what, fn in runs:
        fn()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, dt = sync_time(fn)
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=12)
        print(f"profile flat L={L} ({what}; {dt * 1e3:.1f} ms on the host "
              f"clock):\n" + table)


def _exact_flat(m):
    """(evals, evecs, sector indices) of the model's sector block, from
    build_dense_H in float64 on the host."""
    import spindynamics_tpu_torch as pt

    idx = np.nonzero(m.valid_mask().numpy())[0]
    ev, U = np.linalg.eigh(pt.build_dense_H(m)[np.ix_(idx, idx)])
    return ev, U, idx


def phase_flat_oracle(dev):
    """L=12 on the card through K3 against the float64 dense oracle: the
    ground-state energy and a 10-step domain-wall trajectory."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import fused_matvec as fm

    L = 12
    m = _flat_model(L)
    ev, U, idx = _exact_flat(m)
    mv = pt.matvec_fn(m)
    n0 = fm.kernel_launch_count()
    E0, psi, info = pt.lanczos_groundstate_restarted(
        mv, N=m.n_states, lanc_m=40, cycles=6, target_residual=1e-4,
        mask=m.valid_mask(dev),
        generator=torch.Generator(device=dev).manual_seed(0))
    n_gs = fm.kernel_launch_count() - n0
    _, obs = pt.evolve_trajectory(
        m, pt.domain_wall_state(m, device=dev), dt=0.1, n_steps=10,
        cheb_n=40, generator=torch.Generator(device=dev).manual_seed(7))
    n_ev = fm.kernel_launch_count() - n0 - n_gs
    c = U[np.searchsorted(idx, pt.domain_wall_bitstring(m))]
    sz = ((idx[:, None] >> np.arange(L)) & 1) - 0.5
    exact = np.asarray([np.abs(U @ (np.exp(-0.1j * k * ev) * c)) ** 2 @ sz
                        for k in range(1, 11)])
    dE, dS = abs(E0 - ev[0]), float(np.abs(obs - exact).max())
    print(f"flat-oracle L=12: E0 {E0:.8f} (dense {ev[0]:.8f}, |d| {dE:.2e} "
          f"<= 1e-5) residual {info['residual']:.2e} | max |d<Sz_i>| over "
          f"10 steps {dS:.2e} (<= 1e-4) | K3 launches {n_gs} + {n_ev}")
    if not (mv.backend == "fused" and n_gs > 0 and n_ev > 0):
        raise RuntimeError("the L=12 flat path did not run K3")
    if not dE <= 1e-5:
        raise RuntimeError(f"L=12 flat E0 {E0} off the oracle by {dE}")
    if not dS <= 1e-4:
        raise RuntimeError(f"L=12 flat trajectory off exact by {dS}")


# flat-main's float32 S(q, omega) against float64: after 2 Lanczos steps
# (max |dS| / max S, every q) and each row's weight after 60
SQW_F32_2STEP_TOL = 1e-4
SQW_F32_WEIGHT_TOL = 1e-2


def phase_flat_main(L, dev):
    """The flat path at L: ground state, Lanczos and KPM S(q, omega),
    domain-wall trajectory, all through K3; then the same model through the
    kron layout (K1, K2). Returns (K3's launch count, E0)."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import dot2 as d2
    from spindynamics_tpu_torch.ops import fused_matvec as fm

    m = _flat_model(L)
    mask = m.valid_mask(dev)
    qs = [2 * np.pi * k / L for k in (4, 7, L // 2)]
    omega = np.linspace(0.0, 4.0, 200)
    lanc_m, sqw_m, kpm_m, cheb_n, n_steps = 40, 60, 100, 40, 5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fm.reset_kernel_launch_count()
    d2.reset_dot2_launch_count()
    mv = pt.matvec_fn(m)
    (E0, psi, info), t_gs = sync_time(
        lambda: pt.lanczos_groundstate_restarted(
            mv, N=m.n_states, lanc_m=lanc_m, cycles=6, target_residual=1e-3,
            mask=mask, generator=torch.Generator(device=dev).manual_seed(0)))
    n_gs = fm.kernel_launch_count()
    want_gs = info["cycles"] * (2 * lanc_m + 1) + info.get("polished", 0) * (
        lanc_m + 1)
    outside = bool(psi[~mask].any())
    S, t_sqw = sync_time(lambda: pt.lanczos_sqw(
        psi, m, qs, omega, lanc_m=sqw_m, eta=0.1, matvec=mv))
    n_sqw = fm.kernel_launch_count() - n_gs
    K, t_kpm = sync_time(lambda: pt.kpm_sqw(
        psi, m, qs, omega, kpm_m=kpm_m, E0=E0, matvec=mv,
        generator=torch.Generator(device=dev).manual_seed(7)))
    K = K.cpu().numpy()
    n_kpm = fm.kernel_launch_count() - n_gs - n_sqw
    del psi
    steps = []

    def observe(p, mdl):
        torch.cuda.synchronize()
        steps.append(time.perf_counter())
        return pt.magnetization_per_site(p, mdl)

    t0 = time.perf_counter()
    (psi_t, obs), t_ev = sync_time(lambda: pt.evolve_trajectory(
        m, pt.domain_wall_state(m, device=dev), dt=0.1, n_steps=n_steps,
        cheb_n=cheb_n, observe=observe,
        generator=torch.Generator(device=dev).manual_seed(7)))
    n_ev = fm.kernel_launch_count() - n_gs - n_sqw - n_kpm
    launches = fm.kernel_launch_count()
    n_dot2 = d2.dot2_launch_count()
    print(f"flat-main L={L}: dot2 launches {n_dot2}")
    if not n_dot2 > 0:
        raise RuntimeError("the flat path launched dot2 no time")
    peak = torch.cuda.max_memory_allocated()
    step_s = np.diff(steps)
    norm = float(torch.linalg.vector_norm(psi_t))
    out_ev = bool(torch.view_as_real(psi_t)[~mask].any())
    del psi_t
    tot = obs.sum(axis=1)
    want = {"sqw": 1 + len(qs) * sqw_m,
            "kpm": 80 + len(qs) * (1 + (kpm_m + 1) // 2),
            "evolve": 80 + n_steps * (cheb_n - 1)}
    np.set_printoptions(precision=4, suppress=True, linewidth=250)
    print(f"flat-main L={L} N=2^{L} ({m.n_states * 4 / 2**20:.0f} MiB real, "
          f"{m.n_states * 8 / 2**20:.0f} MiB complex per state): E0 "
          f"{E0:.6f} E0/L {E0 / L:.6f} residual {info['residual']:.3e} "
          f"cycles {info['cycles']} polished {info.get('polished', 0)} | "
          f"ground state {t_gs:.2f} s ({t_gs / n_gs * 1e3:.2f} ms per "
          f"apply), lanczos_sqw (3 q x {sqw_m}) {t_sqw:.2f} s "
          f"({t_sqw / n_sqw * 1e3:.2f} ms per apply), kpm_sqw (3 q x "
          f"{kpm_m} moments + 80 bounds steps) {t_kpm:.2f} s "
          f"({t_kpm / n_kpm * 1e3:.2f} ms per apply), trajectory "
          f"{t_ev:.2f} s (bounds {steps[0] - t0 - step_s.mean():.2f} s, "
          f"seconds per step median {float(np.median(step_s)):.3f}) | peak "
          f"{peak / 2**30:.2f} GiB | K3 launches {launches} = {n_gs} + "
          f"{n_sqw} + {n_kpm} + {n_ev} (predicted {want_gs} + "
          f"{want['sqw']} + {want['kpm']} + {want['evolve']}) | norm "
          f"{norm:.7f} | max |sum_i <Sz_i>| {float(np.abs(tot).max()):.2e}")
    print(f"flat-main L={L}: lanczos_sqw max {S.max():.4f} peak omega per q "
          f"{[float(omega[i]) for i in S.argmax(axis=1)]} | kpm_sqw max "
          f"{K.max():.4f} peak omega per q "
          f"{[float(omega[i]) for i in K.argmax(axis=1)]}")
    print(f"flat-main L={L}: <Sz_i> after step 5 {obs[-1]}")
    if mv.backend != "fused":
        raise RuntimeError(f"the flat path ran backend {mv.backend!r}")
    if (n_gs, n_sqw, n_kpm, n_ev) != (want_gs, want["sqw"], want["kpm"],
                                      want["evolve"]):
        raise RuntimeError("K3's launch count is not what the solvers' "
                           "apply counts predict")
    if not info["residual"] <= 1e-3:
        raise RuntimeError(f"flat residual {info['residual']} > 1e-3")
    if outside or out_ev:
        raise RuntimeError("weight outside the sector")
    if not (np.all(np.isfinite(S)) and S.max() > 0 and np.all(np.isfinite(K))
            and K.max() > 0 and K.min() >= -1e-6 * K.max()):
        raise RuntimeError("flat S(q, omega) not finite and non-negative")
    if not abs(norm - 1.0) <= 1e-4:
        raise RuntimeError(f"norm {norm} off 1 by more than 1e-4")
    if not (np.all(np.isfinite(obs)) and np.all(np.abs(tot) <= 1e-5)):
        raise RuntimeError(f"sum_i <Sz_i> not conserved: {tot}")

    # the same model on the kron layout: two layouts, three kernels
    mk = _evolve_model(L)
    (Ek, psik, ik, layk), t_k = sync_time(lambda: pt.groundstate_kron(
        mk, lanc_m=lanc_m, cycles=6, target_residual=1e-3))
    # the kron ground state carried to the flat layout: the same state
    # through both layouts' Lanczos S(q, omega) and observables
    (Sk, _), t_sk = sync_time(lambda: pt.lanczos_sqw_kron(
        mk, qs, omega, lanc_m=sqw_m, eta=0.1, psi0=psik, E0=Ek))
    psif = kron_to_flat(psik, layk, dev)
    Sf = pt.lanczos_sqw(psif, m, qs, omega, lanc_m=sqw_m, eta=0.1, matvec=mv)
    # the same state through both layouts' recurrences in float64 (plain
    # applies), where 60 Lanczos steps still agree to rounding
    mk64 = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2, dtype=torch.float64)
    m64 = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2, layout="embedded",
                       dtype=torch.float64)
    (Sk64, _), t_sk64 = sync_time(lambda: pt.lanczos_sqw_kron(
        mk64, qs, omega, lanc_m=sqw_m, eta=0.1, fused=False, E0=Ek,
        psi0=psik.map(lambda l: l.double())))
    Sf64 = pt.lanczos_sqw(psif.double(), m64, qs, omega, lanc_m=sqw_m,
                          eta=0.1, backend="blocked")
    # two steps of each recurrence, float32 (K1, K3, dot2) and float64
    Sk2, Sf2 = (pt.lanczos_sqw_kron(mk, qs, omega, lanc_m=2, eta=0.1,
                                    psi0=psik, E0=Ek)[0],
                pt.lanczos_sqw(psif, m, qs, omega, lanc_m=2, eta=0.1,
                               matvec=mv))
    Sk2_64, Sf2_64 = (
        pt.lanczos_sqw_kron(mk64, qs, omega, lanc_m=2, eta=0.1, fused=False,
                            E0=Ek, psi0=psik.map(lambda l: l.double()))[0],
        pt.lanczos_sqw(psif.double(), m64, qs, omega, lanc_m=2, eta=0.1,
                       backend="blocked"))
    zk, sk_ = pt.szsz_matrix_kron(psik, layk)
    zf, sf_ = pt.szsz_matrix(psif, m)
    _, Sqk = pt.structure_factor_Sq_kron(psik, layk)
    _, Sqf = pt.structure_factor_Sq(psif, m)
    dnorm = abs(float(torch.linalg.vector_norm(psif)) - 1.0)
    def dS_(a, b):  # max |dS| / max S, and the rows' weights
        return (float(np.abs(a - b).max()) / float(b.max()),
                float(np.abs(a.sum(axis=1) / b.sum(axis=1) - 1.0).max()))

    dSqw, dW = dS_(Sk, Sf)
    dSqw_gs = dS_(Sk, S)[0]
    dSqw64, dW64 = dS_(Sk64, Sf64)
    (dSk32, dWk32), (dSf32, dWf32) = dS_(Sk, Sk64), dS_(Sf, Sf64)
    d2 = max(dS_(Sk2, Sk2_64)[0], dS_(Sf2, Sf2_64)[0])
    # float32 against float64 on the rows away from q = pi (k = 4, 7)
    d32 = max(float(np.abs(a[:2] - b[:2]).max()) / float(b.max())
              for a, b in ((Sk, Sk64), (Sf, Sf64)))
    dzz = max(float((zk - zf).abs().max()), float((sk_ - sf_).abs().max()))
    dSq = float(np.abs(Sqk - Sqf.cpu().numpy()).max())
    del psik, psif
    dW32 = max(dWk32, dWf32)
    print(f"flat-main L={L} against the kron layout, from the kron ground "
          f"state carried to the flat layout (norm off 1 by {dnorm:.1e}): "
          f"float64 lanczos_sqw_kron ({t_sk64:.2f} s) against lanczos_sqw, "
          f"max |dS| / max S {dSqw64:.2e} (<= 1e-4), weight per q off by "
          f"{dW64:.2e} (<= 1e-4) | float32 through K1 and K3, each against "
          f"its layout's float64 run: 2 steps, every q {d2:.2e} (<= "
          f"{SQW_F32_2STEP_TOL:.0e}); {sqw_m} steps, weight per q kron "
          f"{dWk32:.2e}, flat {dWf32:.2e} (<= {SQW_F32_WEIGHT_TOL:.0e}), "
          f"at k = 4, 7 {d32:.2e} (<= 5e-2), all q kron {dSk32:.2e}, flat "
          f"{dSf32:.2e} (not held) | float32 lanczos_sqw_kron {t_sk:.2f} s "
          f"against lanczos_sqw {dSqw:.2e} (against the flat path's own "
          f"ground state {dSqw_gs:.2e}), weight {dW:.2e} (not held) | szsz "
          f"and <Sz_i> max |d| {dzz:.2e} (<= 1e-5) | S(q) max |d| {dSq:.2e} "
          f"(<= 1e-5)")
    if not dnorm <= 1e-5:
        raise RuntimeError("the kron state lost norm on the way to flat")
    # The layouts are held to each other in float64, where 60 Lanczos
    # steps without reorthogonalization from one state agree to about 6e-6
    # of the peak. Each float32 recurrence (K1 or K3, the dot2 kernel) is
    # held to its float64 one: after 2 steps at every q (at most 1e-5 of
    # the peak at L=22 and 26; 1.6e-3 to 8.2e-3 for an apply of its input
    # rounded to bfloat16, a kernel that lost its operand's low half), in
    # each row's weight after 60 (at most 3.7e-3; this limit sees a gross
    # fault only, the bfloat16 control reads 1.7e-3 to 3.0e-3), and at
    # k = 4, 7 after 60. At q = pi, S^z_q psi0 is close to one eigenstate
    # and the 60-step float32 rows of both layouts end about 0.2 of the
    # peak from float64 with any of the compensated dots; two float32
    # layouts then differ with the state's last bits, so they are not held
    # to each other (PERF.md, section 6; the readings of
    # spindynamics_tpu_torch/scripts/sqw_precision.py).
    if not (dSqw64 <= 1e-4 and dW64 <= 1e-4):
        raise RuntimeError(f"kron and flat float64 S(q, omega) differ by "
                           f"{dSqw64} of the peak, {dW64} in weight")
    if not d2 <= SQW_F32_2STEP_TOL:
        raise RuntimeError(f"float32 S(q, omega) after 2 steps off its "
                           f"float64 recurrence by {d2} of the peak")
    if not dW32 <= SQW_F32_WEIGHT_TOL:
        raise RuntimeError(f"a float32 S(q, omega) row's weight off its "
                           f"float64 recurrence by {dW32}")
    if not d32 <= 5e-2:
        raise RuntimeError(f"float32 S(q, omega) at k = 4, 7 off its float64 "
                           f"recurrence by {d32} of the peak")
    if not (dzz <= 1e-5 and dSq <= 1e-5):
        raise RuntimeError(f"kron and flat observables differ: szsz {dzz}, "
                           f"S(q) {dSq}")
    (_, obs_k, _), t_ek = sync_time(lambda: pt.evolve_trajectory_kron(
        mk, pt.domain_wall_bitstring(mk), dt=0.1, n_steps=n_steps,
        cheb_n=cheb_n))
    dE, dS = abs(E0 - Ek), float(np.abs(obs - obs_k).max())
    print(f"flat-main L={L} against the kron layout: E0 flat {E0:.6f} kron "
          f"{Ek:.6f} |d| {dE:.2e} (<= 1e-4) | max |d<Sz_i>| over {n_steps} "
          f"steps {dS:.2e} (<= 1e-5) | kron ground state {t_k:.2f} s, "
          f"trajectory {t_ek:.2f} s")
    if not dE <= 1e-4:
        raise RuntimeError(f"flat and kron E0 differ by {dE}")
    if not dS <= 1e-5:
        raise RuntimeError(f"flat and kron <Sz_i> differ by {dS}")
    return launches, E0


# ---------------------------------------------------------------------------
# the compact sector layout (the ell apply), flat typicality, checkpoints
# ---------------------------------------------------------------------------


class _EllApplies:
    """Counts the applies of every FlatHamiltonian of one backend (default
    'ell') while active (a global forward hook): the applies of a phase,
    the runners' own modules included. The sector_blocked apply is plain
    torch; an ell apply on the card is one ell kernel launch."""

    def __init__(self, backend="ell"):
        self.n = 0
        self.backend = backend
        self._h = None

    def _hook(self, mod, args, out):
        if getattr(mod, "backend", None) == self.backend:
            self.n += 1

    def __enter__(self):
        self._h = torch.nn.modules.module.register_module_forward_hook(
            self._hook)
        return self

    def __exit__(self, *exc):
        self._h.remove()


def _compact_model(L, kind="heisenberg", dtype=torch.float32):
    """Compact Sz=0 models: the Heisenberg chain of `main`, the XXZ chain of
    `evolve` (Jxy=1, Jz=0.5), that chain with a non-uniform field, or an
    all-pairs model."""
    import spindynamics_tpu_torch as pt

    if kind == "heisenberg":
        return pt.heisenberg_chain(L, nup=L // 2, layout="compact",
                                   dtype=dtype)
    if kind == "longrange":
        return pt.build_model(
            L, nup=L // 2, layout="compact", dtype=dtype,
            hopping=pt.long_range_hopping(L, lambda i, j: 1.0 / (j - i)),
            zz=pt.long_range_hopping(L, lambda i, j: 0.3 / (j - i) ** 2),
            onsite_field=np.linspace(-0.2, 0.3, L))
    h = np.linspace(-0.2, 0.3, L) if kind == "xxz-field" else None
    return pt.xxz_chain(L, Jxy=1.0, Jz=0.5, h=h, nup=L // 2,
                        layout="compact", dtype=dtype)


def phase_compact_oracle(dev):
    """L=16 on the card, float64 and float32: the states and the ELL table
    of the torch build equal the host build's bit for bit, the diagonal to
    rounding, and the ell apply on the card matches the CPU apply on the
    same vector (real and complex; float64 1e-12, float32 1e-6 of
    max|y|: addmv sums the bonds in another order on each device)."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.model import sector_setup

    for kind in ("xxz-field", "longrange"):
        for dt, tol in ((torch.float64, 1e-12), (torch.float32, 1e-6)):
            m = _compact_model(16, kind, dt)
            (s_d, d_d, t_d), t_dev = sync_time(
                lambda: sector_setup(m, dev))
            s_h, d_h, t_h = sector_setup(m, "cpu")
            if not (torch.equal(s_d.cpu(), s_h) and torch.equal(t_d.cpu(),
                                                                t_h)):
                raise RuntimeError(f"L=16 {kind} {dt}: the card's states or "
                                   "ELL table differ from the host build")
            dd = float((d_d.cpu() - d_h).abs().max())
            if not dd <= tol * float(d_h.abs().max()):
                raise RuntimeError(f"L=16 {kind}: diagonal off by {dd}")
            mv_d = pt.matvec_fn(m, device=dev)
            mv_h = pt.matvec_fn(m, device="cpu")
            errs = []
            for cplx in (False, True):
                x = _flat_state(m, dev, cplx, 16, dt)
                y = mv_d(x)
                want = mv_h(x.cpu())
                rel = float((y.cpu() - want).abs().max()) / float(
                    want.abs().max())
                if not rel <= tol:
                    raise RuntimeError(f"L=16 {kind} {dt}: ell on the card "
                                       f"off the CPU apply by {rel:.3e}")
                if not torch.equal(y, mv_d(x)):
                    raise RuntimeError(f"L=16 {kind}: two ell applies of "
                                       "one input differ")
                errs.append(rel)
            print(f"compact-oracle L=16 {kind} {str(dt)[6:]}: N "
                  f"{m.n_states}, {m.n_bonds} bonds | states and ELL table "
                  f"of the card's build equal the host build's, diagonal "
                  f"max|d| {dd:.1e} | torch build {t_dev:.3f} s | ell apply "
                  f"card vs CPU max|d|/max|y| real {errs[0]:.2e} complex "
                  f"{errs[1]:.2e} (<= {tol:g}), repeats bit-identical")


def csr_from_ell(mv, chunk=1 << 20):
    """The matrix of an ell FlatHamiltonian as a torch sparse CSR tensor
    (int32 indices, values in the diagonal's dtype), built from its table
    on its device, row chunk by row chunk: per row the diagonal, then one
    entry per bond with a partner. The library yardstick of the ell apply:
    it is timed, never used by the port."""
    nbr, diag = mv.nbr, mv.diag
    dev = nbr.device
    N, nb = nbr.shape
    J = torch.as_tensor(mv.model.hop_J, device=dev).to(diag.dtype)
    cnt = torch.cat([1 + (nbr[s:s + chunk] >= 0).sum(1)
                     for s in range(0, N, chunk)])
    crow = torch.zeros(N + 1, dtype=torch.int32, device=dev)
    crow[1:] = torch.cumsum(cnt, 0)
    del cnt
    nnz = int(crow[-1])
    col = torch.empty(nnz, dtype=torch.int32, device=dev)
    val = torch.empty(nnz, dtype=diag.dtype, device=dev)
    for s in range(0, N, chunk):
        e = min(N, s + chunk)
        c = torch.cat([torch.arange(s, e, dtype=torch.int32,
                                    device=dev)[:, None], nbr[s:e]], 1)
        v = torch.cat([diag[s:e, None], J.expand(e - s, nb)], 1)
        keep = c >= 0
        p0, p1 = int(crow[s]), int(crow[e])
        col[p0:p1] = c[keep]
        val[p0:p1] = v[keep]
    return torch.sparse_csr_tensor(crow, col, val, size=(N, N),
                                   check_invariants=False)


def kron_references(L, dev):
    """(E0, S, KPM info, trajectory info with obs) of the main and evolve
    phases' runs at L, for a --L-compact other than --L."""
    import spindynamics_tpu_torch as pt

    m = pt.heisenberg_chain(L, nup=L // 2)
    qs = [2 * np.pi * k / L for k in (4, 7, L // 2)]
    E0, psi, info, _ = pt.groundstate_kron(
        m, lanc_m=40, cycles=6, target_residual=1e-3, device=dev)
    S, kinfo = pt.kpm_sqw_kron(m, qs, np.linspace(0.0, 4.0, 200), kpm_m=100,
                               psi0=psi, E0=E0, info=info, device=dev)
    me = _evolve_model(L)
    _, obs, einfo = pt.evolve_trajectory_kron(
        me, pt.domain_wall_bitstring(me), dt=0.1, n_steps=5, cheb_n=40,
        device=dev)
    return E0, S, kinfo, dict(einfo, obs=obs)


def phase_ell(L, dev, mv=None):
    """The ell kernel on the module `mv` of the compact Heisenberg chain at
    L (built here when not given), float32 and complex64: its time beside
    its bytes bound (the int32 table once, the state and diagonal read,
    the result written), the plain version's and a torch sparse CSR
    product's of the same matrix (the library yardstick, complex as a
    complex64 CSR matrix), each held to the plain result within 1e-6 of
    max|y|; two applies of one input equal in every bit; one launch an
    apply. Returns {"float32" / "complex64": {ms, plain_ms, library_ms,
    bound_ms, errors}, "bonds", "N", "nnz", "peak_with_csr_bytes"}."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import ell_apply as ea

    if mv is None:
        mv = pt.matvec_fn(_compact_model(L), device=dev)
    m = mv.model
    N, nb = mv.nbr.shape
    table_bytes = mv.nbr.numel() * mv.nbr.element_size()
    H = csr_from_ell(mv)
    rec = {"L": L, "N": N, "bonds": nb, "nnz": H.values().shape[0],
           "tile_rows": ea.tile_rows(nb)}
    for cplx in (False, True):
        tag = "complex64" if cplx else "float32"
        x = _flat_state(m, dev, cplx, L)

        def plain():
            return ea.ell_apply_plain(x, mv.nbr, mv.diag, mv.hop_J)

        want = plain()
        ymax = float(want.abs().max())
        n0 = ea.ell_launch_count()
        y = mv(x)
        if ea.ell_launch_count() - n0 != 1:
            raise RuntimeError(f"ell {tag}: {ea.ell_launch_count() - n0} "
                               "launches in one apply, not 1")
        if not torch.equal(y, mv(x)):
            raise RuntimeError(f"ell {tag}: two applies of one input "
                               "differ")
        Hx = H.to(x.dtype) if cplx else H
        errs = {"kernel": float((y - want).abs().max()) / ymax,
                "library": float((Hx @ x - want).abs().max()) / ymax}
        for what, e in errs.items():
            if not e <= 1e-6:
                raise RuntimeError(f"ell {tag}: the {what} off the plain "
                                   f"version by {e:.3e} of max|y|")
        comp = x.element_size()
        bound = _bound(table_bytes + N * (2 * comp + 4), 0.0)
        r = rec[tag] = {"ms": event_ms(lambda: mv(x), reps=20),
                        "plain_ms": event_ms(plain, reps=5),
                        "library_ms": event_ms(lambda: Hx @ x, reps=10),
                        "bound_ms": bound[0], "bound_by": bound[1],
                        "errors": errs}
        del Hx, want, y, x
        print(f"ell L={L} {tag}: kernel {r['ms']:.4f} ms | bound "
              f"{bound[0]:.4f} ms by {bound[1]} "
              f"({100 * bound[0] / r['ms']:.1f}%) | plain {r['plain_ms']:.3f}"
              f" ms | torch sparse CSR {r['library_ms']:.3f} ms "
              f"({rec['nnz']} non-zeros) | max|d| / max|y| kernel "
              f"{errs['kernel']:.1e}, CSR {errs['library']:.1e} (<= 1e-6) | "
              f"{rec['tile_rows']} rows a tile")
    rec["peak_with_csr_bytes"] = torch.cuda.max_memory_allocated()
    del H
    torch.cuda.empty_cache()
    return rec


class _EllLaunches(_EllApplies):
    """_EllApplies that also reads the ell kernel's launch counters
    (`launches.ell.<dtype>`) over the block, and raises on leaving unless
    every ell apply was one launch: `launches` is {dtype: launches}."""

    def __enter__(self):
        from spindynamics_tpu_torch.utils.profiling import counters

        self._c0 = counters()
        return super().__enter__()

    def __exit__(self, *exc):
        from spindynamics_tpu_torch.utils.profiling import counters

        super().__exit__(*exc)
        c0, c1 = self._c0, counters()
        self.launches = {k[len("launches.ell."):]: c1[k] - c0.get(k, 0)
                         for k in c1 if k.startswith("launches.ell.")
                         and c1[k] != c0.get(k, 0)}
        if exc[0] is None and sum(self.launches.values()) != self.n:
            raise RuntimeError(f"{self.n} ell applies made "
                               f"{self.launches} kernel launches, not one "
                               "each")


def phase_compact_main(L, dev, E0_main, S_main, kinfo, einfo):
    """The compact layout at L through the entry points: the torch build of
    the Heisenberg chain of `main` (states, diagonal, ELL table) and the
    ell phase on its module; the restarted ground state against main's
    kron E0, kpm_sqw at main's q-points, omega grid and rescaling against
    main's KPM S(q, omega), lanczos_sqw (3 q x 60); then the 5-step
    domain-wall trajectory of the XXZ chain of `evolve` from its bounds
    against the kron run's <Sz_i>. Every ell apply of the solves is one
    kernel launch (raises otherwise). Returns the ell record, the ell
    phase's under "kernel"."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import ell_apply as ea

    m = _compact_model(L)
    N = m.n_states
    qs = [2 * np.pi * k / L for k in (4, 7, L // 2)]
    omega = np.linspace(0.0, 4.0, 200)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mv, t_build = sync_time(lambda: pt.matvec_fn(m, device=dev))
    table_bytes = mv.nbr.numel() * mv.nbr.element_size()
    rec = {"L": L, "N": N, "bonds": m.n_bonds, "build_s": t_build,
           "table_bytes": table_bytes, "kernel": phase_ell(L, dev, mv)}
    # the solvers' peak: the module's table, states and diagonal, and the
    # vectors of each solve
    torch.cuda.reset_peak_memory_stats()
    print(f"compact-main L={L}: N {N}, table {table_bytes / 2**30:.2f} GiB "
          f"({table_bytes} bytes), torch build {t_build:.2f} s")
    ea.reset_ell_launch_count()
    with _EllLaunches() as n_gs:
        (E0, psi, info), t_gs = sync_time(
            lambda: pt.lanczos_groundstate_restarted(
                mv, N=N, lanc_m=40, cycles=6, target_residual=1e-3,
                generator=torch.Generator(device=dev).manual_seed(0)))
    with _EllLaunches() as n_kpm:
        K, t_kpm = sync_time(lambda: pt.kpm_sqw(
            psi, m, qs, omega, a=kinfo["a"], b=kinfo["b"], kpm_m=100,
            E0=E0_main, matvec=mv).cpu().numpy())
    with _EllLaunches() as n_sqw:
        S, t_sqw = sync_time(lambda: pt.lanczos_sqw(
            psi, m, qs, omega, lanc_m=60, eta=0.1, matvec=mv))
    del psi, mv
    torch.cuda.empty_cache()
    me = _compact_model(L, "xxz")
    with _EllLaunches() as n_ev:
        (psi_t, obs), t_ev = sync_time(lambda: pt.evolve_trajectory(
            me, pt.domain_wall_state(me, device=dev), dt=0.1, n_steps=5,
            cheb_n=40, Ebounds=einfo["Ebounds"]))
    peak = torch.cuda.max_memory_allocated()
    norm = float(torch.linalg.vector_norm(psi_t))
    del psi_t
    dE = abs(E0 - E0_main)
    dK = float(np.abs(K - S_main).max()) / float(np.abs(S_main).max())
    dS = float(np.abs(obs - einfo["obs"]).max())
    solves = {"ground_state": n_gs, "kpm_sqw": n_kpm,
              "lanczos_sqw": n_sqw, "trajectory": n_ev}
    rec.update(ground_state_s=t_gs, kpm_s=t_kpm, lanczos_sqw_s=t_sqw,
               trajectory_s=t_ev, peak_bytes=peak, E0=E0,
               applies={k: c.n for k, c in solves.items()},
               launches={k: c.launches for k, c in solves.items()},
               ell_launches=ea.ell_launch_count())
    print(f"compact-main L={L}: E0 {E0:.6f} (kron {E0_main:.6f}, |d| "
          f"{dE:.2e} <= 1e-4) residual {info['residual']:.3e} cycles "
          f"{info['cycles']} polished {info.get('polished', 0)} | ground "
          f"state {t_gs:.2f} s ({n_gs.n} applies), kpm_sqw (3 q x 100, "
          f"main's a, b) {t_kpm:.2f} s ({n_kpm.n}), lanczos_sqw (3 q x 60) "
          f"{t_sqw:.2f} s ({n_sqw.n}), trajectory (5 steps, evolve's bounds) "
          f"{t_ev:.2f} s ({n_ev.n}) | ell kernel launches "
          f"{rec['launches']}, one an apply | peak {peak / 2**30:.2f} GiB "
          f"(with the CSR matrix "
          f"{rec['kernel']['peak_with_csr_bytes'] / 2**30:.2f} GiB)")
    print(f"compact-main L={L}: kpm_sqw against main's kpm_sqw_kron, max "
          f"|dS| / max S {dK:.2e} (<= 5e-2; two ground states, each to "
          f"residual 1e-3) | lanczos_sqw max {S.max():.4f}, row weights "
          f"{[round(float(w), 4) for w in S.sum(axis=1)]} | trajectory "
          f"<Sz_i> against the kron run max |d| {dS:.2e} (<= 1e-5), norm "
          f"{norm:.7f}")
    if not info["residual"] <= 1e-3:
        raise RuntimeError(f"compact residual {info['residual']} > 1e-3")
    if not dE <= 1e-4:
        raise RuntimeError(f"compact and kron E0 differ by {dE}")
    if not (np.all(np.isfinite(K)) and dK <= 5e-2):
        raise RuntimeError(f"compact and kron KPM S differ by {dK} of the "
                           "peak")
    if not (np.all(np.isfinite(S)) and np.all(S.sum(axis=1) > 0)
            and S.min() >= -1e-6 * S.max()):
        raise RuntimeError("compact lanczos_sqw rows not positive")
    if not (np.all(np.isfinite(obs)) and dS <= 1e-5):
        raise RuntimeError(f"compact and kron <Sz_i> differ by {dS}")
    if not abs(norm - 1.0) <= 1e-4:
        raise RuntimeError(f"compact trajectory norm {norm}")
    return rec


def _exact_thermal(m, beta, a, b, ts, dev):
    """<Sz_a(t) Sz_b(0)>_beta = Tr[e^{-beta H} e^{iHt} Sz_a e^{-iHt} Sz_b]
    / Z over the model's basis, by dense matrix exponentials in float64 on
    `dev`."""
    import spindynamics_tpu_torch as pt

    H = torch.as_tensor(pt.build_dense_H(m), device=dev)
    s = m.basis_states(dev)
    sza = torch.diag(((s >> a) & 1).double() - 0.5).to(torch.complex128)
    szb = torch.diag(((s >> b) & 1).double() - 0.5).to(torch.complex128)
    rho = torch.linalg.matrix_exp(-beta * H).to(torch.complex128)
    Hc = H.to(torch.complex128)
    out = []
    for t in ts:
        U = torch.linalg.matrix_exp(-1j * t * Hc)
        out.append(complex(torch.trace(rho @ U.conj().T @ sza @ U @ szb)
                           / torch.trace(rho)))
    return np.asarray(out)


def _typicality_sample(m, dev, seed, site, ts, **kw):
    """(C(t), thermal state's szsz[site, site], seconds) of one sample at
    beta=1 through the entry points: typicality_correlation_function and
    thermal_state from the same generator seed."""
    import spindynamics_tpu_torch as pt

    op = pt.make_spin_operator(site, "z")
    C, dt = sync_time(lambda: pt.typicality_correlation_function(
        m, 1.0, op, op, ts, generator=torch.Generator(
            device=dev).manual_seed(seed), kry_m=30, **kw))
    psi_b, _ = pt.thermal_state(
        m, 1.0, generator=torch.Generator(device=dev).manual_seed(seed),
        kry_m=30)
    zz, _ = pt.szsz_matrix(psi_b, m)
    return C, float(zz[site, site]), dt


def phase_flat_typicality(L, dev):
    """Flat quantum typicality: <Sz_a(t) Sz_a(0)>_beta=1 at t = 0, 0.5, 1
    on the embedded layout at L (every apply through K3, complex64) and on
    the compact layout at the same L (the ell apply); C finite, Im C(0) ~ 0,
    C(0) equal to szsz of the thermal state drawn from the same seed. Then
    at L=12 (compact) the mean of 8 samples against dense expm on the card
    (0.05, the JAX package's tolerance for the exact average), and at L=16
    (embedded, K3) krylov, chebyshev and rk4 at t = 0.3. Returns K3's
    launches at L."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import fused_matvec as fm

    ts = (0.0, 0.5, 1.0)
    a = L // 2
    out = {}
    for layout in ("embedded", "compact"):
        m = (_flat_model(L) if layout == "embedded"
             else _compact_model(L, "xxz"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fm.reset_kernel_launch_count()
        with _EllApplies() as n_ell:
            C, zz, dt = _typicality_sample(m, dev, 5, a, ts)
        n_k3 = fm.kernel_launch_count()
        peak = torch.cuda.max_memory_allocated()
        out[layout] = (n_k3, n_ell.n, dt)
        print(f"flat-typicality L={L} {layout} (N {m.n_states}): C(t) at t "
              f"{ts}: {[complex(round(z.real, 6), round(z.imag, 6)) for z in C]}"
              f" | {dt:.2f} s, peak {peak / 2**30:.2f} GiB | K3 launches "
              f"{n_k3}, ell applies {n_ell.n} | C(0) - szsz of the thermal "
              f"state {abs(C[0] - zz):.1e} (<= 1e-5)")
        if not np.all(np.isfinite(C)):
            raise RuntimeError(f"{layout}: non-finite typicality C(t)")
        if not (abs(C[0].imag) <= 1e-6 and abs(C[0] - zz) <= 1e-5):
            raise RuntimeError(f"{layout}: C(0) = {C[0]}, szsz {zz}")
        if layout == "embedded" and not n_k3 > 0:
            raise RuntimeError("embedded typicality launched K3 no time")
        if layout == "compact" and not (n_ell.n > 0 and n_k3 == 0):
            raise RuntimeError("compact typicality did not run the ell "
                               "apply alone")
    m12 = _compact_model(12, "xxz")
    want = _exact_thermal(m12, 1.0, 5, 6, (0.0, 0.3), dev)
    got = np.mean([pt.typicality_correlation_function(
        m12, 1.0, pt.make_spin_operator(5, "z"), pt.make_spin_operator(6, "z"),
        (0.0, 0.3), generator=torch.Generator(device=dev).manual_seed(seed),
        kry_m=30) for seed in range(8)], axis=0)
    d12 = float(np.abs(got - want).max())
    m16 = _flat_model(16)
    Cs = {meth: pt.typicality_correlation_function(
        m16, 0.5, pt.make_spin_operator(8, "z"), pt.make_spin_operator(8, "z"),
        (0.0, 0.3), method=meth, cheb_n=40, rk4_substeps=60,
        generator=torch.Generator(device=dev).manual_seed(3), kry_m=30)
        for meth in ("krylov", "chebyshev", "rk4")}
    d16 = max(float(np.abs(Cs[k] - Cs["krylov"]).max()) for k in Cs)
    print(f"flat-typicality L=12 compact: mean of 8 samples "
          f"{[complex(round(z.real, 5), round(z.imag, 5)) for z in got]} "
          f"against dense expm {[complex(round(z.real, 5), round(z.imag, 5)) for z in want]}"
          f", max |d| {d12:.2e} (<= 0.05) | L=16 embedded: krylov, "
          f"chebyshev, rk4 at t 0.3 max |d| {d16:.2e} (<= 1e-4)")
    if not d12 <= 0.05:
        raise RuntimeError(f"L=12 typicality mean off exact by {d12}")
    if not d16 <= 1e-4:
        raise RuntimeError(f"L=16 typicality methods differ by {d16}")
    return out


def phase_checkpoint(dev, L=20):
    """Checkpoint/resume on the card at L (compact): a checkpointed ground
    state cut after 2 restart cycles and resumed to 4 equals the
    uninterrupted 4 cycles bit for bit, and a trajectory cut after 4 of 6
    steps (a save every 2) and resumed, its bounds read back from the
    checkpoint, equals the uninterrupted 6 steps bit for bit. The
    checkpoints are written under build/ of the checkout and removed."""
    import shutil

    import spindynamics_tpu_torch as pt

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoint"
    shutil.rmtree(root, ignore_errors=True)
    m = _compact_model(L)
    mv = pt.matvec_fn(m, device=dev)

    def gs(path, cycles):
        return pt.lanczos_groundstate_checkpointed(
            mv, m.n_states, str(root / path), lanc_m=40, cycles=cycles,
            generator=torch.Generator(device=dev).manual_seed(0),
            device=dev)

    (E_a, psi_a, _), t_a = sync_time(lambda: gs("whole", 4))
    gs("cut", 2)
    (E_b, psi_b, info_b), t_b = sync_time(lambda: gs("cut", 4))
    gs_equal = E_a == E_b and torch.equal(psi_a, psi_b)
    me = _compact_model(L, "xxz")
    psi0 = pt.domain_wall_state(me, device=dev)

    def traj(n, **kw):
        return pt.evolve_trajectory(
            me, psi0, dt=0.1, n_steps=n, cheb_n=40,
            generator=torch.Generator(device=dev).manual_seed(7), **kw)

    p_a, o_a = traj(6)
    traj(4, checkpoint_dir=str(root / "traj"), checkpoint_every=2)
    p_b, o_b = traj(6, checkpoint_dir=str(root / "traj"), checkpoint_every=2,
                    resume=True)
    traj_equal = torch.equal(p_a, p_b) and np.array_equal(o_a, o_b)
    shutil.rmtree(root)
    print(f"checkpoint L={L} compact: ground state 4 cycles {t_a:.2f} s, E0 "
          f"{E_a:.8f}; cut after 2 and resumed (resumed_at "
          f"{info_b['resumed_at']}) {t_b:.2f} s, E0 {E_b:.8f}: bit for bit "
          f"{gs_equal} | trajectory 6 steps, cut after 4 and resumed with "
          f"the saved bounds: bit for bit {traj_equal}")
    if not gs_equal:
        raise RuntimeError("the resumed ground state differs from the "
                           "uninterrupted one")
    if not traj_equal:
        raise RuntimeError("the resumed trajectory differs from the "
                           "uninterrupted one")


# ---------------------------------------------------------------------------
# the sharded kron path
# ---------------------------------------------------------------------------


def _sharded(L, D, dev, model=None):
    """(model, ShardedKronHamiltonian over LocalMesh(D) on dev, layout,
    spec, mesh) at size L (the Heisenberg chain unless a model is given)."""
    import spindynamics_tpu_torch as pt

    m = pt.heisenberg_chain(L, nup=L // 2) if model is None else model
    mesh = pt.LocalMesh(D, dev)
    H, lay, spec = pt.sharded_kron_scaling_bv_matvec_fn(m, mesh)
    return m, H, lay, spec, mesh


def _shard_pieces(H, bv):
    """The parts of one sharded apply of `bv`, as the apply computes them:
    (windows, {gi: seed leaf in the state dtype}, per-shard local leaves
    G[i], kernel args [(T, seed, srcs, srcsh, wins, call, gi, i)] over the
    fused groups and local shards)."""
    from spindynamics_tpu_torch.parallel import sharded_kron_scaling as sk

    lay, spec, cfg, mesh = H.layout, H.spec, H.cfg, H.mesh
    tables, shards = H._state()
    sdt = bv.dtype

    def local(x, gi, i):
        return x[i * spec.b[gi]: (i + 1) * spec.b[gi]]

    G = [[local(l, gi, i) for gi, l in enumerate(bv.leaves)]
         for i in range(mesh.n_local)]
    wins = sk._build_crossh_windows_leaves(bv.leaves, cfg.moves, mesh)
    seeds = {}
    for gi in range(len(lay.groups)):
        if sk._has_partial(lay, cfg, gi):
            cross = not (gi in cfg.fused_set
                         and cfg.plans[gi].crossh_fusable)
            seeds[gi] = mesh.reduce_scatter_rows(
                sk._hi_partial(sh, gi, G[i], tables, lay, spec, cross)
                for i, sh in enumerate(shards)).wait().to(sdt)
    args = []
    for gi in sorted(cfg.fused_set):
        for i, sh in enumerate(shards):
            c = sh["calls"][gi]
            w = [local(wins[cfg.win_pos[(gi, ei)]], gi, i)
                 for ei in range(len(c.crossw))]
            args.append((G[i][gi],
                         local(seeds[gi], gi, i) if gi in seeds else None,
                         [G[i][x[0]] for x in c.cross],
                         [G[i][x[0]] for x in c.crossh], w, c, gi, i))
    return wins, seeds, G, args


def _crossw_work(call, seeded, state_bytes, real):
    """(bytes, flops) of one windowed launch over the block's `real` hi
    rows (the last shard's zero padding rows are no work): the local
    block's own work (_group_work) plus, per window, the rows of its mid
    runs read once and one multiply-add per element of them."""
    w = list(_group_work(call, seeded, state_bytes=state_bytes, rows=real))
    clp = call.shape[2]
    for (_, mids) in call.crossw:
        run_rows = sum(lna for (_, _, lna, _) in mids)
        w[0] += state_bytes * real * run_rows * clp
        w[1] += 2 * real * run_rows * clp
        w[3] += 2 * real * run_rows * clp
    return tuple(w)


def phase_k1_crossw(L, D, dev, sdt):
    """K1's crossw variant vs its plain version on the same CUDA tensors:
    every windowed launch of one sharded apply over LocalMesh(D) at L.
    Returns (max abs err, worst error measure, crossw ms, plain ms, bound)
    summed over those launches."""
    from spindynamics_tpu_torch.ops import kron_group as kg
    from spindynamics_tpu_torch.solvers.blockvec import bv_random

    bf16 = sdt == torch.bfloat16
    m, H, lay, spec, mesh = _sharded(L, D, dev)
    g = torch.Generator(device=dev).manual_seed(100 * L + D)
    bv = bv_random(lay, g, sdt, dev, shard=(spec, mesh))
    _, _, _, args = _shard_pieces(H, bv)
    args = [a for a in args if a[4]]  # the launches that read windows
    if not args:
        raise RuntimeError(f"L={L} D={D}: no windowed launch")
    abs_err = worst = 0.0
    n0 = kg.kernel_launch_count(sdt, crossw=True)
    for (T, seed, srcs, srcsh, w, c, gi, i) in args:
        got = kg.kron_group_apply(T, seed, srcs, srcsh, c, w)
        if not torch.equal(got, kg.kron_group_apply(T, seed, srcs, srcsh, c,
                                                    w)):
            raise RuntimeError(f"L={L} D={D} group {gi} shard {i}: two "
                               "crossw launches on the same inputs differ")
        want = kg.kron_group_apply_reference(
            _lift(T), _lift(seed), _lift(srcs), _lift(srcsh), c, _lift(w))
        torch.cuda.synchronize()
        (_, _, _, ch, cm, cl, cmp, clp) = lay.groups[gi]
        real = max(0, min(spec.b[gi], ch - i * spec.b[gi]))
        if (got[:, cm:, :].any() or got[:, :, cl:].any()
                or got[real:].any()):
            raise RuntimeError(f"L={L} D={D} group {gi} shard {i}: tile pads "
                               f"or hi padding rows not 0")
        if got.dtype != sdt:
            raise RuntimeError(f"crossw returned {got.dtype} for {sdt}")
        d, r = err_ratio(got, want, rounded=bf16)
        abs_err, worst = max(abs_err, d), max(worst, r)
    if kg.kernel_launch_count(sdt, crossw=True) - n0 != 2 * len(args):
        raise RuntimeError("the crossw launches were not counted")
    if not worst <= 1.0:
        raise RuntimeError(
            f"L={L} D={D} {sdt}: K1 crossw is {worst:.2f}x its limit off "
            f"the plain version")

    def run(fn):
        def go():
            for (T, seed, srcs, srcsh, w, c, _, _) in args:
                fn(T, seed, srcs, srcsh, c, w)
        return go

    groups = {a[6] for a in args}
    _, _, _, _, uargs = _k1_inputs(L, dev, sdt)
    uargs = [a for a in uargs if a[5].gi in groups]

    def run_unsharded():
        for (T, seed, _, srcs, srcsh, c) in uargs:
            kg.kron_group_apply(T, seed, srcs, srcsh, c)

    k_ms = event_ms(run(kg.kron_group_apply))
    p_ms = event_ms(run(kg.kron_group_apply_reference), reps=10)
    u_ms = event_ms(run_unsharded)
    k_ms2 = event_ms(run(kg.kron_group_apply))
    g_ms = graph_ms(run(kg.kron_group_apply))
    gu_ms = graph_ms(run_unsharded)
    bound, bound_fma, gb, gf, gtc = _bounds(
        [_crossw_work(c, seed is not None, 2 if bf16 else 4,
                      max(0, min(spec.b[gi],
                                 lay.groups[gi][3] - i * spec.b[gi])))
         for (_, seed, _, _, _, c, gi, i) in args])
    lim = ("|d| / (2^-8 |y| + 1e-5 max|y|) against the plain float32 value"
           if bf16 else "max|d| / (1e-5 max|y|)")
    print(f"k1-crossw L={L} D={D} {str(sdt).split('.')[-1]}: {len(args)} "
          f"windowed launches over {len(groups)} groups x {D} shards | worst "
          f"{lim} {worst:.3f} (<= 1), max|d| {abs_err:.3e}, tile pads and hi "
          f"padding rows 0 | the windowed launches of one sharded apply "
          f"(median of 20, crossw/plain/unsharded/crossw): crossw "
          f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, K1 unsharded on the same "
          f"{len(uargs)} groups {u_ms:.3f} ms, crossw {k_ms2:.3f} ms | the "
          f"same launches replayed from a CUDA graph (no host in the "
          f"loop): crossw {g_ms:.3f} ms, K1 unsharded {gu_ms:.3f} ms | "
          f"moves {gb:.3f} GB and does {gf:.1f} GFLOP of products ({gtc:.1f} "
          f"per pass on the tensor cores): bound {bound[0]:.3f} ms by "
          f"{bound[1]} (FMA route: {bound_fma[0]:.3f} ms by {bound_fma[1]}); "
          f"launches repeat bit for bit")
    return abs_err, worst, min(k_ms, k_ms2), p_ms, bound, g_ms, bound_fma


def phase_shard_apply(L, dev):
    """The sharded fused apply over LocalMesh(D), D = 1, 2, 4, 8, against
    the unsharded fused apply of the same state."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import kron_group as kg
    from spindynamics_tpu_torch.ops.sector_kron import apply_H_sector_kron
    from spindynamics_tpu_torch.parallel import sharded_kron_scaling as sk
    from spindynamics_tpu_torch.solvers.blockvec import bv_random

    m = pt.heisenberg_chain(L, nup=L // 2)
    H0 = None
    for D in (1, 2, 4, 8):
        _, H, lay, spec, mesh = _sharded(L, D, dev, m)
        if H0 is None:
            H0 = pt.KronHamiltonian(lay, dtype=torch.float32, device=dev)
            g = torch.Generator(device=dev).manual_seed(L)
            bv = bv_random(lay, g, torch.float32, dev)
            y0 = H0(bv)
            scale = max(float(l.abs().max()) for l in y0.leaves)
            u_ms = event_ms(lambda: H0(bv))
        x = pt.shard_kron_blockvec(bv, spec, mesh)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mesh.reset_counters()
        kg.reset_kernel_launch_count()
        ys = H(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        n_k1 = kg.kernel_launch_count()
        n_cw = kg.kernel_launch_count(crossw=True)
        cnt = mesh.counters()
        model = pt.collective_traffic_model(lay, spec, H.cfg)
        y = pt.unshard_kron_blockvec(ys, spec)
        err = max(float((a - b).abs().max())
                  for a, b in zip(y.leaves, y0.leaves)) / scale
        pads = any(bool(l[ch:].any()) for l, (_, _, _, ch, *_r)
                   in zip(ys.leaves, lay.groups))
        del ys, y
        if not err <= 1e-5:
            raise RuntimeError(f"D={D}: sharded apply off the unsharded one "
                               f"by {err:.3e} of max|y|")
        if pads:
            raise RuntimeError(f"D={D}: hi padding rows not 0")
        for k in ("n_reduce_scatter", "reduce_scatter_bytes",
                  "window_bytes"):
            if cnt[k] != model[k]:
                raise RuntimeError(f"D={D}: mesh counted {k} {cnt[k]}, the "
                                   f"traffic model says {model[k]}")
        if D == 1 and n_cw != 0:
            raise RuntimeError(f"D=1 launched {n_cw} crossw instances")
        if D > 1 and not n_cw > 0:
            raise RuntimeError(f"D={D} launched no crossw instance")
        # the parts of one apply, each timed alone on this state
        tables, shards = H._state()
        cfg = H.cfg
        wins, seeds, G, args = _shard_pieces(H, x)
        tail = frozenset(range(len(lay.groups))) - cfg.fused_set

        def t_windows():
            sk._build_crossh_windows_leaves(x.leaves, cfg.moves, mesh)

        def t_seeds():
            for gi in seeds:
                cross = not (gi in cfg.fused_set
                             and cfg.plans[gi].crossh_fusable)
                mesh.reduce_scatter_rows(
                    sk._hi_partial(sh, gi, G[i], tables, lay, spec, cross)
                    for i, sh in enumerate(shards)).wait()

        def t_kernels():
            for (T, seed, srcs, srcsh, w, c, _, _) in args:
                kg.kron_group_apply(T, seed, srcs, srcsh, c, w)

        def t_tails():
            for i, sh in enumerate(shards):
                apply_H_sector_kron(G[i], None, lay, sh["tabs"],
                                    terms="diag,lo,mid,crossl",
                                    group_filter=tail)

        parts = {name: event_ms(fn, reps=10) for name, fn in (
            ("windows", t_windows), ("seeds", t_seeds),
            ("kernels", t_kernels), ("tails", t_tails))}
        del wins, seeds, G, args
        full = event_ms(lambda: H(x), reps=10)
        print(f"shard-apply L={L} D={D}: max|d|/max|y| {err:.3e} (<= 1e-5) "
              f"against the unsharded fused apply, hi padding rows 0 | one "
              f"apply {full:.3f} ms (unsharded {u_ms:.3f} ms) = windows "
              f"{parts['windows']:.3f} + seeds {parts['seeds']:.3f} + "
              f"kernels {parts['kernels']:.3f} + tails {parts['tails']:.3f} "
              f"ms (each timed alone, median of 10) | K1 launches {n_k1}, "
              f"crossw {n_cw} | reduce-scatters {cnt['n_reduce_scatter']} x "
              f"{cnt['reduce_scatter_bytes'] / 2**20:.1f} MiB of partials, "
              f"windows {cnt['window_bytes'] / 2**20:.1f} MiB: equal to "
              f"collective_traffic_model | peak of one apply above the "
              f"state {peak / 2**20:.1f} MiB (a state is "
              f"{4 * spec.n_sharded / 2**20:.1f} MiB)")
        del H, x


def phase_shard_main(L, D, dev, E0_main, S_main):
    """The main path again on LocalMesh(D): returns the K1 crossw launch
    count of the run."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import kron_group as kg

    m = pt.heisenberg_chain(L, nup=L // 2)
    mesh = pt.LocalMesh(D, dev)
    qs = [2 * np.pi * k / L for k in (4, 7, L // 2)]
    omega = np.linspace(0.0, 4.0, 200)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kg.reset_kernel_launch_count()
    (E0, psi, info, lay), t_gs = sync_time(lambda: pt.groundstate_kron(
        m, lanc_m=40, cycles=6, target_residual=1e-3, mesh=mesh))
    (S, kinfo), t_kpm = sync_time(lambda: pt.kpm_sqw_kron(
        m, qs, omega, kpm_m=100, psi0=psi, E0=E0, info=info, mesh=mesh))
    n_k1 = kg.kernel_launch_count()
    n_cw = kg.kernel_launch_count(crossw=True)
    peak = torch.cuda.max_memory_allocated()
    cnt = mesh.counters()
    smax = float(np.abs(S_main).max())
    dS = float(np.abs(S - S_main).max())
    print(f"shard-main L={L} LocalMesh({D}): E0 {E0:.6f} (main {E0_main:.6f}, "
          f"|d| {abs(E0 - E0_main):.2e} <= 1e-4) residual "
          f"{info['residual']:.3e} cycles {info['cycles']} polished "
          f"{info.get('polished', 0)} | ground state {t_gs:.2f} s, KPM (3 q x "
          f"100 moments + 40 bounds steps) {t_kpm:.2f} s | max |S - S_main| "
          f"{dS:.3e} = {dS / smax:.2e} of main's peak (<= 5e-2) | peak "
          f"{peak / 2**30:.2f} GiB | K1 launches {n_k1}, of them crossw "
          f"{n_cw} | reduce-scatters {cnt['n_reduce_scatter']}, window "
          f"exchanges {cnt['n_window_exchange']}, all-reduces "
          f"{cnt['n_all_reduce']}")
    if psi.mesh is not mesh or any(
            l.shape[0] != chp for l, chp in zip(
                psi.leaves, pt.kron_shard_spec(lay, D).ch_pad)):
        raise RuntimeError("the sharded ground state left the sharded form")
    if not info["residual"] <= 1e-3:
        raise RuntimeError(f"sharded residual {info['residual']} > 1e-3")
    if not abs(E0 - E0_main) <= 1e-4:
        raise RuntimeError(f"sharded E0 {E0} off main's {E0_main}")
    if not (np.all(np.isfinite(S)) and S.min() >= -1e-6 * smax
            and dS <= 5e-2 * smax):
        raise RuntimeError(f"sharded S(q, omega) off main's by {dS}")
    if not n_cw > 0:
        raise RuntimeError("the sharded main path launched no crossw "
                           "instance")
    return n_cw


def phase_shard_evolve(L, D, dev, ref):
    """The evolve phase's trajectory on LocalMesh(D), from its bounds
    (`ref`: phase_evolve's info)."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import cheb_term as ct
    from spindynamics_tpu_torch.ops import kron_group as kg
    from spindynamics_tpu_torch.ops.sector_kron import make_sector_kron_layout

    m = _evolve_model(L)
    bits = pt.domain_wall_bitstring(m)
    mesh = pt.LocalMesh(D, dev)
    spec = pt.kron_shard_spec(make_sector_kron_layout(m, m.kron_splits), D)

    def observe(pair, lay):
        return pt.magnetization_per_site_kron_sharded(pair, spec, mesh)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_cw0 = kg.kernel_launch_count(crossw=True)
    n_k20 = ct.kernel_launch_count()
    (pair, obs, info), t_all = sync_time(lambda: pt.evolve_trajectory_kron(
        m, bits, dt=0.1, n_steps=5, cheb_n=40, Ebounds=ref["Ebounds"],
        mesh=mesh, observe=observe))
    n_cw = kg.kernel_launch_count(crossw=True) - n_cw0
    n_k2 = ct.kernel_launch_count() - n_k20
    peak = torch.cuda.max_memory_allocated()
    steps = info["step_seconds"]
    dS = float(np.abs(obs - ref["obs"]).max())
    print(f"shard-evolve L={L} LocalMesh({D}): max |d<Sz_i>| against the "
          f"evolve phase over 5 steps {dS:.2e} (<= 1e-5) | norms "
          f"{[f'{x:.7f}' for x in info['norms']]} | seconds per step median "
          f"{float(np.median(steps)):.3f} (plain terms; the evolve phase's "
          f"K2 step {float(np.median(ref['step_seconds'])):.3f}) | all "
          f"{t_all:.2f} s | peak {peak / 2**30:.2f} GiB | crossw launches "
          f"{n_cw}, K2 launches {n_k2}")
    if pair[0].mesh is not mesh:
        raise RuntimeError("the sharded trajectory left the mesh")
    if not dS <= 1e-5:
        raise RuntimeError(f"sharded <Sz_i> off the evolve phase by {dS}")
    if not np.all(np.abs(info["norms"] - 1.0) <= 1e-4):
        raise RuntimeError(f"sharded norms off 1: {info['norms']}")
    if not (n_cw > 0 and n_k2 == 0):
        raise RuntimeError(f"the sharded trajectory launched crossw {n_cw} "
                           f"and K2 {n_k2} times")


def phase_dist1(L, dev):
    """ProcessMesh over an NCCL group of one rank on the card: one apply
    at L and an L=16 ground state against LocalMesh(1)."""
    import socket

    import spindynamics_tpu_torch as pt
    import torch.distributed as dist
    from spindynamics_tpu_torch.solvers.blockvec import bv_random

    if not (dist.is_available() and dist.is_nccl_available()):
        print("dist-1: torch.distributed has no NCCL here: skipped")
        return
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        pmesh = pt.ProcessMesh()
        m = pt.heisenberg_chain(L, nup=L // 2)
        Hp, lay, spec = pt.sharded_kron_scaling_bv_matvec_fn(m, pmesh,
                                                             device=dev)
        Hl, _, _ = pt.sharded_kron_scaling_bv_matvec_fn(
            m, pt.LocalMesh(1, dev))
        g = torch.Generator(device=dev).manual_seed(5)
        bv = bv_random(lay, g, torch.float32, dev)
        (yp, t_ap) = sync_time(
            lambda: Hp(pt.shard_kron_blockvec(bv, spec, pmesh)))
        yl = Hl(pt.shard_kron_blockvec(bv, spec, Hl.mesh))
        scale = max(float(l.abs().max()) for l in yl.leaves)
        err = max(float((a - b).abs().max())
                  for a, b in zip(yp.leaves, yl.leaves)) / scale
        cnt = pmesh.counters()
        m16 = pt.heisenberg_chain(16, nup=8)
        E_p, _, info_p, _ = pt.groundstate_kron(
            m16, lanc_m=40, cycles=2, target_residual=1e-3, mesh=pmesh,
            device=dev)
        E_l, _, info_l, _ = pt.groundstate_kron(
            m16, lanc_m=40, cycles=2, target_residual=1e-3,
            mesh=pt.LocalMesh(1, dev))
        torch.cuda.synchronize()
        print(f"dist-1: ProcessMesh over NCCL, world size 1, L={L}: one "
              f"apply max|d|/max|y| {err:.3e} (<= 1e-6) against "
              f"LocalMesh(1), first apply {t_ap:.2f} s (NCCL set-up), "
              f"reduce-scatters {cnt['n_reduce_scatter']} x "
              f"{cnt['reduce_scatter_bytes'] / 2**20:.1f} MiB | L=16 ground "
              f"state E0 {E_p:.8f} against {E_l:.8f} (|d| "
              f"{abs(E_p - E_l):.2e} <= 1e-6), residuals "
              f"{info_p['residual']:.2e} / {info_l['residual']:.2e}")
        if not err <= 1e-6:
            raise RuntimeError(f"ProcessMesh apply off LocalMesh(1) by {err}")
        if not abs(E_p - E_l) <= 1e-6:
            raise RuntimeError(f"ProcessMesh E0 {E_p} off LocalMesh(1) {E_l}")
        if not cnt["n_reduce_scatter"] > 0:
            raise RuntimeError("the ProcessMesh apply started no "
                               "reduce-scatter")
    finally:
        dist.destroy_process_group()


def phase_shard_flat(Lc, Lf, D, dev, E0_compact=None, E0_flat=None):
    """The row-sharded flat path on LocalMesh(D) on the card (plain torch
    throughout: the JAX package's shard_map applies are XLA code). Compact
    Lc: the all-gather and halo ELL applies held to the unsharded ell
    apply on the same state (1e-5 of max|y|, pad rows exactly 0), their
    collective bytes to the model (all-gather D (D-1) B 4, halo D (D-1) Hp
    4, no all-gather in the halo apply), ms per apply, set-up seconds; the
    card's halo plan equal to the host's at L=24; a ground state through
    the halo apply (matvec_fn of a model placed by shard_model) within
    1e-4 of compact-main's E0. Embedded Lf: the sharded blocked apply held
    to K3 on the same state (1e-5 of max|y|), ms per apply, exchanges; a
    ground state within 1e-4 of flat-main's E0, with no K3 launch (no
    unsharded fallback). Then the halo apply on a ProcessMesh of one NCCL
    rank against LocalMesh(1). E0 references the phase has not been given
    are solved here, unsharded. Returns the phase's record."""
    import socket

    import spindynamics_tpu_torch as pt
    import torch.distributed as dist
    from spindynamics_tpu_torch.ops import fused_matvec as fm
    from spindynamics_tpu_torch.parallel import sharded_apply as tsa

    rec = {"D": D, "L_compact": Lc, "L_flat": Lf}
    mesh = pt.LocalMesh(D, dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m = _compact_model(Lc)
    N = m.n_states
    ref = pt.matvec_fn(m, device=dev)
    x = _flat_state(m, dev, False, Lc + 1)
    want = ref(x)
    scale = float(want.abs().max())
    ell_ms = event_ms(lambda: ref(x), reps=10)
    if E0_compact is None:
        E0_compact = pt.lanczos_groundstate_restarted(
            ref, N=N, lanc_m=40, cycles=6, target_residual=1e-3,
            generator=torch.Generator(device=dev).manual_seed(0))[0]
    del ref
    torch.cuda.empty_cache()
    xs = pt.shard_state(x, mesh)
    out = {}
    for name, fn in (("all-gather", pt.sharded_matvec_fn),
                     ("halo", pt.sharded_matvec_halo_fn)):
        (mv, pm), t_set = sync_time(lambda: fn(m, mesh))
        B = pm.n_states // D
        mesh.reset_counters()
        y = mv(xs)
        c = mesh.counters()
        err = float((y[:N] - want).abs().max()) / scale
        pad_zero = not bool(y[N:].any())
        ms = event_ms(lambda: mv(xs), reps=10)
        model_bytes = (D * (D - 1) * B * 4 if name == "all-gather"
                       else D * (D - 1) * mv.Hp * 4)
        got_bytes = c["all_gather_bytes"] + c["permute_bytes"]
        table = mv.nbr.numel() * mv.nbr.element_size()
        # the table once, the state and the diagonal read, the result
        # written (compact-main's ell bound); the exchanges on one card
        # are reported beside it
        bound = _bound(table + pm.n_states * 12, 0.0)
        out[name] = {"ms": ms, "setup_s": t_set, "max_rel_err": err,
                     "collective_bytes": got_bytes, "Hp": mv.Hp,
                     "n_all_gather": c["n_all_gather"],
                     "n_permute": c["n_permute"], "bound_ms": bound[0]}
        print(f"shard-flat L={Lc} compact {name} apply on LocalMesh({D}): "
              f"max|d|/max|y| {err:.2e} against the unsharded ell apply "
              f"(<= 1e-5), pad rows zero {pad_zero} | {ms:.3f} ms per apply "
              f"(unsharded ell {ell_ms:.3f} ms; bound {bound[0]:.3f} ms by "
              f"{bound[1]}: table {table} bytes, the state, diagonal and "
              f"result) | collective bytes "
              f"{got_bytes} (model {model_bytes}), all-gathers "
              f"{c['n_all_gather']}, exchanges {c['n_permute']}, Hp "
              f"{mv.Hp} of B {B} | set-up {t_set:.2f} s (the torch build "
              f"of the padded table{', the card halo plan' if mv.Hp else ''})")
        if not (err <= 1e-5 and pad_zero):
            raise RuntimeError(f"sharded {name} apply off the ell apply by "
                               f"{err} (pad rows zero: {pad_zero})")
        if got_bytes != model_bytes:
            raise RuntimeError(f"{name} moved {got_bytes} bytes, the model "
                               f"says {model_bytes}")
        if name == "halo" and c["n_all_gather"]:
            raise RuntimeError("the halo apply all-gathered the state")
        del mv, y
        torch.cuda.empty_cache()
    rec["compact"] = dict(out, ell_ms=ell_ms, N=N)
    # the card's halo plan against the host's, at L=24 (the host's np.unique
    # passes at Lc would dominate the phase)
    pm24 = tsa.pad_model(_compact_model(24), D)
    (_, _, nbr_h), t_tab = sync_time(lambda: pt.model.sector_setup(pm24,
                                                                    "cpu"))
    host, t_host = sync_time(lambda: tsa.build_halo_plan(
        nbr_h.numpy(), pm24.n_states, D))
    nbr_c = pt.model.sector_setup(pm24, dev)[2]
    card, t_card = sync_time(lambda: tsa.build_halo_plan_torch(
        nbr_c, pm24.n_states, D))
    same = card[2] == host[2] and all(
        np.array_equal(a.cpu().numpy(), b) for a, b in zip(card[:2],
                                                            host[:2]))
    print(f"shard-flat L=24 halo plan, D={D}: the card's build equal to the "
          f"host's bit for bit {same} (Hp {host[2]}) | card {t_card:.3f} s, "
          f"host {t_host:.3f} s (the host's table {t_tab:.2f} s)")
    if not same:
        raise RuntimeError("the card's halo plan differs from the host's")
    del nbr_c, card, host, nbr_h
    rec["plan_L24"] = {"card_s": t_card, "host_s": t_host}
    # a ground state through the halo apply, the model placed on the mesh
    m_sh = pt.shard_model(m, mesh)
    mv = pt.matvec_fn(m_sh)
    mesh.reset_counters()
    (E0, psi, info), t_gs = sync_time(
        lambda: pt.lanczos_groundstate_restarted(
            mv, N=m_sh.n_states, lanc_m=40, cycles=6, target_residual=1e-3,
            mask=m_sh.valid_mask(dev),
            generator=torch.Generator(device=dev).manual_seed(0)))
    c = mesh.counters()
    dE = abs(E0 - E0_compact)
    pad_zero = not bool(psi[N:].any())
    print(f"shard-flat L={Lc} compact ground state through the halo apply on "
          f"LocalMesh({D}): E0 {E0:.6f} (unsharded {E0_compact:.6f}, |d| "
          f"{dE:.2e} <= 1e-4) residual {info['residual']:.2e} cycles "
          f"{info['cycles']} | {t_gs:.2f} s, {c['n_permute'] // (D - 1)} "
          f"applies, {c['permute_bytes'] / 2**20:.1f} MiB exchanged | pad "
          f"rows zero {pad_zero}")
    if not (dE <= 1e-4 and info["residual"] <= 1e-3 and pad_zero):
        raise RuntimeError(f"sharded compact E0 {E0} off {E0_compact} by "
                           f"{dE} (residual {info['residual']})")
    rec["compact"].update(ground_state_s=t_gs, E0=E0)
    del mv, psi, x, xs, want
    torch.cuda.empty_cache()
    rec["compact_peak_bytes"] = torch.cuda.max_memory_allocated()
    # embedded Lf: the sharded blocked apply against K3
    torch.cuda.reset_peak_memory_stats()
    me = _flat_model(Lf)
    k3 = pt.matvec_fn(me, device=dev)
    xe = _flat_state(me, dev, False, Lf + 2)
    want = k3(xe)
    scale = float(want.abs().max())
    k3_ms = event_ms(lambda: k3(xe), reps=10)
    if E0_flat is None:
        E0_flat = pt.lanczos_groundstate_restarted(
            k3, N=me.n_states, lanc_m=40, cycles=6, target_residual=1e-3,
            mask=me.valid_mask(dev),
            generator=torch.Generator(device=dev).manual_seed(0))[0]
    del k3
    mvb, t_set = sync_time(lambda: pt.matvec_fn(me, mesh=mesh))
    xse = pt.shard_state(xe, mesh)
    mesh.reset_counters()
    y = mvb(xse)
    c = mesh.counters()
    err = float((y - want).abs().max()) / scale
    ms = event_ms(lambda: mvb(xse), reps=10)
    n_cross = len(mvb.sharded.crossing)
    ex_bytes = n_cross * me.n_states * 4
    print(f"shard-flat L={Lf} embedded sharded blocked apply on "
          f"LocalMesh({D}): max|d|/max|y| {err:.2e} against K3 (<= 1e-5) | "
          f"{ms:.3f} ms per apply (K3 {k3_ms:.3f} ms) | {n_cross} "
          f"shard-crossing bonds, {c['n_permute']} exchanges, "
          f"{c['permute_bytes']} bytes (model {ex_bytes}) | set-up "
          f"{t_set:.2f} s")
    if not err <= 1e-5:
        raise RuntimeError(f"sharded blocked apply off K3 by {err}")
    if (c["n_permute"], c["permute_bytes"]) != (n_cross, ex_bytes):
        raise RuntimeError("the sharded blocked apply's exchanges differ "
                           "from one whole shard per crossing bond")
    del y, xse
    fm.reset_kernel_launch_count()
    (Eb, psib, infob), t_gsb = sync_time(
        lambda: pt.lanczos_groundstate_restarted(
            mvb, N=me.n_states, lanc_m=40, cycles=6, target_residual=1e-3,
            mask=me.valid_mask(dev),
            generator=torch.Generator(device=dev).manual_seed(0)))
    n_k3 = fm.kernel_launch_count()
    dEb = abs(Eb - E0_flat)
    outside = bool(psib[~me.valid_mask(dev)].any())
    peak = torch.cuda.max_memory_allocated()
    print(f"shard-flat L={Lf} embedded ground state through the sharded "
          f"blocked apply: E0 {Eb:.6f} (unsharded K3 {E0_flat:.6f}, |d| "
          f"{dEb:.2e} <= 1e-4) residual {infob['residual']:.2e} cycles "
          f"{infob['cycles']} | {t_gsb:.2f} s | K3 launches {n_k3} (0: no "
          f"unsharded fallback) | weight outside the sector {outside} | peak "
          f"{peak / 2**30:.2f} GiB (compact part "
          f"{rec['compact_peak_bytes'] / 2**30:.2f} GiB)")
    if not (dEb <= 1e-4 and infob["residual"] <= 1e-3) or outside or n_k3:
        raise RuntimeError(f"sharded embedded E0 {Eb} off {E0_flat} by {dEb}"
                           f" (K3 launches {n_k3}, outside {outside})")
    rec["embedded"] = {"ms": ms, "k3_ms": k3_ms, "max_rel_err": err,
                       "crossing_bonds": n_cross, "exchanged_bytes": ex_bytes,
                       "ground_state_s": t_gsb, "E0": Eb, "peak_bytes": peak}
    del mvb, psib, xe, want
    torch.cuda.empty_cache()
    # one NCCL rank: the ProcessMesh form of the halo apply
    if not (dist.is_available() and dist.is_nccl_available()):
        raise RuntimeError("torch.distributed has no NCCL here")
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        pmesh = pt.ProcessMesh()
        x = _flat_state(m, dev, False, Lc + 3)
        yl = pt.sharded_matvec_halo_fn(m, pt.LocalMesh(1, dev))[0](x)
        mvp = pt.sharded_matvec_halo_fn(m, pmesh, device=dev)[0]
        yp, t_p = sync_time(lambda: mvp(pt.shard_state(x, pmesh)))
        mvg = pt.sharded_matvec_fn(m, pmesh, device=dev)[0]
        yg = mvg(pt.shard_state(x, pmesh))
        torch.cuda.synchronize()
        errp = max(float((yp - yl).abs().max()),
                   float((yg - yl).abs().max())) / float(yl.abs().max())
        cnt = pmesh.counters()
        print(f"shard-flat: ProcessMesh over NCCL, world size 1, L={Lc}: the "
              f"halo and all-gather applies against LocalMesh(1) max|d|/"
              f"max|y| {errp:.2e} (<= 1e-6), first apply {t_p:.2f} s | "
              f"all-gathers {cnt['n_all_gather']}")
        if not errp <= 1e-6 or cnt["n_all_gather"] != 1:
            raise RuntimeError(f"ProcessMesh flat applies off LocalMesh(1) "
                               f"by {errp}")
        del mvp, mvg, x, yl, yp, yg
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return rec


# Runs `python -m MODULE ARGS` (runpy's module-as-main, what -m does) and
# reports on stderr, at exit, the kernels' launch counts of that process
# and its peak device memory.
_MODULE_RUNNER = """
import atexit, json, runpy, sys

def _report():
    import torch
    from spindynamics_tpu_torch.ops import cheb_term as ct
    from spindynamics_tpu_torch.ops import dot2 as d2
    from spindynamics_tpu_torch.ops import fused_matvec as fm
    from spindynamics_tpu_torch.ops import kron_group as kg
    f32 = torch.float32
    print("RUN-REPORT " + json.dumps({
        "K1": kg.kernel_launch_count(f32),
        "K1 crossw": kg.kernel_launch_count(f32, crossw=True),
        "K2": ct.kernel_launch_count(f32), "K3": fm.kernel_launch_count(),
        "dot2": d2.dot2_launch_count(),
        "peak": (torch.cuda.max_memory_allocated()
                 if torch.cuda.is_available() else 0)}), file=sys.stderr)

atexit.register(_report)
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""


def _run_module(module, args, timeout=600, all_lines=False):
    """`python -m module args` in its own process, from the root of this
    checkout (where the kernels are already built): (the JSON object of
    its last stdout line, or with `all_lines` the list of every line's,
    the launch counts and peak, wall seconds). A non-zero exit raises."""
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", _MODULE_RUNNER, module,
                          *args], cwd=root, capture_output=True, text=True,
                         timeout=timeout)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"{module} {' '.join(args)} exited "
                           f"{res.returncode}:\n{res.stdout[-2000:]}\n"
                           f"{res.stderr[-4000:]}")
    out = res.stdout.strip().splitlines()
    info = [json.loads(ln) for ln in out] if all_lines else json.loads(out[-1])
    rep = [ln for ln in res.stderr.splitlines()
           if ln.startswith("RUN-REPORT ")]
    return info, json.loads(rep[-1][len("RUN-REPORT "):]), wall


def _run_cli(args, timeout=600):
    """One command of the port's CLI in its own process (_run_module)."""
    return _run_module("spindynamics_tpu_torch.cli", args, timeout)


def phase_cli(L, L_flat, dev, refs):
    """The port's command line, every command in its own process
    through the kernels already built, at full width: sector_kron at L
    (auto: K1 ground state and KPM S(q, omega), K2 trajectory), embedded
    at L_flat and L=20 (K3), sector_kron with --mesh 4 at L=24 (K1's
    crossw variant) and sector_blocked at L. `refs`: E0 of the main and
    flat-main phases, the evolve phase's <Sz_i>. Each command is held by
    its exit code, its JSON line, its .npz and the launches of the kernels
    its path runs. Returns the commands' records."""
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.empty_cache()  # the commands' memory is their own
    Ls, Lf = str(L), str(L_flat)
    cmds = [
        ("groundstate", ["groundstate", "--L", Ls, "--sz0", "--lanc-m",
                         "40", "--cycles", "6"], "K1"),
        ("sqw-kpm", ["sqw", "--method", "kpm", "--L", Ls, "--sz0",
                     "--kpm-m", "10", "--lanc-m", "40", "--out",
                     str(out_dir / "sqw.npz")], "K1"),
        ("evolve", ["evolve", "--L", Ls, "--sz0", "--jz", "0.5", "--t-max",
                    "0.5", "--steps", "5", "--cheb-n", "40", "--out",
                    str(out_dir / "evolve.npz")], "K2"),
        ("groundstate-embedded", ["groundstate", "--L", Lf, "--sz0", "--jz",
                                  "0.5", "--layout", "embedded"], "K3"),
        ("typicality", ["typicality", "--L", "20", "--sz0", "--beta", "1",
                        "--n-t", "3", "--out",
                        str(out_dir / "typicality.npz")], "K3"),
        ("groundstate-mesh", ["groundstate", "--L", "24", "--sz0",
                              "--layout", "sector_kron", "--twopass",
                              "--lanc-m", "40", "--mesh", "4"], "K1 crossw"),
        ("groundstate-nomesh", ["groundstate", "--L", "24", "--sz0",
                                "--layout", "sector_kron", "--twopass",
                                "--lanc-m", "40"], "K1"),
        ("sqw-lanczos", ["sqw", "--method", "lanczos", "--L", "20", "--sz0",
                         "--lanc-m", "40", "--out",
                         str(out_dir / "sqw20.npz")], "K3"),
        ("groundstate-sector_blocked", ["groundstate", "--L", Ls, "--sz0",
                                        "--layout", "sector_blocked"], None),
    ]
    recs, infos = [], {}
    for name, args, kernel in cmds:
        info, rep, wall = _run_cli(args)
        infos[name] = info
        n = rep[kernel] if kernel else 0
        print(f"cli {name}: {' '.join(args[:-2] if '--out' in args else args)}"
              f" | mode {info['mode']} | wall {wall:.2f} s (build "
              f"{info['build_s']} s, solve {info.get('solve_s')} s) | peak "
              f"{rep['peak'] / 2**30:.2f} GiB | launches K1 {rep['K1']} "
              f"(crossw {rep['K1 crossw']}), K2 {rep['K2']}, K3 {rep['K3']}, "
              f"dot2 {rep['dot2']}")
        recs.append({"name": name, "args": args, "wall_s": wall,
                     "solve_s": info.get("solve_s"),
                     "build_s": info["build_s"], "peak_bytes": rep["peak"],
                     "launches": {k: rep[k] for k in ("K1", "K1 crossw",
                                                      "K2", "K3", "dot2")}})
        if kernel and not n > 0:
            raise RuntimeError(f"cli {name} launched {kernel} no time")
        if name == "groundstate-sector_blocked" and any(
                rep[k] for k in ("K1", "K2", "K3")):
            raise RuntimeError("the sector_blocked command launched a kernel")
    E0_main, E0_flat, obs_evolve = refs
    want_mode = {"groundstate": "sector_kron", "sqw-kpm": "sector_kron",
                 "evolve": "sector_kron", "groundstate-embedded": "embedded",
                 "typicality": "embedded", "sqw-lanczos": "embedded",
                 "groundstate-sector_blocked": "sector_blocked"}
    for name, mode in want_mode.items():
        if infos[name]["mode"] != mode:
            raise RuntimeError(f"cli {name} ran mode {infos[name]['mode']}")
    checks = []

    def check(what, ok):
        checks.append(f"{what} {'ok' if ok else 'FAILED'}")
        if not ok:
            print("cli: " + " | ".join(checks))
            raise RuntimeError(f"cli: {what}")

    for name, ref in (("groundstate", E0_main),
                      ("groundstate-embedded", E0_flat),
                      ("groundstate-sector_blocked", E0_main),
                      ("groundstate-mesh",
                       infos["groundstate-nomesh"]["E0"])):
        d = abs(infos[name]["E0"] - ref)
        check(f"{name} E0 {infos[name]['E0']:.6f} against {ref:.6f} "
              f"|d| {d:.2e} <= 1e-4", d <= 1e-4)
    for name, path, shape in (("sqw-kpm", "sqw.npz", (L, 200)),
                              ("sqw-lanczos", "sqw20.npz", (20, 200))):
        S = np.load(out_dir / path)["S"]
        smax = float(np.abs(S).max())
        check(f"{name} S {S.shape} finite, >= -1e-6 max", S.shape == shape
              and bool(np.all(np.isfinite(S))) and smax > 0
              and float(S.min()) >= -1e-6 * smax)
    ev = np.load(out_dir / "evolve.npz")
    d = float(np.abs(ev["magnetization"] - obs_evolve).max())
    nrm = infos["evolve"]["final_norm"]
    check(f"evolve <Sz_i> against the evolve phase |d| {d:.2e} <= 1e-5, "
          f"norm {nrm:.7f}, psi {ev['psi'].shape}",
          d <= 1e-5 and abs(nrm - 1) <= 1e-4 and ev["psi"].shape[0] == 2)
    C = np.load(out_dir / "typicality.npz")["C"]
    check(f"typicality C {np.round(C, 5).tolist()} finite, C(0) = 1/4 "
          f"(Sz_0^2) to 1e-5", bool(np.all(np.isfinite(C)))
          and abs(C[0] - 0.25) <= 1e-5)
    print("cli: " + " | ".join(checks))
    for f in out_dir.iterdir():
        f.unlink()
    out_dir.rmdir()
    return recs


# docs/PARITY.md: the JAX package's recorded results of its examples and
# scripts on the TPU (energies, a spectral peak, correlations; no times)
EX_E0 = {16: -11.670774, 24: -17.664925, 28: -20.663187}  # PARITY.md:77-79
EX_E0_PER_SITE_32 = -0.739433                              # PARITY.md:106
EX_SMAX_28 = 21.30                     # PARITY.md:129 (reported, not held)
EX_C_28 = {0.4: 0.1444 - 0.1398j, 0.8: -0.0275 - 0.1120j,  # PARITY.md:329
           1.2: -0.0695 - 0.0003j, 1.6: -0.0112 + 0.0385j}


def _example_main(module, argv):
    """module.main(argv) in this process on the card, K1's and K2's
    counts set to 0 just before it and read just after: (its result, its
    stage lines, wall s, peak bytes, launches)."""
    import contextlib
    import io

    from spindynamics_tpu_torch.ops import cheb_term as ct
    from spindynamics_tpu_torch.ops import kron_group as kg

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kg.reset_kernel_launch_count()
    ct.reset_kernel_launch_count()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = module.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"K1": kg.kernel_launch_count(torch.float32),
                "K2": ct.kernel_launch_count(torch.float32)}
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    return res, lines, wall, torch.cuda.max_memory_allocated(), launches


def phase_examples(dev, E0_main, full=False):
    """The port's examples (spindynamics_tpu_torch/examples/) as a user runs
    them, on the card: each module's main(argv) in this process, and
    example_large_L as a `python -m` process, held to the JAX package's
    recorded results (docs/PARITY.md, examples/example_kron_evolve_L*.npz)
    and, for the flat modules, to the same module on the CPU. A kron
    example that launches no K1, or a trajectory or typicality run that
    launches no K2, fails the phase. `full` adds the published depth: the
    60-step L=28 and 40-step L=30 trajectories and the L=32 ground state.
    Returns the examples' records."""
    from spindynamics_tpu_torch.examples import (
        example, example_kpm, example_kpm_dos, example_kpm_sqw,
        example_kron_corr, example_kron_evolve, example_kron_lanczos_sqw,
        example_kron_sqw, example_kron_typicality, example_lanczos_sqw,
        gs_ladder, l32_groundstate)

    root = Path(__file__).resolve().parent
    out_dir = root / "build" / "chip_smoke_examples"
    od = ["--out-dir", str(out_dir)]
    cpu = dict(device="cpu", dtype=torch.float64)
    recs = []

    def record(name, argv, wall, peak, launches, checks, kernels):
        print(f"examples {name} {' '.join(argv)} | wall {wall:.2f} s | peak "
              f"{peak / 2**30:.2f} GiB | K1 {launches['K1']} K2 "
              f"{launches['K2']} | " + " | ".join(checks))
        recs.append({"name": name, "argv": argv, "wall_s": wall,
                     "peak_bytes": peak, "launches": launches,
                     "checks": checks})
        for k in kernels:
            if not launches[k] > 0:
                raise RuntimeError(f"examples {name} launched {k} no time")

    def checker(name):
        checks = []

        def check(what, ok):
            checks.append(f"{what} {'ok' if ok else 'FAILED'}")
            if not ok:
                print(f"examples {name}: " + " | ".join(checks))
                raise RuntimeError(f"examples {name}: {what}")
        return checks, check

    def close(x, ref, tol, what):
        return f"{what} {x:.6f} against {ref:.6f} |d| {abs(x - ref):.2e} " \
               f"<= {tol:g}", abs(x - ref) <= tol

    torch.cuda.empty_cache()  # the subprocess's memory is its own
    # 1: the way a user types it, in its own process
    argv = ["24"] + od
    info, rep, wall = _run_module(
        "spindynamics_tpu_torch.examples.example_large_L", argv)
    checks, check = checker("example_large_L")
    check(*close(info["E0"], EX_E0[24], 1e-4, "E0"))
    record("example_large_L", argv, wall, rep["peak"],
           {"K1": rep["K1"], "K2": rep["K2"]}, checks, ["K1"])

    # 2
    argv = ["16", "24"] + od
    res, lines, wall, peak, n = _example_main(gs_ladder, argv)
    checks, check = checker("gs_ladder")
    for L in (16, 24):
        check(*close(res[L]["E0"], EX_E0[L], 1e-4, f"L={L} E0"))
        check(f"L={L} residual {res[L]['residual']:.2e} <= 1e-3",
              res[L]["residual"] <= 1e-3)
    record("gs_ladder", argv, wall, peak, n, checks, ["K1"])

    # 4
    argv = ["28", "100", "8"] + od
    res, lines, wall, peak, n = _example_main(example_kron_sqw, argv)
    checks, check = checker("example_kron_sqw")
    check(*close(res["E0"], EX_E0[28], 1e-4, "E0"))
    check(*close(res["E0"], E0_main, 1e-4, "E0 against main's"))
    S = res["S"]
    smax = float(S.max())
    check(f"S {S.shape} finite, >= -1e-6 max", S.shape == (8, 100)
          and bool(np.isfinite(S).all()) and S.min() >= -1e-6 * smax)
    # phi_q is normalized and the Jackson kernel keeps mu_0, so each row
    # integrates to a over the whole rescaled spectrum; omega in [0, 4]
    # above E0 holds 95.6-99.9% of it at these q
    a = (res["bounds"][1] - res["bounds"][0]) / 2
    w = np.trapezoid(S, res["omega"], axis=1) / a
    check(f"each row's weight on [0, 4] / a in [0.9, 1.01]: "
          f"{np.round(w, 4).tolist()}",
          bool(np.all(w >= 0.9) and np.all(w <= 1.01)))
    # recorded on the TPU, not held: that run's peak per q (read off its
    # examples/example_kron_sqw_L28.png) is 2.5-3x below these at k = 1, 2
    # and not monotone in q, where its peak positions agree with these;
    # the JAX package's code at the recording commit and now give the same
    # S on the CPU (PERF.md, section 6)
    checks.append(f"S_max {smax:.4f} against the TPU record {EX_SMAX_28}: "
                  f"{abs(smax - EX_SMAX_28) / EX_SMAX_28:.1%} (not held)")
    record("example_kron_sqw", argv, wall, peak, n, checks, ["K1"])

    # 5: the port's default plane_mode "pair"; depth cut to nq 2
    argv = ["28", "100", "2"] + od
    res, lines, wall, peak, n = _example_main(example_kron_lanczos_sqw, argv)
    checks, check = checker("example_kron_lanczos_sqw")
    check(*close(res["E0"], EX_E0[28], 1e-4, "E0"))
    check(*close(res["E0"], E0_main, 1e-4, "E0 against main's"))
    S = res["S"]
    smax = float(S.max())
    check(f"S {S.shape} finite, every row >= -1e-6 max, max {smax:.4f}",
          S.shape == (2, 100) and bool(np.isfinite(S).all()) and smax > 0
          and S.min() >= -1e-6 * smax)
    record("example_kron_lanczos_sqw", argv, wall, peak, n, checks, ["K1"])

    # 6: 20 of the 60 steps (all of them with `full`), and L=30 x 40
    runs = [("28", "60" if full else "20")] + ([("30", "40")] if full else [])
    for L, steps in runs:
        argv = [L, steps] + od
        res, lines, wall, peak, n = _example_main(example_kron_evolve, argv)
        checks, check = checker(f"example_kron_evolve L={L}")
        ref = np.load(root / "examples" / f"example_kron_evolve_L{L}.npz")
        mag, norms = res["magnetization"], res["norms"]
        k = mag.shape[0]
        d = float(np.abs(mag - ref["magnetization"][:k]).max())
        check(f"<Sz_i> {mag.shape} against the JAX run's first {k} rows "
              f"|d| {d:.2e} <= 1e-4", d <= 1e-4)
        dn = float(np.abs(norms - 1).max())
        check(f"|norm - 1| {dn:.2e} <= 1e-5", dn <= 1e-5)
        ds = float(np.abs(mag.sum(axis=1)).max())
        check(f"|sum_i <Sz_i>| {ds:.2e} <= 1e-5", ds <= 1e-5)
        record(f"example_kron_evolve L={L}", argv, wall, peak, n, checks,
               ["K1", "K2"])

    # 7
    argv = ["28"] + od
    res, lines, wall, peak, n = _example_main(example_kron_typicality, argv)
    checks, check = checker("example_kron_typicality")
    C, ts = res["C"], res["t"]
    check(f"the script's checks ({lines[-1]})", lines[-1] == {
        "stage": "checks", "ok": True})
    check(*close(float(C[0].real), 0.25, 1e-5, "C(0)"))
    for t, ref in EX_C_28.items():
        c = C[int(np.argmin(np.abs(ts - t)))]
        check(f"C({t}) {c.real:.4f}{c.imag:+.4f}i against "
              f"{ref.real:.4f}{ref.imag:+.4f}i |d| {abs(c - ref):.2e} "
              f"<= 1e-2", abs(c - ref) <= 1e-2)
    record("example_kron_typicality", argv, wall, peak, n, checks,
           ["K1", "K2"])

    # 8
    argv = ["24"] + od
    res, lines, wall, peak, n = _example_main(example_kron_corr, argv)
    checks, check = checker("example_kron_corr")
    check(*close(res["E0"], EX_E0[24], 1e-4, "E0"))
    C, sites = res["C"], res["sites"]
    diag = np.stack([C[j, k] for k, j in enumerate(sites)])
    check(f"C {C.shape} finite, diagonal >= 0", C.shape == (24, 6, 120)
          and bool(np.isfinite(C).all()) and diag.min() >= 0
          and diag.max() > 0)
    record("example_kron_corr", argv, wall, peak, n, checks, ["K1"])

    # 9-13: the compact layout (plain torch), held to the CPU
    argv = od
    res, lines, wall, peak, n = _example_main(example, argv)
    checks, check = checker("example")
    fc, fk = float(res["fid_cheb"][-1]), float(res["fid_kry"][-1])
    check(f"final fidelities {fc:.8f} {fk:.8f} >= 1 - 1e-4",
          min(fc, fk) >= 1 - 1e-4)
    ref = example.run(device="cpu", dtype=torch.float32)
    d = max(float(np.abs(res[k] - ref[k]).max())
            for k in ("mags_cheb", "mags_kry"))
    check(f"<Sz_i> against the CPU's |d| {d:.2e} <= 1e-5", d <= 1e-5)
    record("example", argv, wall, peak, n, checks, [])

    res, lines, wall, peak, n = _example_main(example_kpm, argv)
    checks, check = checker("example_kpm")
    d = abs(res["eigsh"][0] - res["E0"])
    check(f"the script's asserts in float32: eigsh E0 |d| {d:.2e} < 1e-6 "
          f"max(1, |E0|), Emax {res['eigsh'][1]:.6f} <= bound "
          f"{res['Ebounds'][1]:.6f} + 1e-8",
          d < 1e-6 * max(1.0, abs(res["E0"]))
          and res["eigsh"][1] <= res["Ebounds"][1] + 1e-8)
    record("example_kpm", argv, wall, peak, n, checks, [])

    res, lines, wall, peak, n = _example_main(example_kpm_dos, argv)
    checks, check = checker("example_kpm_dos")
    for key in ("integral_kpm", "integral_lanc"):
        check(f"{key} {res[key]:.6f} within 2e-2 of 1",
              abs(res[key] - 1) <= 2e-2)
    ref = example_kpm_dos.run(**cpu)
    check(f"KS {res['ks']:.6f} against the CPU's {ref['ks']:.6f} |d| "
          f"{abs(res['ks'] - ref['ks']):.2e} <= 1e-3",
          abs(res["ks"] - ref["ks"]) <= 1e-3)
    record("example_kpm_dos", argv, wall, peak, n, checks, [])

    res, lines, wall, peak, n = _example_main(example_kpm_sqw, argv)
    checks, check = checker("example_kpm_sqw")
    ref = example_kpm_sqw.run(nq=4, **cpu)
    S = res["S"]
    d = float(np.abs(S[:4] - ref["S"]).max()) / float(ref["S"].max())
    check(f"S {S.shape} finite; its first 4 q against the CPU's float64 "
          f"|d| {d:.2e} of max <= 1e-4", S.shape == (20, 50)
          and bool(np.isfinite(S).all()) and d <= 1e-4)
    record("example_kpm_sqw", argv, wall, peak, n, checks, [])

    res, lines, wall, peak, n = _example_main(example_lanczos_sqw, argv)
    checks, check = checker("example_lanczos_sqw")
    ref = example_lanczos_sqw.run(**cpu)
    check(f"S {res['S'].shape} finite", bool(np.isfinite(res["S"]).all()))
    check(*close(res["E0"], ref["E0"], 1e-5, "E0 against the CPU's"))
    record("example_lanczos_sqw", argv, wall, peak, n, checks, [])

    if full:  # 3
        argv = od
        res, lines, wall, peak, n = _example_main(l32_groundstate, argv)
        checks, check = checker("l32_groundstate")
        check(*close(res["E0_per_site"], EX_E0_PER_SITE_32, 1e-5, "E0/L"))
        check(f"residual {res['residual']:.2e} <= 1e-3",
              res["residual"] <= 1e-3)
        record("l32_groundstate", argv, wall, peak, n, checks, ["K1"])

    for f in out_dir.iterdir():
        f.unlink()
    out_dir.rmdir()
    return recs


BENCH_NAMES = (  # bench.py's headline and default matrix, in order
    "spmv_nnz_per_s_L32_Sz0_sector_kron", "spmv_nnz_per_s_L28_Sz0_sector_kron",
    "spmv_nnz_per_s_L26_Sz0_embedded_pallas",
    "spmv_nnz_per_s_L32_Sz0_sector_kron_bf16",
    "spmv_nnz_per_s_L32_Sz0_shardmap_d1_kron", "evolve_step_s_L28_Sz0_kron",
    "evolve_step_s_L28_Sz0_kron_bf16")


def phase_bench():
    """The port's bench as a user runs it, each in its own process:
    `python -m spindynamics_tpu_torch.bench --time-budget 300` (the
    default headline and matrix), `scripts.bench_kron 24` and
    `scripts.mxu_calibrate --bf16`. Held: the headline first and the
    combined line last, with bench.py's seven names in order and no point
    skipped; every vs_baseline in (0, 1.05]; the card's name in every
    line; K1, K2 and K3 launched by the bench and K1's crossw variant not;
    the calibration's rates finite and positive and its float32 products
    within 1e-5 of float64. Returns the records."""
    torch.cuda.empty_cache()  # the processes' memory is their own
    name = torch.cuda.get_device_name(0)
    lines, rep, wall = _run_module("spindynamics_tpu_torch.bench",
                                   ["--time-budget", "300"], timeout=900,
                                   all_lines=True)
    points, last = lines[:-1], lines[-1]
    got = [ln.get("metric") for ln in points]
    if got != list(BENCH_NAMES) or any("skipped" in ln for ln in lines):
        raise RuntimeError(f"bench: lines {got}, not bench.py's names "
                           f"{list(BENCH_NAMES)}")
    if (last.get("metric") != BENCH_NAMES[0] or [
            m["metric"] for m in last.get("matrix", [])] != got[1:]):
        raise RuntimeError("bench: the last line is not the headline with "
                           "the matrix")
    for ln in points:
        t = f"{ln['ms']:.3f} ms" if "ms" in ln else f"{ln['s']:.4f} s"
        print(f"bench {ln['metric']}: {ln['value']:.6g} {ln['unit']}, {t} | "
              f"bound {ln['bound_ms']:.3f} ms by {ln['bound_by']}, "
              f"vs_baseline {ln['vs_baseline']:.4f} | peak "
              f"{ln['peak_gib']:.2f} GiB | check {ln['check_ratio']:.3f} of "
              f"its limit | launches {ln['launches']}")
        if not 0.0 < ln["vs_baseline"] <= 1.05:
            raise RuntimeError(f"bench {ln['metric']}: vs_baseline "
                               f"{ln['vs_baseline']} outside (0, 1.05]")
        if ln["device"]["name"] != name:
            raise RuntimeError(f"bench {ln['metric']}: device {ln['device']}")
    if not (rep["K1"] > 0 and rep["K2"] > 0 and rep["K3"] > 0
            and rep["K1 crossw"] == 0):
        raise RuntimeError(f"bench: launches {rep}")
    kron, _, wall_k = _run_module("spindynamics_tpu_torch.scripts.bench_kron",
                                  ["24"])
    cal, _, wall_c = _run_module(
        "spindynamics_tpu_torch.scripts.mxu_calibrate", ["--bf16"])
    rates = cal["calibration"]
    print(f"bench: the bench {wall:.1f} s (launches {rep}, peak "
          f"{rep['peak'] / 2**30:.2f} GiB) | bench_kron 24 {wall_k:.1f} s: "
          f"kron {kron['kron_ms']:.3f} ms, sector_blocked "
          f"{kron['blocked_ms']:.3f} ms ({kron['kron_speedup']:.2f}x) | "
          f"mxu_calibrate {wall_c:.1f} s: TFLOP/s " + ", ".join(
              f"{m} {rates[m]:.1f} (data sheet {s})"
              for m, s in cal["data_sheet"]["tflops"].items())
          + f"; copy {rates['copy_tb_per_s']:.3f} TB/s (data sheet "
          f"{cal['data_sheet']['tb_per_s']})")
    if not (all(np.isfinite(v) and v > 0 for v in rates.values())
            and cal["rel_err"]["highest"] <= 1e-5):
        raise RuntimeError(f"mxu_calibrate: rates {rates}, relative errors "
                           f"{cal['rel_err']}")
    if kron["device"]["name"] != name or cal["device"]["name"] != name:
        raise RuntimeError("bench_kron / mxu_calibrate: another device")
    return {"bench": points, "wall_s": wall, "launches": rep,
            "bench_kron": dict(kron, wall_s=wall_k),
            "mxu_calibrate": dict(cal, wall_s=wall_c)}


def _device_busy(fn):
    """(ms of device activity, device events) of one call of fn(), from
    torch.profiler's CUDA events: what the card did of the call's time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3, len(ev)


def phase_sector_blocked(L, dev, E0_main):
    """The sector_blocked layout at L: the Heisenberg chain of `main`,
    float32. The torch build on the card against the host build (states
    and diagonal bit for bit), the apply against `ell` on the compact model
    of the same couplings (through the permutation of the two orders) on
    random float32 and complex64 states (1e-5 of max|y|), its time in turns
    with `ell` and a torch sparse CSR product beside its bytes bound, and a
    restarted ground state held to main's kron E0 (1e-4). Returns its
    record (plain torch: no kernel)."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.model import sector_setup

    m = pt.heisenberg_chain(L, nup=L // 2, layout="sector_blocked")
    N = m.n_states
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (s_d, d_d, _), t_dev = sync_time(lambda: sector_setup(m, dev))
    t0 = time.perf_counter()
    s_h, d_h, _ = sector_setup(m, "cpu")
    t_host = time.perf_counter() - t0
    same = torch.equal(s_d.cpu(), s_h) and torch.equal(d_d.cpu(), d_h)
    del s_d, d_d, s_h, d_h
    if not same:
        raise RuntimeError("sector_blocked: the card's build differs from "
                           "the host build")
    mv, t_build = sync_time(lambda: pt.matvec_fn(m, device=dev))
    table_bytes = sum(b.numel() * b.element_size()
                      for n, b in mv.named_buffers() if n.startswith("sb_"))
    rec = {"L": L, "N": N, "Ll": m.lo_bits, "groups": len(mv.layout.groups),
           "hi_bonds": len(mv.layout.hi_tables[mv.layout.groups[0][0]]),
           "torch_build_s": t_dev, "host_build_s": t_host,
           "module_build_s": t_build, "table_bytes": table_bytes}
    mc = pt.heisenberg_chain(L, nup=L // 2, layout="compact")
    ell = pt.matvec_fn(mc, device=dev)
    perm = torch.searchsorted(ell.states, mv.states)  # blocked -> ascending
    H = csr_from_ell(ell)
    for cplx in (False, True):
        x = _flat_state(m, dev, cplx, L)
        xc = torch.empty_like(x)
        xc[perm] = x
        y, yc = mv(x), ell(xc)
        err = float((y - yc[perm]).abs().max()) / float(yc.abs().max())
        tag = "complex" if cplx else "real"
        if not err <= 1e-5:
            raise RuntimeError(f"sector_blocked {tag} apply off ell by {err}")
        sb_ms, ell_ms, csr_ms = [], [], []
        for _ in range(2):  # in turns
            sb_ms.append(event_ms(lambda: mv(x), reps=10))
            ell_ms.append(event_ms(lambda: ell(xc), reps=10))
            if not cplx:
                csr_ms.append(event_ms(lambda: H @ xc, reps=10))
        comp = 8 if cplx else 4
        nb = table_bytes + N * (2 * comp + 4)  # state, result, diagonal
        bound = _bound(nb, 0.0)
        busy, n_ev = _device_busy(lambda: mv(x))
        rec[tag] = {"ms": sb_ms, "ell_ms": ell_ms, "bound_ms": bound[0],
                    "bound_by": bound[1], "max_rel_err": err,
                    "device_busy_ms": busy, "device_events": n_ev}
        if csr_ms:
            rec["csr_ms"] = csr_ms
        print(f"sector-blocked L={L} apply {tag}: {sb_ms} ms (medians of "
              f"10, two turns) | ell {ell_ms} ms"
              + (f" | CSR H @ psi {csr_ms} ms" if csr_ms else "")
              + f" | bound {bound[0]:.3f} ms by {bound[1]} ({nb / 1e9:.3f} "
              f"GB) | profiled apply: device busy {busy:.3f} ms in {n_ev} "
              f"device events | against ell max|d|/max|y| {err:.2e} "
              f"(<= 1e-5)")
        del x, xc, y, yc
    del H, ell, perm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _EllApplies("sector_blocked") as n_gs:
        (E0, psi, info), t_gs = sync_time(
            lambda: pt.lanczos_groundstate_restarted(
                mv, N=N, lanc_m=40, cycles=6, target_residual=1e-3,
                generator=torch.Generator(device=dev).manual_seed(0)))
    peak = torch.cuda.max_memory_allocated()
    del psi
    dE = abs(E0 - E0_main)
    rec.update(E0=E0, ground_state_s=t_gs, applies=n_gs.n, peak_bytes=peak)
    print(f"sector-blocked L={L}: Ll {m.lo_bits}, {rec['groups']} groups, "
          f"{rec['hi_bonds']} hi bonds per group, tables "
          f"{table_bytes / 2**20:.1f} MiB | builds: card {t_dev:.2f} s, "
          f"host {t_host:.2f} s (equal bit for bit), module {t_build:.2f} s"
          f" | ground state E0 {E0:.6f} (kron {E0_main:.6f}, |d| "
          f"{dE:.2e} <= 1e-4) residual {info['residual']:.3e} cycles "
          f"{info['cycles']} {t_gs:.2f} s ({n_gs.n} applies) | peak "
          f"{peak / 2**30:.2f} GiB")
    if not (info["residual"] <= 1e-3 and dE <= 1e-4):
        raise RuntimeError(f"sector_blocked E0 {E0} off kron {E0_main}")
    return rec


def phase_oracle(dev):
    import spindynamics_tpu_torch as pt

    m = pt.heisenberg_chain(16, nup=8)
    (E0, psi, info, lay), dt = sync_time(lambda: pt.groundstate_kron(
        m, lanc_m=40, cycles=6, target_residual=1e-3, device=dev))
    err = abs(E0 - E0_REF[16])
    print(f"oracle L=16: E0 {E0:.8f} (ref {E0_REF[16]}, |d| {err:.2e} <= "
          f"2e-4) residual {info['residual']:.2e} cycles {info['cycles']} "
          f"{dt:.2f} s")
    if not err <= 2e-4:
        raise RuntimeError(f"L=16 E0 {E0} off the oracle by {err}")


def phase_main(L, dev):
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.ops import dot2 as d2
    from spindynamics_tpu_torch.ops import kron_group as kg

    m = pt.heisenberg_chain(L, nup=L // 2)
    qs = [2 * np.pi * k / L for k in (4, 7, L // 2)]
    omega = np.linspace(0.0, 4.0, 200)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kg.reset_kernel_launch_count()
    d2.reset_dot2_launch_count()
    (E0, psi, info, lay), t_gs = sync_time(lambda: pt.groundstate_kron(
        m, lanc_m=40, cycles=6, target_residual=1e-3, device=dev))
    n_gs = kg.kernel_launch_count()
    (S, kinfo), t_kpm = sync_time(lambda: pt.kpm_sqw_kron(
        m, qs, omega, kpm_m=100, psi0=psi, E0=E0, info=info, device=dev))
    launches = kg.kernel_launch_count()
    n_dot2 = d2.dot2_launch_count()
    peak = torch.cuda.max_memory_allocated()
    print(f"main L={L} splits={lay.splits} N={lay.n_basis} padded "
          f"{lay.n_states}: E0 {E0:.6f} E0/L {E0 / L:.6f} residual "
          f"{info['residual']:.3e} cycles {info['cycles']} polished "
          f"{info.get('polished', 0)} | ground state {t_gs:.2f} s, KPM "
          f"(3 q x 100 moments + 40 bounds steps) {t_kpm:.2f} s | peak "
          f"{peak / 2**30:.2f} GiB | K1 launches {launches} "
          f"(ground state {n_gs}) | dot2 launches {n_dot2}")
    if not info["residual"] <= 1e-3:
        raise RuntimeError(f"residual {info['residual']} > 1e-3")
    if L in E0_REF and not abs(E0 - E0_REF[L]) <= 1e-3:
        raise RuntimeError(f"E0 {E0} off the reference {E0_REF[L]}")
    if not launches > 0:
        raise RuntimeError("the main path launched K1 no time")
    if not n_dot2 > 0:
        raise RuntimeError("the main path launched dot2 no time")
    smax = float(np.abs(S).max())
    if not (np.all(np.isfinite(S)) and smax > 0
            and S.min() >= -1e-6 * smax):
        raise RuntimeError("S(q, omega) not finite and non-negative")
    print(f"sqw L={L}: shape {S.shape}, max {smax:.4f}, peak omega per q "
          f"{[float(omega[i]) for i in S.argmax(axis=1)]}, "
          f"bounds {tuple(round(b, 4) for b in kinfo['bounds'])}")
    return launches, psi, E0, kinfo, S, n_dot2


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
    """Kernel-time tables of one fused Chebyshev term (seeds + K2 + tail) at
    the trajectory's bounds, float32 and bfloat16 states, and the launches
    of each (the cudaLaunchKernel calls the profiler sees, K2's included):
    a bfloat16 term should make no more than a float32 one."""
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
    c_ri, (a_inv, b) = ke._coeff_arrays(chebyshev_coefficients(
        0.1, info["Ebounds"][0], info["Ebounds"][1], 40))
    scal = (a_inv, b, float(c_ri[2, 0]), float(c_ri[2, 1]))
    fused = kg.fused_group_set(lay, planes.cheb_top_k)
    counts = {}
    for sdt in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(1)
        prev, curr = ((bv_random(lay, g, sdt, dev),
                       bv_random(lay, g, sdt, dev)) for _ in range(2))
        acc = (bv_random(lay, g, torch.float32, dev),
               bv_random(lay, g, torch.float32, dev))

        def term():
            # a term of the scan from its second on: written over prev
            return ct.cheb_term_fused(lay, H.tables, H.calls, fused, prev,
                                      curr, acc, scal, reuse_prev=True)

        term()  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            term()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        counts[sdt] = sum(e.count for e in ka if "LaunchKernel" in e.key)
        # wall time per term without the profiler: 10 terms, one sync
        _, t10 = sync_time(lambda: [term() for _ in range(10)])
        name = "float32" if sdt == torch.float32 else "bfloat16"
        print(f"profile (one fused Chebyshev term, {name} states, L={L}, "
              f"{len(fused)} of {len(lay.groups)} groups through K2): "
              f"{counts[sdt]} kernel launches, {t10 * 100:.2f} ms per term "
              f"(wall, 10 terms)\n"
              + ka.table(sort_by="cuda_time_total", row_limit=15))
        del prev, curr, acc
        torch.cuda.empty_cache()
    n32, n16 = counts[torch.float32], counts[torch.bfloat16]
    print(f"profile L={L}: kernel launches per fused term float32 {n32}, "
          f"bfloat16 {n16} ({n16 - n32:+d})")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--L", type=int, default=28)
    ap.add_argument("--L-flat", type=int, default=26, dest="L_flat")
    ap.add_argument("--L-compact", type=int, default=28, dest="L_compact")
    ap.add_argument("--shards", type=int, default=4,
                    help="D of the --L k1-crossw, shard-main and "
                         "shard-evolve phases (>= 2)")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--k3-tiles", action="store_true", dest="k3_tiles")
    ap.add_argument("--kron-tiles", action="store_true", dest="kron_tiles")
    ap.add_argument("--examples-full", action="store_true",
                    dest="examples_full",
                    help="the examples at published depth: all 60 steps "
                         "of the L=28 trajectory, L=30 x 40 steps, the L=32 "
                         "ground state")
    ap.add_argument("--k3-against", default=None, dest="k3_against",
                    metavar="DIR")
    ap.add_argument("--shard-flat", action="store_true", dest="shard_flat",
                    help="build the kernels and run the shard-flat phase "
                         "alone (its E0 references solved unsharded); no "
                         "result line")
    ap.add_argument("--bench-only", action="store_true", dest="bench_only",
                    help="build the kernels and run the bench phase alone; "
                         "no result line")
    ap.add_argument("--dot2-only", action="store_true", dest="dot2_only",
                    help="build the kernels and run the dot2 phase alone "
                         "at --L; no result line")
    ap.add_argument("--ell-only", action="store_true", dest="ell_only",
                    help="build the kernels and run the ell phase alone at "
                         "--L-compact; no result line")
    ap.add_argument("--bf16-steps", action="store_true", dest="bf16_steps",
                    help="the float32 and bfloat16 trajectories at --L and "
                         "the launches of one term of each; no result line")
    args = ap.parse_args(argv)
    if args.L % 2 or not 16 <= args.L <= 32:
        raise SystemExit("--L must be even, 16..32")
    if args.L_flat % 2 or not 16 <= args.L_flat <= 28:
        raise SystemExit("--L-flat must be even, 16..28")
    if args.L_compact % 2 or not 16 <= args.L_compact <= 30:
        raise SystemExit("--L-compact must be even, 16..30")
    if args.shards < 2:
        raise SystemExit("--shards must be at least 2 (one shard runs no "
                         "crossw instance)")

    if args.k3_against:
        k3_turns(args.k3_against, args.L_flat)
        return 0  # a comparison, not the smoke: no result line
    phase_device()
    dev = torch.device("cuda")
    from spindynamics_tpu_torch import BlockVec  # (the import pins TF32 off)

    phase_build()
    if args.shard_flat or args.bf16_steps or args.bench_only or \
            args.dot2_only or args.ell_only:
        # measurements of one part, not the smoke: no result line
        if args.dot2_only:
            print(json.dumps({"dot2": phase_dot2(args.L, dev)}))
        if args.ell_only:
            print(json.dumps({"ell_kernel": phase_ell(args.L_compact, dev)}))
        if args.bench_only:
            print(json.dumps(phase_bench()))
        if args.shard_flat:
            print(json.dumps({"shard_flat": phase_shard_flat(
                args.L_compact, args.L_flat, args.shards, dev)}))
        if args.bf16_steps:
            _, einfo = phase_evolve(args.L, dev)
            phase_evolve_bf16(args.L, dev, einfo)
            phase_profile_term(args.L, dev, einfo)
        return 0
    phase_k1(16, dev)
    abs_err, rel_err, k_ms, p_ms, bound1, fbound1 = phase_k1(args.L, dev)
    phase_k2(16, dev)
    abs_err2, rel_err2, k2_ms, p2_ms, bound2, fbound2 = phase_k2(args.L, dev)
    phase_k1_bf16(16, dev)
    b1_err, _, b1_ms, b1_plain, b1_bound, b1_fbound = phase_k1_bf16(args.L,
                                                                    dev)
    phase_k2_bf16(16, dev)
    b2_err, _, b2_ms, b2_plain, b2_bound, b2_fbound = phase_k2_bf16(args.L,
                                                                    dev)
    phase_k1_fma(16, dev)
    fma = phase_k1_fma(args.L, dev)
    if args.kron_tiles:
        phase_kron_tiles(args.L, dev)
    dot2 = phase_dot2(args.L, dev)
    phase_oracle(dev)
    launches, psi, E0, kinfo, S_main, dot2_launches = phase_main(args.L, dev)
    if args.profile:
        phase_profile(args.L, dev, psi, kinfo)
    # the ground state waits on the host while the trajectories run, so
    # their peak memory is their own
    psi = BlockVec([x.cpu() for x in psi.leaves])
    phase_evolve_oracle(dev)
    launches2, einfo = phase_evolve(args.L, dev)
    if args.profile:
        phase_profile_term(args.L, dev, einfo)
    phase_evolve_oracle(dev, torch.bfloat16)
    b1_launches, b2_launches = phase_evolve_bf16(args.L, dev, einfo)
    psi = BlockVec([x.to(dev) for x in psi.leaves])
    phase_kron_sqw(args.L, dev, psi, E0, kinfo)
    phase_kron_obs(args.L, dev, psi, E0, kinfo)
    del psi
    phase_typicality(dev)
    k3 = phase_k3(args.L_flat, dev)
    if args.k3_tiles:
        phase_k3_tiles(args.L_flat, dev)
    phase_flat_oracle(dev)
    launches3, E0_flat = phase_flat_main(args.L_flat, dev)
    if args.profile:
        phase_profile_flat(args.L_flat, dev)
    phase_compact_oracle(dev)
    ref = ((E0, S_main, kinfo, einfo) if args.L_compact == args.L
           else kron_references(args.L_compact, dev))
    ell = phase_compact_main(args.L_compact, dev, *ref)
    ellk = ell["kernel"]
    typ = phase_flat_typicality(args.L_flat, dev)
    phase_checkpoint(dev)
    f32, bf16 = torch.float32, torch.bfloat16
    for D in (2, 4):
        phase_k1_crossw(16, D, dev, f32)
        phase_k1_crossw(16, D, dev, bf16)
    cw = phase_k1_crossw(args.L, args.shards, dev, f32)
    cwb = phase_k1_crossw(args.L, args.shards, dev, bf16)
    phase_shard_apply(args.L, dev)
    cw_launches = phase_shard_main(args.L, args.shards, dev, E0, S_main)
    phase_shard_evolve(args.L, args.shards, dev, einfo)
    phase_dist1(args.L, dev)
    sf = phase_shard_flat(args.L_compact, args.L_flat, args.shards, dev,
                          ell["E0"], E0_flat)
    sb = phase_sector_blocked(args.L, dev, E0)
    cli = phase_cli(args.L, args.L_flat, dev,
                    (E0, E0_flat, einfo["obs"]))
    examples = phase_examples(dev, E0, full=args.examples_full)
    bench = phase_bench()
    print(json.dumps({"cli": cli}))
    print(json.dumps({"examples": examples}))
    cli_n = {k: sum(r["launches"][k] for r in cli)
             for k in ("K1", "K1 crossw", "K2", "K3", "dot2")}
    ex_n = {k: sum(r["launches"][k] for r in examples) for k in ("K1", "K2")}
    print(json.dumps({"sector_blocked": dict(
        sb, library="torch sparse CSR H @ psi of the compact model")}))
    print(json.dumps({"shard_flat": sf}))
    print(json.dumps({"ell": dict(ell, typicality_s=typ["compact"][2],
                                  typicality_applies=typ["compact"][1],
                                  library="torch sparse CSR H @ psi")}))
    print(json.dumps(bench))
    print(json.dumps({"kernels": [{
        "name": "K1 fused kron group apply",
        "route": "cuda",
        "source": "spindynamics_tpu_torch/csrc/kron_group.cu",
        "replaces": "spindynamics_tpu/ops/pallas_kron.py:217",
        "launches": launches,
        "max_abs_err": abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound1[0],
        "bound_by": bound1[1],
        "library_ms": None,
        "L": args.L,
        "fma_route_bound_ms": fbound1[0],
        "fma_ms": fma["k1"][0],
        "tc_ms_beside_fma": fma["k1"][1],
        "xxz_jxy03_max_abs_err": fma["xxz03"][0],
        "cli_launches": cli_n["K1"],
        "examples_launches": ex_n["K1"],
    }, {
        "name": "K2 fused Chebyshev term",
        "route": "cuda",
        "source": "spindynamics_tpu_torch/csrc/cheb_term.cu",
        "replaces": "spindynamics_tpu/ops/pallas_cheb.py:64",
        "launches": launches2,
        "max_abs_err": abs_err2,
        "ms": k2_ms,
        "plain_ms": p2_ms,
        "bound_ms": bound2[0],
        "bound_by": bound2[1],
        "library_ms": None,
        "L": args.L,
        "fma_route_bound_ms": fbound2[0],
        "fma_ms": fma["k2"][0],
        "tc_ms_beside_fma": fma["k2"][1],
        "cli_launches": cli_n["K2"],
        "examples_launches": ex_n["K2"],
    }, {
        "name": "K1 fused kron group apply (bf16 state)",
        "route": "cuda",
        "source": "spindynamics_tpu_torch/csrc/kron_group.cu",
        "replaces": "spindynamics_tpu/ops/pallas_kron.py:217",
        "launches": b1_launches,
        "max_abs_err": b1_err,
        "ms": b1_ms,
        "plain_ms": b1_plain,
        "bound_ms": b1_bound[0],
        "bound_by": b1_bound[1],
        "library_ms": None,
        "L": args.L,
        "fma_route_bound_ms": b1_fbound[0],
    }, {
        "name": "K2 fused Chebyshev term (bf16 state)",
        "route": "cuda",
        "source": "spindynamics_tpu_torch/csrc/cheb_term.cu",
        "replaces": "spindynamics_tpu/ops/pallas_cheb.py:64",
        "launches": b2_launches,
        "max_abs_err": b2_err,
        "ms": b2_ms,
        "plain_ms": b2_plain,
        "bound_ms": b2_bound[0],
        "bound_by": b2_bound[1],
        "library_ms": None,
        "L": args.L,
        "fma_route_bound_ms": b2_fbound[0],
    }, {
        "name": "K3 fused matvec (float32 state)",
        "route": "cuda",
        "source": "spindynamics_tpu_torch/csrc/fused_matvec.cu",
        "replaces": "spindynamics_tpu/ops/pallas_matvec.py:242",
        "launches": launches3,
        "max_abs_err": max(k3["real"]["abs_err"], k3["complex"]["abs_err"]),
        "ms": k3["real"]["ms"],
        "plain_ms": k3["real"]["plain_ms"],
        "bound_ms": k3["real"]["bound"][0],
        "bound_by": k3["real"]["bound"][1],
        "library_ms": k3["library_ms"],
        "L": args.L_flat,
        "copy_ms": k3["real"]["copy_ms"],
        "complex_ms": k3["complex"]["ms"],
        "complex_plain_ms": k3["complex"]["plain_ms"],
        "complex_bound_ms": k3["complex"]["bound"][0],
        "complex_copy_ms": k3["complex"]["copy_ms"],
        "tile_bits": k3["real"]["tile_bits"],
        "complex_tile_bits": k3["complex"]["tile_bits"],
        "designed_passes": k3["real"]["passes"],
        "complex_designed_passes": k3["complex"]["passes"],
        "flat_typicality_launches": typ["embedded"][0],
        "flat_typicality_s": typ["embedded"][2],
        "cli_launches": cli_n["K3"],
    }, {
        "name": "K1 crossw variant (sharded local block, windows)",
        "route": "cuda",
        "source": "spindynamics_tpu_torch/csrc/kron_group.cu",
        "replaces": "spindynamics_tpu/ops/pallas_kron.py:230",
        "launches": cw_launches,
        "max_abs_err": cw[0],
        "ms": cw[2],
        "plain_ms": cw[3],
        "bound_ms": cw[4][0],
        "bound_by": cw[4][1],
        "library_ms": None,
        "L": args.L,
        "D": args.shards,
        "bf16_max_abs_err": cwb[0],
        "bf16_ms": cwb[2],
        "bf16_plain_ms": cwb[3],
        "bf16_bound_ms": cwb[4][0],
        "graph_replay_ms": cw[5],
        "bf16_graph_replay_ms": cwb[5],
        "fma_route_bound_ms": cw[6][0],
        "bf16_fma_route_bound_ms": cwb[6][0],
        "cli_launches": cli_n["K1 crossw"],
    }, {
        "name": "dot2 compensated inner product (leaf table)",
        "route": "cuda",
        "source": "spindynamics_tpu_torch/csrc/dot2.cu",
        "replaces": "spindynamics_tpu/utils/compensated.py:62",
        "replaces_note": "no pl.pallas_call: an XLA fusion of dot2 in the "
                         "JAX package",
        "launches": dot2_launches,
        "max_abs_err": dot2["max_abs_err"],
        "ms": dot2["ms"],
        "plain_ms": dot2["plain_ms"],
        "bound_ms": dot2["bound"][0],
        "bound_by": dot2["bound"][1],
        "library_ms": dot2["library_ms"],
        "library": "torch.dot of the same numbers (float32 accumulation)",
        "L": args.L,
        "cli_launches": cli_n["dot2"],
        **{k: v for k, v in dot2.items()
           if k not in ("max_abs_err", "ms", "plain_ms", "bound",
                        "library_ms", "L")},
    }, {
        "name": "ell H apply (int32 neighbour table)",
        "route": "cuda",
        "source": "spindynamics_tpu_torch/csrc/ell_apply.cu",
        "replaces": "spindynamics_tpu/ops/apply.py (the ell backend)",
        "replaces_note": "no pl.pallas_call: an XLA gather in the JAX "
                         "package",
        "launches": ell["ell_launches"],
        "max_rel_err": ellk["float32"]["errors"]["kernel"],
        "ms": ellk["float32"]["ms"],
        "plain_ms": ellk["float32"]["plain_ms"],
        "bound_ms": ellk["float32"]["bound_ms"],
        "bound_by": ellk["float32"]["bound_by"],
        "library_ms": ellk["float32"]["library_ms"],
        "library": "torch sparse CSR H @ psi of the same matrix",
        "L": args.L_compact,
        "complex64": ellk["complex64"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
