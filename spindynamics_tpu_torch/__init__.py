"""spindynamics_tpu_torch: the PyTorch/CUDA port of spindynamics_tpu.

Ported so far: the sector_kron ground state + KPM S(q, omega) path (the
layout construction, BlockVec states, the restarted two-pass Lanczos, the
KPM moments and K1, the fused kron group apply, as a hand-written CUDA
kernel for Hopper: ops/kron_group.py, csrc/kron_group.cu), and kron time
evolution (Chebyshev and Krylov real and imaginary time, the domain-wall
trajectory, quantum typicality: solvers/kron_evolve.py) with K2, the fused
Chebyshev term, in CUDA (ops/cheb_term.py, csrc/cheb_term.cu), both kernels
also for bfloat16 states (evolve_trajectory_kron(state_dtype=
torch.bfloat16)); the Lanczos S(q, omega) and the correlation observables on
kron states (lanczos_sqw_kron, kpm_correlation_matrix_kron,
observables_kron.py); the flat-state path on the full and embedded layouts
(ops/apply.py with the blocked and tensor applies, the flat Lanczos,
Chebyshev, Krylov, Lanczos-S(q, omega) and KPM solvers, observables.py, the
flat runners) with K3, the fused matvec, in CUDA (ops/fused_matvec.py,
csrc/fused_matvec.cu), on the compact sector layout (model.sector_setup:
the ascending sector and its ELL neighbour table, built on the card; the
ell gather apply, plain torch as in the JAX package, where it is an XLA
gather) and on the sector_blocked layout (ops/sector_blocked.py: matrix
products and row gathers, plain torch, XLA code in the JAX package); flat
quantum typicality (solvers/typicality.py) and checkpoint/resume
(utils/checkpoint.py, lanczos_groundstate_checkpointed,
evolve_trajectory(checkpoint_dir=)); the sharded kron path (`mesh=` in
every kron entry point: parallel/mesh.py, parallel/sharded_kron_scaling.py)
with K1's crossw variant, the apply on one shard's local block with its
mid|hi terms read from exchanged windows, in the same CUDA sources; the
row-sharded flat path (shard_model / shard_state, the all-gather and halo
ELL applies of parallel/sharded_apply.py, the pairwise-exchange blocked
apply of parallel/sharded_blocked.py, plain torch as the JAX shard_map
programs are XLA code; the flat solvers, observables and trajectories on
their states); and the command line (`python -m
spindynamics_tpu_torch.cli`). Entry points
run on the card unless the caller passes device="cpu". It imports torch,
numpy and scipy, never jax.
"""

import torch

# Full float32 matrix products everywhere. TF32 keeps ~10 mantissa bits:
# the H100 form of the fault the JAX package hit on the TPU, where the
# default matmul precision truncated f32 operands to bf16 (2.4e-3 relative
# error per term, enough to keep ground-state residuals above the 1e-3
# band at L=32; spindynamics_tpu/ops/sector_kron.py KRON_PRECISION).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .basis import (  # noqa: E402
    binomial_table, bit_at, build_full_basis, build_sector_basis, flip_bits,
    rank_state, rank_states, sector_dimension, sz_value, unrank,
    unrank_states)
from .model import (  # noqa: E402
    SpinModel, build_model, long_range_hopping, nn_hopping)
from .models.initial_states import (  # noqa: E402
    basis_state_vector, domain_wall_bitstring, domain_wall_state,
    neel_bitstring, neel_state, polarized_bitstring, polarized_state,
    polarized_state_with_flips, state_index)
from .models.xxz import (  # noqa: E402
    heisenberg_chain, long_range_xy_chain, xxz_chain, xy_chain)
from .observables import (  # noqa: E402
    connected_correlations, magnetization_per_site, structure_factor_Sq,
    structure_factor_Sq_dict, szsz_matrix)
from .observables_kron import (  # noqa: E402
    bv_sz_q, connected_correlations_kron, magnetization_per_site_kron,
    magnetization_per_site_kron_sharded, structure_factor_Sq_kron,
    szsz_matrix_kron, szsz_matrix_kron_sharded)
from .ops.apply import (  # noqa: E402
    FlatHamiltonian, apply_H, apply_H_dense, apply_H_ell, apply_H_tensor,
    apply_rescaled_H, build_dense_H, matvec_fn)
from .ops.fused_matvec import (  # noqa: E402
    kernel_launch_count as fused_matvec_launch_count)
from .ops.kron_group import KronHamiltonian, kernel_launch_count  # noqa: E402
from .ops.spin_ops import (  # noqa: E402
    apply_spin_operator, make_spin_operator, sz_q_vector, sz_q_weights)
from .parallel.distributed import (  # noqa: E402
    initialize_distributed, local_shard_info, mesh_from_topology)
from .parallel.mesh import (  # noqa: E402
    LocalMesh, ProcessMesh, shard_model, shard_state)
from .parallel.sharded_apply import (  # noqa: E402
    build_halo_plan, pad_model, pad_state, padded_dim, sharded_matvec_fn,
    sharded_matvec_halo_fn, unpad_state)
from .parallel.sharded_blocked import sharded_blocked_matvec_fn  # noqa: E402
from .parallel.sharded_kron_scaling import (  # noqa: E402
    ShardedKronHamiltonian, collective_traffic_model, kron_shard_spec,
    shard_kron_blockvec, sharded_kron_scaling_bv_matvec_fn,
    unshard_kron_blockvec)
from .solvers.blockvec import (  # noqa: E402
    BlockVec, bv_basis_state, bv_random, bv_where_mask)
from .solvers.chebyshev import (  # noqa: E402
    chebyshev_coefficients, chebyshev_cross_moments, chebyshev_moments,
    chebyshev_time_evolve, get_kernel, jackson_kernel, kpm_diagnostics,
    kpm_reconstruct, lorentz_kernel, rescaling_params)
from .solvers.kpm import (  # noqa: E402
    kpm_correlation_matrix, kpm_dynamical_correlation, kpm_sqw,
    kpm_structure_factor, kpm_sw, run_kpm_dynamical)
from .solvers.kron_evolve import (  # noqa: E402
    KronPlanes, chebyshev_imaginary_time_kron, chebyshev_time_evolve_kron,
    evolve_trajectory_kron, kron_energy_bounds, kron_planes_matvec_fn,
    krylov_imaginary_time_evolve_kron, krylov_time_evolve_kron,
    lanczos_tridiag_pair, typicality_correlation_kron)
from .solvers.krylov import (  # noqa: E402
    krylov_expm_multiply, krylov_imaginary_time_evolve, krylov_time_evolve)
from .solvers.lanczos import (  # noqa: E402
    estimate_energy_bounds, lanczos_extremal, lanczos_groundstate,
    lanczos_groundstate_restarted, lanczos_groundstate_twopass,
    lanczos_iteration, lanczos_tridiag)
from .solvers.lanczos_sqw import (  # noqa: E402
    lanczos_sqw, spectral_from_tridiagonal)
from .solvers.runners import (  # noqa: E402
    evolve_trajectory, evolve_trajectory_planes, groundstate_kron, kpm_correlation_matrix_kron,
    kpm_sqw_kron, lanczos_groundstate_checkpointed, lanczos_sqw_kron,
    run_chebyshev, run_krylov)
from .solvers.typicality import (  # noqa: E402
    rk4_time_step, thermal_state, typicality_correlation_function)
from .utils.device import resolve_device  # noqa: E402

__all__ = [
    "SpinModel",
    "build_model",
    "xxz_chain",
    "heisenberg_chain",
    "groundstate_kron",
    "kpm_sqw_kron",
    "KronHamiltonian",
    "KronPlanes",
    "BlockVec",
    "kernel_launch_count",
    "evolve_trajectory_kron",
    "typicality_correlation_kron",
    "chebyshev_time_evolve_kron",
    "kron_energy_bounds",
    "magnetization_per_site_kron",
    "lanczos_sqw_kron",
    "kpm_correlation_matrix_kron",
    "szsz_matrix_kron",
    "connected_correlations_kron",
    "structure_factor_Sq_kron",
    "bv_sz_q",
    "domain_wall_bitstring",
    "neel_bitstring",
    "polarized_bitstring",
    # the flat-state path (full and embedded layouts)
    "nn_hopping",
    "long_range_hopping",
    "FlatHamiltonian",
    "matvec_fn",
    "apply_H",
    "apply_rescaled_H",
    "build_dense_H",
    "fused_matvec_launch_count",
    "apply_spin_operator",
    "make_spin_operator",
    "sz_q_weights",
    "sz_q_vector",
    "state_index",
    "basis_state_vector",
    "domain_wall_state",
    "neel_state",
    "polarized_state",
    "polarized_state_with_flips",
    "magnetization_per_site",
    "szsz_matrix",
    "connected_correlations",
    "structure_factor_Sq",
    "structure_factor_Sq_dict",
    "lanczos_groundstate",
    "lanczos_groundstate_twopass",
    "lanczos_groundstate_restarted",
    "lanczos_extremal",
    "lanczos_tridiag",
    "estimate_energy_bounds",
    "chebyshev_time_evolve",
    "krylov_time_evolve",
    "krylov_expm_multiply",
    "krylov_imaginary_time_evolve",
    "lanczos_sqw",
    "kpm_sw",
    "kpm_sqw",
    "run_chebyshev",
    "run_krylov",
    "evolve_trajectory",
    "resolve_device",
    # the sharded kron path (mesh=)
    "LocalMesh",
    "ProcessMesh",
    "ShardedKronHamiltonian",
    "kron_shard_spec",
    "shard_kron_blockvec",
    "unshard_kron_blockvec",
    "sharded_kron_scaling_bv_matvec_fn",
    "collective_traffic_model",
    "szsz_matrix_kron_sharded",
    "magnetization_per_site_kron_sharded",
    "initialize_distributed",
    "mesh_from_topology",
    "local_shard_info",
    # the rest of the JAX package's namespace
    "xy_chain",
    "long_range_xy_chain",
    "binomial_table",
    "bit_at",
    "build_full_basis",
    "build_sector_basis",
    "flip_bits",
    "rank_state",
    "sector_dimension",
    "sz_value",
    "apply_H_dense",
    "bv_basis_state",
    "bv_random",
    "bv_where_mask",
    "chebyshev_coefficients",
    "chebyshev_cross_moments",
    "chebyshev_moments",
    "get_kernel",
    "jackson_kernel",
    "kpm_diagnostics",
    "kpm_reconstruct",
    "lorentz_kernel",
    "rescaling_params",
    "kpm_correlation_matrix",
    "kpm_dynamical_correlation",
    "kpm_structure_factor",
    "run_kpm_dynamical",
    "chebyshev_imaginary_time_kron",
    "kron_planes_matvec_fn",
    "krylov_imaginary_time_evolve_kron",
    "krylov_time_evolve_kron",
    "lanczos_tridiag_pair",
    "lanczos_iteration",
    "spectral_from_tridiagonal",
    # the compact sector layout, flat typicality, checkpoint/resume
    "apply_H_ell",
    "rank_states",
    "unrank",
    "unrank_states",
    "rk4_time_step",
    "thermal_state",
    "typicality_correlation_function",
    "lanczos_groundstate_checkpointed",
    # the tensor backend
    "apply_H_tensor",
    # the row-sharded flat path (the JAX package's parallel/ names)
    "shard_model",
    "shard_state",
    "padded_dim",
    "pad_state",
    "unpad_state",
    "pad_model",
    "build_halo_plan",
    "sharded_matvec_fn",
    "sharded_matvec_halo_fn",
    "sharded_blocked_matvec_fn",
    "evolve_trajectory_planes",
]

# Names of the JAX package's namespace that this package does not export:
# the ROADMAP.md item that ports each, or why it is not ported. Every name
# is ported.
NOT_PORTED = {}
