"""spindynamics_tpu_torch: the PyTorch/CUDA port of spindynamics_tpu.

Ported so far: the sector_kron ground state + KPM S(q, omega) path (the
layout construction, BlockVec states, the restarted two-pass Lanczos, the
KPM moments and K1, the fused kron group apply, as a hand-written CUDA
kernel for Hopper: ops/kron_group.py, csrc/kron_group.cu), and kron time
evolution (Chebyshev and Krylov real and imaginary time, the domain-wall
trajectory, quantum typicality: solvers/kron_evolve.py) with K2, the fused
Chebyshev term, in CUDA (ops/cheb_term.py, csrc/cheb_term.cu). It imports
torch, numpy and scipy, never jax.
"""

import torch

# Full float32 matrix products everywhere. TF32 keeps ~10 mantissa bits:
# the H100 form of the fault the JAX package hit on the TPU, where the
# default matmul precision truncated f32 operands to bf16 (2.4e-3 relative
# error per term, enough to keep ground-state residuals above the 1e-3
# band at L=32; spindynamics_tpu/ops/sector_kron.py KRON_PRECISION).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .model import SpinModel, build_model  # noqa: E402
from .models.initial_states import (  # noqa: E402
    domain_wall_bitstring, neel_bitstring, polarized_bitstring)
from .models.xxz import heisenberg_chain, xxz_chain  # noqa: E402
from .observables_kron import magnetization_per_site_kron  # noqa: E402
from .ops.kron_group import KronHamiltonian, kernel_launch_count  # noqa: E402
from .solvers.blockvec import BlockVec  # noqa: E402
from .solvers.kron_evolve import (  # noqa: E402
    KronPlanes, chebyshev_time_evolve_kron, evolve_trajectory_kron,
    kron_energy_bounds, typicality_correlation_kron)
from .solvers.runners import groundstate_kron, kpm_sqw_kron  # noqa: E402

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
    "domain_wall_bitstring",
    "neel_bitstring",
    "polarized_bitstring",
]
