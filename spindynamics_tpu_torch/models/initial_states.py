"""Product-state constructors (port of
spindynamics_tpu/models/initial_states.py). Host ints: bit i is site i
(0-based). Every `*_state` constructor returns a flat state vector in the
basis of a full, embedded, compact or sector_blocked model;
`solvers/blockvec.bv_basis_state` turns a bitstring into a kron state. The state a solver is given decides where
the solver runs, so the constructors follow the port's device rule
(utils/device.py): `device=None` is the card, and raises without one;
a CPU state is asked for with device="cpu".
"""

from __future__ import annotations

import torch

from ..basis import rank_state
from ..model import FLAT_MODES, SpinModel
from ..utils.device import resolve_device

__all__ = [
    "domain_wall_bitstring", "neel_bitstring", "polarized_bitstring",
    "state_index", "basis_state_vector", "domain_wall_state", "neel_state",
    "polarized_state", "polarized_state_with_flips",
]


def domain_wall_bitstring(model: SpinModel) -> int:
    """First nup sites up, the rest down (ref src/InitialStates.jl:9-28);
    nup = ceil(L/2) when the model has none."""
    nup = model.nup if model.nup is not None else -(-model.L // 2)
    return (1 << nup) - 1


def neel_bitstring(model: SpinModel) -> int:
    """Up at even sites 0, 2, 4, ... (ref src/InitialStates.jl:34-54)."""
    s = 0
    for i in range(0, model.L, 2):
        s |= 1 << i
    return s


def polarized_bitstring(model: SpinModel, up: bool = True) -> int:
    return ((1 << model.L) - 1) if up else 0


def state_index(model: SpinModel, bitstring: int) -> int:
    """Basis index of an encoded bitstring: the bitstring itself on a full
    or embedded model (an embedded model checks its magnetization), its
    combinadic rank on a compact model and its blocked rank on a
    sector_blocked model (after the same check)."""
    if model.mode not in FLAT_MODES:
        raise ValueError(
            "state_index needs a full, embedded, compact or sector_blocked "
            "model; a sector_kron state comes from "
            "solvers.blockvec.bv_basis_state")
    if model.mode != "full" and bin(bitstring).count("1") != model.nup:
        raise ValueError(
            f"state {bitstring:#x} has wrong magnetization for "
            f"{model.mode} sector nup={model.nup}")
    if model.mode == "compact":
        return rank_state(bitstring, model.L, model.nup)
    if model.mode == "sector_blocked":
        from ..ops.sector_blocked import blocked_rank

        return blocked_rank(bitstring, model.L, model.nup, model.lo_bits)
    return int(bitstring)


def basis_state_vector(model: SpinModel, bitstring: int, dtype=None,
                       device=None) -> torch.Tensor:
    """One-hot state vector |bitstring> in the model's basis."""
    if dtype is None:
        dtype = model.dtype
    idx = state_index(model, bitstring)
    v = torch.zeros(model.n_states, dtype=dtype,
                    device=resolve_device(device))
    v[idx] = 1
    return v


def domain_wall_state(model: SpinModel, dtype=None, device=None):
    """|up...up down...down> (ref src/InitialStates.jl:9-28)."""
    return basis_state_vector(model, domain_wall_bitstring(model), dtype,
                              device)


def neel_state(model: SpinModel, dtype=None, device=None):
    """|up down up down ...> (ref src/InitialStates.jl:34-54)."""
    return basis_state_vector(model, neel_bitstring(model), dtype, device)


def polarized_state(model: SpinModel, up: bool = True, dtype=None,
                    device=None):
    """All spins aligned (raises if the state is not in the sector)."""
    return basis_state_vector(model, polarized_bitstring(model, up), dtype,
                              device)


def polarized_state_with_flips(model: SpinModel, flips, dtype=None,
                               device=None):
    """All-up with the given (0-based) sites flipped."""
    s = (1 << model.L) - 1
    for i in flips:
        if not 0 <= i < model.L:
            raise ValueError(f"flip site {i} out of range")
        s ^= 1 << i
    return basis_state_vector(model, s, dtype, device)
