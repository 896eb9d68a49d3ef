"""Product-state bitstrings (port of the bitstring helpers of
spindynamics_tpu/models/initial_states.py). Host ints: bit i is site i
(0-based). `solvers/blockvec.bv_basis_state` turns one into a kron state;
the flat-vector builders wait for the flat path (ROADMAP Queue 1, item 11).
"""

from __future__ import annotations

from ..model import SpinModel

__all__ = ["domain_wall_bitstring", "neel_bitstring", "polarized_bitstring"]


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
