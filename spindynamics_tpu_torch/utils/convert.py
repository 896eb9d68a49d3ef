"""Carry models and states between the JAX package and the port, as numpy.

A JAX SpinModel's couplings (np.asarray of its fields) rebuild the same model
here; BlockVec leaves go across as a list of numpy arrays, e.g. a JAX ground
state `[np.asarray(l) for l in psi.leaves]` fed to the port's kpm_sqw_kron.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model import _TORCH_DTYPES, SpinModel, build_model
from ..solvers.blockvec import BlockVec

__all__ = ["model_from_numpy", "model_from_jax_arrays",
           "blockvec_from_numpy", "blockvec_to_numpy",
           "state_from_numpy", "state_to_numpy"]


def model_from_numpy(L: int, nup, hop_sites, hop_J, field, zz_sites, zz_J,
                     splits=None, dtype: torch.dtype | None = None,
                     layout: str = "sector_kron") -> SpinModel:
    """Port model from a JAX SpinModel's couplings passed as numpy: bond
    site pairs, their J values, the onsite field and, for
    layout="sector_kron", the kron splits. layout is "sector_kron",
    "compact" (the JAX package's mode "sector": the same ascending states,
    so its states and parameters carry across unchanged), "embedded" or
    "full" (nup=None). dtype defaults to that of field."""
    hop_J = np.asarray(hop_J)
    zz_J = np.asarray(zz_J)
    field = np.asarray(field)
    if dtype is None:
        dtype = _TORCH_DTYPES[field.dtype]
    return build_model(
        int(L), nup=None if nup is None else int(nup),
        hopping=[(int(i), int(j), float(J))
                 for (i, j), J in zip(hop_sites, hop_J)],
        onsite_field=field,
        zz=[(int(i), int(j), float(J)) for (i, j), J in zip(zz_sites, zz_J)],
        dtype=dtype, layout=layout,
        kron_splits=(tuple(int(s) for s in splits)
                     if layout == "sector_kron" and splits is not None
                     else None))


# the JAX model's fields arrive as numpy arrays either way
model_from_jax_arrays = model_from_numpy


def blockvec_from_numpy(leaves, device, dtype: torch.dtype = torch.float32,
                        spec=None, mesh=None) -> BlockVec:
    """BlockVec from a list of per-group numpy arrays [C_h, C_m_pad,
    C_l_pad]. dtype=torch.bfloat16 rounds float32 values to nearest even
    (numpy has no bfloat16; `_tensor` says how).

    With `spec` and `mesh` (a KronShardSpec and a LocalMesh or ProcessMesh
    of its D shards) the result is in sharded form on the mesh. The arrays
    are plain leaves [C_h, ...] or whole sharded-form leaves [D*b, ...]
    (a JAX sharded state's leaves as numpy arrays): the hi axis is
    zero-padded to D*b where it is shorter, and each process keeps the
    rows of its shards (a ProcessMesh rank its b rows)."""
    if (spec is None) != (mesh is None):
        raise ValueError("the sharded form needs both spec and mesh")
    if spec is None:
        return BlockVec([_tensor(l, dtype, device) for l in leaves])
    out = []
    for gi, l in enumerate(leaves):
        l = np.asarray(l)
        l = np.pad(l, ((0, spec.ch_pad[gi] - l.shape[0]), (0, 0), (0, 0)))
        out.append(_tensor(l[mesh.row_slice(spec.b[gi])], dtype, device))
    return BlockVec(out, mesh)


def _tensor(x, dtype, device) -> torch.Tensor:
    """numpy -> torch (copied). numpy has no bfloat16, so a bfloat16 tensor
    is made from the array as float32 and rounded on the torch side, to
    nearest even: the float32 -> bfloat16 `astype` of the JAX package."""
    x = np.asarray(x)
    if dtype == torch.bfloat16:
        return torch.tensor(x, dtype=torch.float32,
                            device=device).to(torch.bfloat16)
    return torch.tensor(x, dtype=dtype, device=device)


def _numpy(x: torch.Tensor) -> np.ndarray:
    """torch -> numpy on the host; bfloat16 comes back as float32 (exact)."""
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def blockvec_to_numpy(bv: BlockVec, spec=None) -> list:
    """List of per-group numpy arrays (copied to the host); bfloat16 leaves
    as float32. A sharded BlockVec gives the rows its process holds (a
    LocalMesh: the whole padded leaves [D*b, ...]); with `spec` the hi
    padding rows of whole leaves are dropped, which gives the plain
    leaves back."""
    out = [_numpy(l) for l in bv.leaves]
    if spec is not None:
        if any(l.shape[0] != chp for l, chp in zip(out, spec.ch_pad)):
            raise ValueError("dropping the hi padding needs whole "
                             "sharded-form leaves; these hold one rank's "
                             "rows")
        out = [l[:g[3]] for l, g in zip(out, spec.layout.groups)]
    return out


def state_from_numpy(psi, device, dtype: torch.dtype | None = None
                     ) -> torch.Tensor:
    """Flat state tensor on `device` from a numpy array, real or complex
    (copied); dtype defaults to the array's, and may be torch.bfloat16 for
    a real array (float32 values rounded to nearest even). The device is
    required, as for blockvec_from_numpy: the state decides where a solver
    runs."""
    return _tensor(psi, dtype, device)


def state_to_numpy(psi: torch.Tensor) -> np.ndarray:
    """Numpy copy of a flat state, on the host (bfloat16 as float32)."""
    return _numpy(psi)
