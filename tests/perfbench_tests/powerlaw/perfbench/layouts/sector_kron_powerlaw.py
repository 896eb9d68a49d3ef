"""The sector_kron layout of the power-law chain: the sector_kron System
(the same entry points, `groundstate_kron` and `kpm_sqw_kron`, K1, the
restarted two-pass Lanczos, KPM and dot2) on the port's
`long_range_xy_chain`, the hopping Jxy |i - j|^-alpha on every pair of
sites (and Jz |i - j|^-alpha Sz_i Sz_j where the configuration's Jz is not
0)."""

from __future__ import annotations

from .sector_kron import System as _KronSystem
from .sector_kron import build_kernels, reference_state  # noqa: F401


class System(_KronSystem):
    @staticmethod
    def chain(mo: dict, dtype):
        import spindynamics_tpu_torch as pt

        L, a = mo["L"], float(mo["alpha"])
        zz = [(i, j, mo["Jz"] * (j - i) ** -a)
              for i in range(L) for j in range(i + 1, L)] if mo["Jz"] else None
        return pt.long_range_xy_chain(
            L, lambda i, j: mo["Jxy"] * abs(i - j) ** -a, nup=mo["nup"],
            dtype=dtype, layout="sector_kron", zz=zz)
