"""One rank of a two-process ProcessMesh run over gloo, for
tests/test_torch_parallel.py (it imports torch and the port only).

Run as `python _torch_dist_worker.py RANK WORLD PORT L OUT_DIR`: joins the
process group at tcp://localhost:PORT, holds its shard of the case's state
(`case_state`, made with numpy from a seed, the same in every process),
runs one sharded apply, the sharded observables and one groundstate_kron
on the ProcessMesh, and writes its blocks to OUT_DIR/rank{RANK}.npz. The
parent compares them with the LocalMesh run of the same case.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = {12: None, 14: (6, 4, 4)}  # L -> kron splits (the JAX tests' sizes)


def case_model(L):
    import spindynamics_tpu_torch as pt

    return pt.xxz_chain(L, Jxy=1.0, Jz=0.7, nup=L // 2,
                        kron_splits=CASES[L])


def case_state(layout, seed=5):
    """Plain float32 leaves [ch, cmp, clp] as numpy arrays, zero on the
    tile pads, of norm 1 (to float32 rounding)."""
    rng = np.random.default_rng(seed)
    leaves = []
    for (_, _, _, ch, cm, cl, cmp, clp) in layout.groups:
        x = np.zeros((ch, cmp, clp))
        x[:, :cm, :cl] = rng.standard_normal((ch, cm, cl))
        leaves.append(x)
    nrm = np.sqrt(sum(float((x * x).sum()) for x in leaves))
    return [(x / nrm).astype(np.float32) for x in leaves]


def run_case(L, mesh):
    """The case on `mesh` (on the CPU): a dict of numpy arrays."""
    import spindynamics_tpu_torch as pt
    from spindynamics_tpu_torch.utils.convert import (
        blockvec_from_numpy, blockvec_to_numpy)

    m = case_model(L)
    H, lay, spec = pt.sharded_kron_scaling_bv_matvec_fn(m, mesh,
                                                        device="cpu")
    x = blockvec_from_numpy(case_state(lay), "cpu", spec=spec, mesh=mesh)
    y = H(x)
    out = {f"y{gi}": l for gi, l in enumerate(blockvec_to_numpy(y))}
    out.update({f"cnt_{k}": np.asarray(v)
                for k, v in mesh.counters().items()})
    szsz, si = pt.szsz_matrix_kron_sharded(x, spec, mesh)
    out["szsz"], out["si"] = szsz.numpy(), si.numpy()
    E0, psi, info, _ = pt.groundstate_kron(
        m, lanc_m=30, cycles=3, target_residual=1e-4, mesh=mesh,
        device="cpu")
    out["E0"], out["residual"] = np.asarray(E0), np.asarray(info["residual"])
    out.update({f"psi{gi}": l
                for gi, l in enumerate(blockvec_to_numpy(psi))})
    out["rows"] = np.asarray([l.shape[0] for l in psi.leaves])
    return out


def main(argv):
    rank, world, port, L = (int(a) for a in argv[1:5])
    out_dir = argv[5]
    torch.set_num_threads(1)
    import spindynamics_tpu_torch as pt

    up = pt.initialize_distributed(f"tcp://localhost:{port}", world, rank,
                                   backend="gloo", timeout_s=120)
    assert up and pt.ProcessMesh().D == world
    try:
        mesh = pt.mesh_from_topology()
        assert pt.local_shard_info(mesh) == {
            "n_shards": world, "local_shard_ids": [rank],
            "process_index": rank, "process_count": world}
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **run_case(L, mesh))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
