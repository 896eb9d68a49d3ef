"""One rank of a two-process ProcessMesh run over gloo, for
tests/test_torch_parallel.py (it imports torch and the port only).

Run as `python _torch_dist_worker.py RANK WORLD PORT L OUT_DIR [flat]`:
joins the process group at tcp://localhost:PORT, holds its shard of the
case's state (`case_state`, made with numpy from a seed, the same in every
process), runs one sharded apply, the sharded observables and one
groundstate_kron on the ProcessMesh, and writes its blocks to
OUT_DIR/rank{RANK}.npz. With `flat` it runs `run_flat_case` instead (for
tests/test_torch_sharded_flat.py): the row-sharded flat path. The parent
compares them with the LocalMesh run of the same case.
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


def run_flat_case(L, mesh):
    """The row-sharded flat path on `mesh` (on the CPU, float64): the
    compact XXZ chain's halo and all-gather applies of a numpy-made state,
    the embedded chain's sharded blocked apply, a ground state, one
    Chebyshev step, <Sz_i>, and the two trajectories; a dict of numpy
    arrays (states as this process's rows)."""
    import spindynamics_tpu_torch as pt

    f64 = torch.float64
    m = pt.xxz_chain(L, Jxy=1.0, Jz=0.5, nup=L // 2, dtype=f64,
                     layout="compact")
    rng = np.random.default_rng(11)
    x = rng.standard_normal(m.n_states) + 1j * rng.standard_normal(
        m.n_states)
    x = torch.tensor(x / np.linalg.norm(x))
    out = {}
    xs = pt.shard_state(x, mesh)
    out["rows"] = np.asarray(xs.shape[0])
    for name, fn in (("halo", pt.sharded_matvec_halo_fn),
                     ("gather", pt.sharded_matvec_fn)):
        mv, pm = fn(m, mesh, device="cpu")
        out[name] = mv(xs).numpy()
    out.update({f"cnt_{k}": np.asarray(v)
                for k, v in mesh.counters().items()})
    msh = pt.shard_model(m, mesh)
    mv = pt.matvec_fn(msh, device="cpu")
    E0, psi, info = pt.lanczos_groundstate(
        mv, msh.n_states, lanc_m=50, dtype=f64, mask=msh.valid_mask(),
        generator=torch.Generator().manual_seed(0), device="cpu")
    out["E0"], out["residual"] = np.asarray(E0), np.asarray(info["residual"])
    out["psi"] = psi.numpy()
    out["cheb"] = pt.chebyshev_time_evolve(xs, mv, 0.1, (-8.0, 8.0),
                                           cheb_n=24).numpy()
    out["mag"] = pt.magnetization_per_site(xs, msh).numpy()
    psi0 = pt.domain_wall_state(m, dtype=f64, device="cpu")
    out["traj_psi"], out["traj"] = (
        lambda r: (r[0].numpy(), r[1]))(pt.evolve_trajectory(
            m, psi0, 0.1, 3, cheb_n=24, Ebounds=(-8.0, 8.0), mesh=mesh))
    pl, out["planes_obs"] = pt.evolve_trajectory_planes(
        m, psi0, 0.1, 3, cheb_n=24, Ebounds=(-8.0, 8.0), mesh=mesh)
    out["planes"] = pl.numpy()
    me = pt.xxz_chain(L, Jxy=1.0, Jz=0.4, nup=L // 2, dtype=f64,
                      layout="embedded")
    y = torch.tensor(np.random.default_rng(13).standard_normal(me.n_states))
    out["blocked"] = pt.matvec_fn(me, mesh=mesh, device="cpu")(
        pt.shard_state(y, mesh)).numpy()
    return out


def main(argv):
    rank, world, port, L = (int(a) for a in argv[1:5])
    out_dir = argv[5]
    flat = argv[6:] == ["flat"]
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
                 **(run_flat_case if flat else run_case)(L, mesh))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
