"""Row-sharded states: the meshes a `mesh=` argument takes and the flat
placements (mesh.py: shard_state, shard_model), the process-group glue
(distributed.py), the block-distributed kron apply
(sharded_kron_scaling.py), and the flat applies of the JAX package's
parallel/ (sharded_apply.py: all-gather and halo ELL; sharded_blocked.py:
the pairwise-exchange blocked apply)."""
