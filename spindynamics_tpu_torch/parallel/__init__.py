"""Row-sharded kron states: the meshes a `mesh=` argument takes, the
process-group glue, and the block-distributed kron apply."""
