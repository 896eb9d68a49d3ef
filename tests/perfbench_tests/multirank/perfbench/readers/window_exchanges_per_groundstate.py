"""Window exchanges per ground state on rank 0, counted by the mesh (one
an apply, the rows a shard reads from the others): the window's mean."""


def read(ctx):
    return ctx.counts.get("n_window_exchange.groundstate")
