"""window_exchanges_per_groundstate on a context of its own: the shared
one has no mesh counters."""

EXPECTED = 84.0


def ctx(shared):
    c = shared()
    c.counts = dict(c.counts, **{"n_window_exchange.groundstate": 84.0})
    return c
