"""What the readers of the traced slices share: a slice's analysis and its
count of applies."""


def span(ctx, kind: str):
    """(the slice's analysis, its applies), or None where the trace has no
    such slice or saw no device work in it."""
    if ctx.trace is None or kind not in ctx.trace["spans"]:
        return None
    s = ctx.trace["spans"][kind]
    if s["busy_ms"] <= 0:
        return None
    return s, ctx.slices[kind].applies
