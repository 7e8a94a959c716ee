"""The share of the traced window in which no kernel or copy runs, in %,
averaged over the cards the cell uses."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.mean_busy_s(ctx.cards) / ctx.trace.window_s)
