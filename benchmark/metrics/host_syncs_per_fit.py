"""The program's ``host_syncs`` counter over the window, per call."""


def read(ctx):
    if not ctx.calls or ctx.host_syncs is None:
        return None
    return ctx.host_syncs / ctx.calls
