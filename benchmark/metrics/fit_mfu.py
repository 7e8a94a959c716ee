"""The whole fit's share of the cards' roofline, in %.

The yardstick's modelled work of the window's calls (``yardstick/work.py``,
from the units of work the program reports), bound by the larger of its
FLOPs over the float32 peak and its bytes over the memory rate, over the
window's wall seconds; a cell on several cards divides by all their peaks."""

from benchmark.yardstick.peaks import bound_seconds


def read(ctx):
    flops, nbytes = ctx.session.window_work()
    if not ctx.calls or not (flops or nbytes):
        return None
    return 100.0 * bound_seconds(flops, nbytes, ctx.cards) / ctx.seconds
