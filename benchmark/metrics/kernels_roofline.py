"""The program's kernels' share of their roofline, in %.

Over the traced window: the sum over the launches of the program's
kernels of the least time each call could take (the frozen cost at the
cell's shapes over the peaks) over the sum of their device time."""

from benchmark.yardstick.kernels import CALLS, call_work
from benchmark.yardstick.peaks import bound_seconds


def read(ctx):
    if ctx.trace is None:
        return None
    shapes = ctx.session.kernel_shapes()
    bound = spent = 0.0
    for counter, (wrapper, members) in CALLS.items():
        launches = ctx.trace.kernels.get(counter, [0, 0.0])[0]
        if not launches or wrapper not in shapes:
            continue
        bound += launches * bound_seconds(*call_work(wrapper, shapes[wrapper]))
        spent += sum(ctx.trace.kernels.get(m, [0, 0.0])[1] for m in members)
    if spent <= 0:
        return None
    return 100.0 * bound / spent
