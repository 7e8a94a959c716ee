"""Seconds of the program's build in set-up: the batch layouts from the
device CSR, synchronized and timed from outside."""


def read(ctx):
    return ctx.session.build_s
