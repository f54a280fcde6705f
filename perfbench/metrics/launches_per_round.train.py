"""Kernel launches the device ran per round in the traced stretch."""


def read(ctx):
    if not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / ctx.stretch_rounds
