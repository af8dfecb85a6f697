"""Kernels A and B of the DIP iteration against their roofline: the sum
of each launch's bound (srbench.yardstick, from the launch's shapes) over
their summed device time, in %. Nothing to read where they do not run."""


def read(ctx):
    bound = ctx["conv3x3_bound_s"]
    spent = ctx["trace"].kernel_s(ctx["conv3x3_kernels"])
    if bound is None or spent <= 0:
        return None
    return 100.0 * bound / spent
