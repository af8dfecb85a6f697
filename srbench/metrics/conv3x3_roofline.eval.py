"""Kernel A of the eval forward against its roofline: the sum of each
launch's bound (srbench.yardstick, from the launch's shapes) over its
summed device time, in %."""


def read(ctx):
    bound = ctx["conv3x3_bound_s"]
    spent = ctx["trace"].kernel_s(ctx["conv3x3_kernels"])
    if bound is None or spent <= 0:
        return None
    return 100.0 * bound / spent
