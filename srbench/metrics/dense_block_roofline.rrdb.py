"""Kernel C against its roofline in the RRDB frames: each launch's bound
(srbench.yardstick_rrdb: the dense block's useful operations, 2 x 239,616
per pixel, not the halo it recomputes; x read and y written once, its
packed weight units once), summed over the window's launches, over the
kernel's summed device time, in %."""


def read(ctx):
    bound = ctx["dense_block_bound_s"]
    spent = ctx["trace"].kernel_s("C")
    if bound is None or spent <= 0:
        return None
    return 100.0 * bound / spent
