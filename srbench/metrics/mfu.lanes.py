"""The model operations of the lane batch's untraced calls (every lane's
conv forwards and backwards, the loss's downsample, the heads' and the
resolve's forwards) over their time, as a share of the card's peak for
the configuration's dtype, in %."""


def read(ctx):
    if ctx["untraced_s"] <= 0:
        return None
    rate = ctx["untraced_flops"] / ctx["untraced_s"]
    return 100.0 * rate / ctx["peak_flops"]
