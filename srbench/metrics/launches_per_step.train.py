"""Device operations per training step (after the first epoch's metric
forwards) in a complete profiled window: the host's launch work."""


def read(ctx):
    tw = ctx["trace"]
    return tw.ops / tw.units
