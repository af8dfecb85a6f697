"""Device operations per eval image in a complete profiled window: the
host's launch work."""


def read(ctx):
    tw = ctx["trace"]
    return tw.ops / tw.units
