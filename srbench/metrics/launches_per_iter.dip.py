"""Device operations per image-iteration (a lane-batch iteration counts
its lanes), in a complete profiled window: the host's launch work."""


def read(ctx):
    tw = ctx["trace"]
    return tw.ops / (tw.units * ctx["unit_work"])
