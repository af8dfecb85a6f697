"""Device operations per image-iteration of the lane batch (a lane-batch
iteration over its lanes) in a complete profiled window: the host's
launch work, shared by the lanes."""


def read(ctx):
    tw = ctx["trace"]
    return tw.ops / (tw.units * ctx["unit_work"])
