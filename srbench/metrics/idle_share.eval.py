"""Share of the profiled window of eval images in which no operation ran
on the card, in %."""


def read(ctx):
    tw = ctx["trace"]
    return 100.0 * (1.0 - tw.busy_s / tw.window_s)
