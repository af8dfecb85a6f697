"""Host ms per image-iteration of the lane batch: the mean
``dip.iteration`` span (one iteration of every lane) over the iterations
of the traced run's unprofiled calls, divided by the lanes
(srbench.spans)."""

from srbench import spans


def read(ctx):
    calls = spans.counted("dip.call")
    mean = spans.mean_ms(spans.within(calls, "dip.iteration"))
    if mean is None:
        return None
    return mean / calls[0].fields["lanes"]
