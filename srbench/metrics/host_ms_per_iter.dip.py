"""Host ms per DIP iteration: the mean ``dip.iteration`` span (the noise
draw and the forward, backward and Adam, from the loop's start of the
iteration to the host's return) over the iterations of the traced run's
unprofiled calls (srbench.spans)."""

from srbench import spans


def read(ctx):
    return spans.mean_ms(spans.within(spans.counted("dip.call"),
                                      "dip.iteration"))
