"""Host ms per training step: the mean ``gan.step`` span (G's forward,
D's update, G's update; the crop is apart) over the traced run's
unprofiled steps (srbench.spans)."""

from srbench import spans


def read(ctx):
    return spans.mean_ms(spans.counted("gan.step"))
