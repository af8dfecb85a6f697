"""Host ms per training step of D's optimizer step (the bf16 Adam's
launches): the mean ``gan.d_optimizer`` span over the traced run's
unprofiled steps (srbench.spans)."""

from srbench import spans


def read(ctx):
    return spans.mean_ms(spans.counted("gan.d_optimizer"))
