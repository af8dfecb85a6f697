"""Host ms per eval image: the mean ``gan.generator_forward`` span, the
forward's enqueue before the harness's synchronise, over the traced run's
unprofiled images (srbench.spans)."""

from srbench import spans


def read(ctx):
    return spans.mean_ms(spans.counted("gan.generator_forward"))
