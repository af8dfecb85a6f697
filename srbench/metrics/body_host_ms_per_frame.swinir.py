"""Host ms per SwinIR frame spent enqueuing the six RSTBs: the
``swinir.body`` spans inside the traced run's unprofiled
``gan.generator_forward`` calls, over those calls (srbench.spans); None
where the program has no such span."""

from srbench import spans


def read(ctx):
    calls = spans.counted("gan.generator_forward")
    bodies = spans.within(calls, "swinir.body")
    if not calls or not bodies:
        return None
    return sum(u.ms for u in bodies) / len(calls)
