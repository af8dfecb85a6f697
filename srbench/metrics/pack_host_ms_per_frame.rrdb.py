"""Host ms per RRDB frame spent packing the 69 dense blocks' weight units
for kernel C: the ``rrdb.pack`` spans inside the traced run's unprofiled
``gan.generator_forward`` calls, over those calls (srbench.spans); None
where the program has no such span."""

from srbench import spans


def read(ctx):
    calls = spans.counted("gan.generator_forward")
    packs = spans.within(calls, "rrdb.pack")
    if not calls or not packs:
        return None
    return sum(u.ms for u in packs) / len(calls)
