"""Host ms per DIP iteration of each call's time outside its iterations:
net init on the CPU and its move to the card, the metric heads, the
resolve and the curves' drain to the host, as the ``dip.call`` spans less
their ``dip.iteration`` spans, summed over the traced run's unprofiled
calls and divided by their iterations (srbench.spans). With
``host_ms_per_iter.dip`` it makes up the calls' time per iteration."""

from srbench import spans


def read(ctx):
    calls = spans.counted("dip.call")
    iters = spans.within(calls, "dip.iteration")
    if not iters:
        return None
    return (sum(c.ms for c in calls) - sum(i.ms for i in iters)) / len(iters)
