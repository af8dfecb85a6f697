"""Share of DIP iterations run as a CUDA-graph replay, in %: of the
``dip.iteration`` spans of the traced run's unprofiled calls
(srbench.spans), those whose ``graph`` field reads ``capture`` (the
iteration that captures the graph and then replays it) or ``replay``. 0.0
where no span carries the field (every iteration eager)."""

from srbench import spans


def read(ctx):
    iters = spans.within(spans.counted("dip.call"), "dip.iteration")
    if not iters:
        return None
    graphed = sum(u.fields.get("graph") in ("capture", "replay")
                  for u in iters)
    return 100.0 * graphed / len(iters)
