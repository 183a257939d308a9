"""The predictive's host time a PGD iteration: the durations of the
program's ``predictive.forward`` and ``predictive.backward`` spans (the
forward with its cross-entropy, the input gradient) in the spans stretch,
over the ``attack.iterations`` counter. Device trace (the profiler's ranges)."""
from benchmark import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "pgd" or spans.units(ctx) is None:
        return None
    s = spans.of(ctx)
    return 1e3 * sum(s["total_s"].get(n, 0.0) for n in spans.PREDICTIVE[:2]) / spans.units(ctx)
