"""The attack loop's own host time a PGD iteration: the self time of the
program's ``attack.iteration`` and ``attack.batch`` spans (their durations
less their child spans', the predictive's) in the spans stretch, over the
program's ``attack.iterations`` counter. Device trace (the profiler's ranges)."""
from benchmark import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "pgd" or spans.units(ctx) is None:
        return None
    s = spans.of(ctx)
    return 1e3 * sum(s["self_s"].get(n, 0.0) for n in ("attack.iteration", "attack.batch")) / spans.units(ctx)
