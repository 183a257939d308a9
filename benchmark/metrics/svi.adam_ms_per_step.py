"""Host time of Adam an SVI step: torch's own ``Optimizer.zero_grad#Adam.zero_grad``
and ``Optimizer.step#Adam.step`` ranges in the spans stretch, over the
program's ``svi.steps`` counter. Device trace (the profiler's ranges)."""
from benchmark import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "svi" or spans.units(ctx) is None:
        return None
    s = spans.of(ctx)
    return 1e3 * sum(s["total_s"].get(n, 0.0) for n in spans.ADAM) / spans.units(ctx)
