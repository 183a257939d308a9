"""The device's idle time put down to the predictive: idle gaps whose middle
falls innermost in a ``predictive.forward``, ``predictive.backward`` or
``conv_trunk`` span, in percent of the spans stretch. Device trace."""
from benchmark import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "pgd" or spans.units(ctx) is None:
        return None
    s = spans.of(ctx)
    if s["busy_s"] <= 0:
        return None
    return 100.0 * sum(s["idle_s"].get(n, 0.0) for n in spans.PREDICTIVE) / s["window_s"]
