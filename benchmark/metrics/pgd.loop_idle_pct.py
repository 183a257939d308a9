"""The device's idle time put down to the attack loop's own code: idle gaps
whose middle falls in an ``attack.iteration`` or ``attack.batch`` span and in
none of their child spans, in percent of the spans stretch. Device trace."""
from benchmark import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "pgd" or spans.units(ctx) is None:
        return None
    s = spans.of(ctx)
    if s["busy_s"] <= 0:
        return None
    return 100.0 * sum(s["idle_s"].get(n, 0.0) for n in ("attack.iteration", "attack.batch")) / s["window_s"]
