"""Kernel launch calls (``cudaLaunchKernel``, ``cuLaunchKernel`` and their
variants) that start inside the predictive's spans, ``predictive.forward``
and ``predictive.backward``, on any thread, over the ``attack.iterations``
counter. Device trace (the profiler's runtime events)."""
from benchmark import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "pgd" or spans.units(ctx) is None:
        return None
    s = spans.of(ctx)
    if not s["busy_s"]:
        return None
    return sum(s["launches"].get(n, 0) for n in spans.PREDICTIVE[:2]) / spans.units(ctx)
