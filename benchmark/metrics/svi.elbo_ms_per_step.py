"""Host time of the ELBO's forward and backward an SVI step: the program's
``svi.elbo.forward`` and ``svi.elbo.backward`` spans in the spans stretch,
over the ``svi.steps`` counter. Device trace (the profiler's ranges)."""
from benchmark import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "svi" or spans.units(ctx) is None:
        return None
    s = spans.of(ctx)
    return 1e3 * sum(s["total_s"].get(n, 0.0) for n in ("svi.elbo.forward", "svi.elbo.backward")) / spans.units(ctx)
