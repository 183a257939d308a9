"""Host time of the program's ``svi.accuracy`` span an SVI step in the spans
stretch, over the program's ``svi.steps`` counter. Device trace (the
profiler's ranges)."""
from benchmark import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "svi" or spans.units(ctx) is None:
        return None
    return 1e3 * spans.of(ctx)["total_s"].get("svi.accuracy", 0.0) / spans.units(ctx)
