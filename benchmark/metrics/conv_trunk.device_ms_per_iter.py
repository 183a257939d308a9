"""Device time of the conv trunk's forward a PGD iteration: the kernels
launched by the ops inside the program's ``conv_trunk`` spans, linked by the
profiler's correlation of kernel to launching op, over the
``attack.iterations`` counter. Nothing to read where no conv trunk ran."""
from benchmark import spans


def read(ctx):
    if ctx["traffic"]["kind"] != "pgd" or spans.units(ctx) is None:
        return None
    s = spans.of(ctx)
    if "conv_trunk" not in s["count"] or s["conv_trunk_device_s"] <= 0:
        return None
    return 1e3 * s["conv_trunk_device_s"] / spans.units(ctx)
