"""The transformer trunk's share of its roofline in the spans stretch: the
bound of its forwards over their device time, in percent.

The bound: the program's ``cct.forwards`` counter times the products of
one forward (``sum(forward_flops(config))`` an image and draw,
:mod:`benchmark.work`) times the batch and S, at the FP32 peak. The device
time: the kernels launched by the ops inside the ``conv_trunk`` spans
(:mod:`benchmark.spans`), the forward's; both over the same stretch. The
encoder's dense products, four fifths of the count, run on the FP32 cores,
so the share stays well under 100% even where attention takes its products
on the tensor cores. Nothing to read where no ``cct.forwards`` counted, as in
a program without ``cct7``."""
from benchmark import spans, work


def read(ctx):
    if ctx["traffic"]["kind"] != "pgd" or spans.units(ctx) is None:
        return None
    s = spans.of(ctx)
    forwards = s["counters"].get("cct.forwards", 0)
    if not forwards or s["conv_trunk_device_s"] <= 0:
        return None
    t = ctx["traffic"]
    flops = forwards * sum(work.arch(ctx["config"]).forward_flops(ctx["config"])) * t["batch_size"] * t["n_samples"]
    return 100.0 * flops / work.PEAKS["fp32_flops_per_s"] / s["conv_trunk_device_s"]
