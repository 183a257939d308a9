"""The residual trunk's share of its roofline in the spans stretch: the
bound of its forwards over their device time, in percent.

The bound: the program's ``resnet.forwards`` counter times the products of
one forward (``sum(forward_flops(config))`` an image and draw,
:mod:`benchmark.work`) times the batch and S, at the FP32 peak (each
activation read and written once comes to about a third of that time). The
device time: the kernels launched by the ops inside the ``conv_trunk``
spans (:mod:`benchmark.spans`), the forward's; both over the same stretch.
Nothing to read where no ``resnet.forwards`` counted, as in a program
without ``resnet20``."""
from benchmark import spans, work


def read(ctx):
    if ctx["traffic"]["kind"] != "pgd" or spans.units(ctx) is None:
        return None
    s = spans.of(ctx)
    forwards = s["counters"].get("resnet.forwards", 0)
    if not forwards or s["conv_trunk_device_s"] <= 0:
        return None
    t = ctx["traffic"]
    flops = forwards * sum(work.arch(ctx["config"]).forward_flops(ctx["config"])) * t["batch_size"] * t["n_samples"]
    return 100.0 * flops / work.PEAKS["fp32_flops_per_s"] / s["conv_trunk_device_s"]
