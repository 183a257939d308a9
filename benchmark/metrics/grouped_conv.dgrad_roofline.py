"""The grouped conv's input-gradient kernel's share of its roofline in the
profiled stretch: the bound of its launches over the device time of every
kernel of the ``grouped_conv_dx::`` namespace in the trace, in percent.

Each launch is the input gradient of the conv trunk's second convolution for
the batch under the S draws, whose useful work is the forward's:
``forward_flops(config)[1]`` FLOP an image and draw (:mod:`benchmark.work`),
times the batch and S, at the FP32 peak (its bytes, each read or written
once, take a seventeenth of that at model_0's widths). Launches are counted
as the traced stretch's PGD iterations times the program's launches an
iteration: its counter ``grouped_conv.dgrad`` over its ``attack.iterations``
in the spans stretch (:mod:`benchmark.spans`), which runs the same work.
Nothing to read where no such kernel ran, as in a program without it."""
from benchmark import spans, work


def read(ctx):
    trace = ctx["trace"]
    if ctx["traffic"]["kind"] != "pgd" or trace is None:
        return None
    kernel_s = sum(s for name, s in trace["device_ops"].items() if "grouped_conv_dx::" in name)
    if kernel_s <= 0:
        return None
    iterations = spans.units(ctx)
    if iterations is None:
        return None
    launches = trace["units"] * spans.of(ctx)["counters"].get("grouped_conv.dgrad", 0) / iterations
    t = ctx["traffic"]
    flops = work.arch(ctx["config"]).forward_flops(ctx["config"])[1] * t["batch_size"] * t["n_samples"]
    return 100.0 * launches * flops / work.PEAKS["fp32_flops_per_s"] / kernel_s
