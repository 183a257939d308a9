"""The whole PGD iteration's share of the FP32 peak: the products of the
S-draw forward and its input gradient, counted from the configuration's
shapes (:func:`benchmark.work.pgd_iteration_flops`), over the untraced
window's seconds per iteration, in percent of 67 TFLOP/s."""
from benchmark import work


def read(ctx):
    if ctx["traffic"]["kind"] != "pgd":
        return None
    w = ctx["window"]
    flops = work.pgd_iteration_flops(ctx["config"], ctx["traffic"]) * w["iterations"]
    return 100.0 * flops / (w["seconds"] * work.PEAKS["fp32_flops_per_s"])
