"""The whole SVI step's share of the FP32 peak: the products of the ELBO
forward and backward and of the accuracy forward, counted from the
configuration's shapes (:func:`benchmark.work.svi_step_flops`), over the
untraced window's seconds per step, in percent of 67 TFLOP/s."""
from benchmark import work


def read(ctx):
    if ctx["traffic"]["kind"] != "svi":
        return None
    w = ctx["window"]
    flops = work.svi_step_flops(ctx["config"], ctx["traffic"]) * w["steps"]
    return 100.0 * flops / (w["seconds"] * work.PEAKS["fp32_flops_per_s"])
