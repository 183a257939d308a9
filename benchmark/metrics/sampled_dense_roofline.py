"""The sampled-dense kernels' share of their roofline in the profiled
stretch: the bound of the PGD iterations' sampled-dense calls, counted from
their shapes (:func:`benchmark.work.sampled_dense_iteration_bound_s`), over
the device time of every kernel of the ``sampled_dense::`` namespace in the
trace, in percent. Nothing to read where no such kernel ran."""
from benchmark import work


def read(ctx):
    trace = ctx["trace"]
    if ctx["traffic"]["kind"] != "pgd" or not ctx["config"]["fused_attacks"] or trace is None:
        return None
    kernel_s = sum(s for name, s in trace["device_ops"].items() if "sampled_dense::" in name)
    if kernel_s <= 0:
        return None
    bound = work.sampled_dense_iteration_bound_s(ctx["config"], ctx["traffic"]) * trace["units"]
    return 100.0 * bound / kernel_s
