"""Device time of the attention route's kernels a PGD iteration, forward and
input gradient: every kernel of the profiled stretch whose name holds
``fmha``, ``flash`` or ``attention`` (PyTorch's fused attention kernels; a
hand-written one of the port carries ``attention`` in its name), over the
stretch's PGD iterations. Nothing to read unless the spans stretch
(:mod:`benchmark.spans`) counted the program's ``cct.attention``, its
fused-route attention calls, as in a program without ``cct7`` or where
attention took the plain route."""
from benchmark import spans

NAMES = ("fmha", "flash", "attention")


def read(ctx):
    trace = ctx["trace"]
    if ctx["traffic"]["kind"] != "pgd" or trace is None or not trace["units"]:
        return None
    s = spans.of(ctx)
    if s is None or not s["counters"].get("cct.attention"):
        return None
    kernel_s = sum(sec for name, sec in trace["device_ops"].items() if any(k in name.lower() for k in NAMES))
    if kernel_s <= 0:
        return None
    return 1e3 * kernel_s / trace["units"]
