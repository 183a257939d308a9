"""Device kernels in the profiled stretch per PGD iteration (device trace)."""


def read(ctx):
    trace = ctx["trace"]
    if ctx["traffic"]["kind"] != "pgd" or trace is None or not trace["launches"]:
        return None
    return trace["launches"] / trace["units"]
