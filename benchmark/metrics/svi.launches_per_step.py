"""Device kernels in the profiled stretch per SVI step (device trace)."""


def read(ctx):
    trace = ctx["trace"]
    if ctx["traffic"]["kind"] != "svi" or trace is None or not trace["launches"]:
        return None
    return trace["launches"] / trace["units"]
