"""The device's idle share of the profiled stretch: 100 minus the union of
the device events' intervals over the stretch's host seconds, in percent
(the rule of ``chip_smoke.profiled_device_ms``)."""


def read(ctx):
    trace = ctx["trace"]
    if ctx["traffic"]["kind"] != "svi" or trace is None or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
