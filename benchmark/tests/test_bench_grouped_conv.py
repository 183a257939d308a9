"""``grouped_conv_roofline`` on known traces: the bound of the launches the
program counted, scaled to the traced stretch's iterations, over the device
time of the ``grouped_conv::`` kernels; nothing where no such kernel ran."""
from __future__ import annotations

import os

import pytest
from conftest import ROOT

from benchmark import harness, work

METRICS_DIR = os.path.join(ROOT, "benchmark", "metrics")
MODEL_0 = harness.cell_spec("model_0.pgd.s100")
KERNEL = "void grouped_conv::(anonymous namespace)::fwd_kernel(float const*, float const*, float const*, float*, int, int, int)"


def ctx(device_ops: dict, counters: dict, units: int = 80, kind: str = "pgd") -> dict:
    return {"config": MODEL_0["config"], "traffic": dict(MODEL_0["traffic"], kind=kind),
            "trace": {"units": units, "device_ops": device_ops}, "spans": {"counters": counters}}


def read(c: dict):
    return harness.read_metric(METRICS_DIR, "grouped_conv_roofline", c)


def test_the_share_is_the_launches_bound_over_the_kernels_time():
    # model_0: 2·8·8·512·25·32 FLOP an image and draw, batch 128, S 100: 10.02 ms at 67 TFLOP/s
    bound_s = 2.0 * 64 * 512 * 800 * 128 * 100 / work.PEAKS["fp32_flops_per_s"]
    assert bound_s == pytest.approx(10.016e-3, rel=1e-3)
    c = ctx({KERNEL: 80 * 0.02, "fft2d_r2c": 5.0}, {"attack.iterations": 40, "grouped_conv.fwd": 40})
    assert read(c) == pytest.approx(100 * bound_s / 0.02)
    c = ctx({KERNEL: 80 * 0.02}, {"attack.iterations": 40, "grouped_conv.fwd": 80})  # two launches an iteration
    assert read(c) == pytest.approx(2 * 100 * bound_s / 0.02)


@pytest.mark.parametrize("case", ["no_kernel", "no_spans", "svi", "untraced"])
def test_nothing_to_read_without_the_kernel(case):
    c = ctx({KERNEL: 1.0}, {"attack.iterations": 40, "grouped_conv.fwd": 40})
    if case == "no_kernel":  # the parent: cuDNN's grouped engine
        c["trace"]["device_ops"] = {"convolve_common_engine_float_NHWC_float__float__1024__5__5_": 4.3}
    elif case == "no_spans":
        c["spans"] = None
    elif case == "svi":
        c = ctx({KERNEL: 1.0}, {"svi.steps": 50}, kind="svi")
    else:
        c["trace"] = None
    assert read(c) is None
