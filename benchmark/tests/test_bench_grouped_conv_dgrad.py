"""``grouped_conv.dgrad_roofline`` on known traces: the bound of the input
gradient's launches the program counted, scaled to the traced stretch's
iterations, over the device time of the ``grouped_conv_dx::`` kernels;
nothing where no such kernel ran. The forward's kernel and its counter,
which ``grouped_conv_roofline`` reads, do not enter it."""
from __future__ import annotations

import os

import pytest
from conftest import ROOT

from benchmark import harness, work

METRICS_DIR = os.path.join(ROOT, "benchmark", "metrics")
MODEL_0 = harness.cell_spec("model_0.pgd.s100")
KERNEL = ("void grouped_conv_dx::(anonymous namespace)::dgrad_kernel<2, true>(float const*, float const*, float*, "
          "int, int, int)")
FORWARD = "void grouped_conv::(anonymous namespace)::fwd_kernel<true>(float const*, float const*, float const*, float*, int, int, int)"


def ctx(device_ops: dict, counters: dict, units: int = 80, kind: str = "pgd") -> dict:
    return {"config": MODEL_0["config"], "traffic": dict(MODEL_0["traffic"], kind=kind),
            "trace": {"units": units, "device_ops": device_ops}, "spans": {"counters": counters}}


def read(name: str, c: dict):
    return harness.read_metric(METRICS_DIR, name, c)


def test_the_share_is_the_launches_bound_over_the_kernels_time():
    # the forward's useful FLOP: 2·8·8·512·25·32 an image and draw, batch 128, S 100: 10.02 ms at 67 TFLOP/s
    bound_s = 2.0 * 64 * 512 * 800 * 128 * 100 / work.PEAKS["fp32_flops_per_s"]
    counters = {"attack.iterations": 40, "grouped_conv.fwd": 40, "grouped_conv.dgrad": 40}
    c = ctx({KERNEL: 80 * 0.016, FORWARD: 80 * 0.014, "fft2d_r2c": 5.0}, counters)
    assert read("grouped_conv.dgrad_roofline", c) == pytest.approx(100 * bound_s / 0.016)
    assert read("grouped_conv_roofline", c) == pytest.approx(100 * bound_s / 0.014)  # the forward alone
    c = ctx({KERNEL: 80 * 0.016}, dict(counters, **{"grouped_conv.dgrad": 80}))  # two launches an iteration
    assert read("grouped_conv.dgrad_roofline", c) == pytest.approx(2 * 100 * bound_s / 0.016)


@pytest.mark.parametrize("case", ["no_kernel", "no_spans", "svi", "untraced"])
def test_nothing_to_read_without_the_kernel(case):
    c = ctx({KERNEL: 1.0}, {"attack.iterations": 40, "grouped_conv.dgrad": 40})
    if case == "no_kernel":  # the parent: cuDNN's FFT input gradient beside the forward kernel
        c["trace"]["device_ops"] = {FORWARD: 0.55, "fft2d_r2c_32x32": 0.85, "sm80_xmma_gemm_cf32cf32": 0.85}
    elif case == "no_spans":
        c["spans"] = None
    elif case == "svi":
        c = ctx({KERNEL: 1.0}, {"svi.steps": 50}, kind="svi")
    else:
        c["trace"] = None
    assert read("grouped_conv.dgrad_roofline", c) is None
