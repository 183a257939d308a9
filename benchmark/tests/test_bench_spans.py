"""The reader of the program's spans (``benchmark/spans.py``) on synthetic
event lists with known answers, and its ten metrics on the CPU: each reads
nothing in the cells it does not list, nothing from a program without
spans, and leaves the first profiled stretch as it was."""
from __future__ import annotations

import copy
import importlib
import json
import math
import os

import pytest
from conftest import ROOT, tiny_spec

from benchmark import harness, spans
from benchmark import trace as tracing

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    NEW = [m for m in json.load(f)["per_layer"] if m["name"].endswith(("_ms_per_iter", "_ms_per_step", "idle_pct",
                                                                        "predictive.launches_per_iter"))
           and not m["name"].startswith("device_idle_pct")]
METRICS_DIR = os.path.join(ROOT, "benchmark", "metrics")
MAIN, AUTOGRAD = 1, 2  # threads

# One PGD batch of two iterations on the main thread (ns); the backward's
# work runs on autograd's thread while the main thread waits in its span.
PGD_SPANS = [
    ("attack.batch", 0, 1000, MAIN),
    ("attack.iteration", 100, 500, MAIN),
    ("predictive.forward", 120, 250, MAIN),
    ("conv_trunk", 130, 230, MAIN),
    ("predictive.backward", 260, 450, MAIN),
    ("attack.iteration", 500, 950, MAIN),
    ("predictive.forward", 510, 700, MAIN),
    ("conv_trunk", 520, 690, MAIN),
    ("predictive.backward", 700, 900, MAIN),
]


def ms(ns: float) -> float:
    return 1e-9 * ns


def test_self_time_is_the_span_less_its_children():
    own = spans.self_times(PGD_SPANS + [("svi.step", 300, 400, AUTOGRAD)])
    assert own["attack.batch"] == pytest.approx(ms(1000 - 400 - 450))
    assert own["attack.iteration"] == pytest.approx(ms(400 - 130 - 190 + 450 - 190 - 200))
    assert own["predictive.forward"] == pytest.approx(ms(130 - 100 + 190 - 170))
    assert own["conv_trunk"] == pytest.approx(ms(100 + 170))
    assert own["predictive.backward"] == pytest.approx(ms(190 + 200))
    assert own["svi.step"] == pytest.approx(ms(100))  # another thread's span is no child


def test_idle_goes_to_the_innermost_span_at_the_gaps_middle_on_any_thread():
    busy = [[0, 110], [120, 200], [240, 300], [380, 520], [1200, 1300]]
    on_autograd = [("svi.draws", 330, 360, AUTOGRAD)]
    idle = spans.idle_by_span(busy, PGD_SPANS + on_autograd)
    assert idle == pytest.approx({
        "attack.iteration": ms(10),      # 110-120, middle 115: the iteration, before its forward
        "conv_trunk": ms(40),            # 200-240, middle 220
        "svi.draws": ms(80),             # 300-380, middle 340: started later, on the other thread
        "predictive.backward": ms(680),  # 520-1200, middle 860
    })
    assert spans.idle_by_span([[0, 10], [2000, 2100]], PGD_SPANS) == {spans.OUTSIDE: pytest.approx(ms(1990))}


def test_launches_count_inside_a_spans_intervals_on_any_thread():
    launches = [50, 130, 255, 300, 455, 505, 905, 1100]
    s = spans.reduce(PGD_SPANS, [], launches, [], 1e-6, {"attack.iterations": 2})
    assert s["launches"]["attack.batch"] == 7
    assert s["launches"]["attack.iteration"] == 6
    assert s["launches"]["predictive.forward"] == 1 and s["launches"]["predictive.backward"] == 1
    assert s["launches"]["conv_trunk"] == 1 and s["count"]["attack.iteration"] == 2


def test_conv_trunk_device_time_follows_the_correlation_to_its_ops():
    ops = [(140, MAIN, 11), (525, MAIN, 12), (600, AUTOGRAD, 13), (300, MAIN, 14), (130, MAIN, 15)]
    kernels = [(1000, 1040, 11), (1040, 1100, 12), (1100, 1200, 13), (1200, 1300, 14), (1300, 1301, 15),
               (1400, 1500, 99)]
    got = spans.linked_device_s("conv_trunk", PGD_SPANS, ops, kernels)
    assert got == pytest.approx(ms(40 + 60 + 1))  # 13: another thread; 14: the backward's; 99: no op


def _ctx(kind: str, s: dict) -> dict:
    return {"traffic": {"kind": kind}, "trace": {"units": 1}, "spans": s}


def _read(name: str, ctx: dict):
    return harness.read_metric(METRICS_DIR, name, ctx)


def test_the_metrics_select_from_a_known_stretch():
    kernels = [(0, 110, 1), (120, 200, 2), (240, 300, 3), (380, 520, 4), (1200, 1300, 5)]
    ops = [(140, MAIN, 2), (150, MAIN, 3)]
    launches = [130, 265, 505, 905]
    s = spans.reduce(PGD_SPANS, ops, launches, kernels, ms(2000), {"attack.iterations": 2, "attack.batches": 1})
    ctx = _ctx("pgd", s)
    assert _read("pgd.loop_self_ms_per_iter", ctx) == pytest.approx(1e3 * ms(150 + 80 + 60) / 2)
    assert _read("pgd.loop_idle_pct", ctx) == pytest.approx(100 * 10 / 2000)
    assert _read("predictive.host_ms_per_iter", ctx) == pytest.approx(1e3 * ms(130 + 190 + 190 + 200) / 2)
    assert _read("predictive.idle_pct", ctx) == pytest.approx(100 * (40 + 80 + 680) / 2000)
    assert _read("predictive.launches_per_iter", ctx) == pytest.approx(2 / 2)
    assert _read("conv_trunk.device_ms_per_iter", ctx) == pytest.approx(1e3 * ms(80 + 60) / 2)
    idle = 100 * (1 - s["busy_s"] / s["window_s"])
    assert _read("pgd.loop_idle_pct", ctx) + _read("predictive.idle_pct", ctx) <= idle
    svi_spans = [("svi.step", 0, 100, MAIN), ("svi.draws", 0, 10, MAIN), (spans.ADAM[0], 10, 12, MAIN),
                 ("svi.elbo.forward", 12, 40, MAIN), ("svi.elbo.backward", 40, 60, MAIN),
                 (spans.ADAM[1], 60, 80, MAIN), ("svi.accuracy", 80, 98, MAIN)]
    ctx = _ctx("svi", spans.reduce(svi_spans, [], [], [], ms(100), {"svi.steps": 1}))
    names = ("svi.draws_ms_per_step", "svi.elbo_ms_per_step", "svi.adam_ms_per_step", "svi.accuracy_ms_per_step")
    assert [_read(n, ctx) for n in names] == pytest.approx([1e3 * ms(t) for t in (10, 48, 22, 18)])
    for name in ("pgd.loop_self_ms_per_iter", "predictive.idle_pct", "conv_trunk.device_ms_per_iter"):
        assert _read(name, ctx) is None
    assert _read("svi.draws_ms_per_step", _ctx("pgd", s)) is None


def _traced_ctx(workload: str) -> dict:
    """A tiny run's ``ctx`` as the harness holds it when it reads the per-layer metrics."""
    spec = tiny_spec(workload)
    kind = importlib.import_module(f"benchmark.kinds.{spec['traffic']['kind']}")
    cell = kind.Cell(spec, 20261018, "cpu")
    window = cell.window(0.05)
    ctx = {"config": spec["config"], "traffic": spec["traffic"], "window": window, "setup_s": 0.0,
           "trace": tracing.profile(cell.stretch, "cpu")}
    cell.release()
    return ctx


def test_each_metric_reads_its_cells_alone_and_leaves_the_first_trace(workload):
    ctx = _traced_ctx(workload)
    first = copy.deepcopy(ctx["trace"])
    for metric in NEW:
        value = _read(metric["name"], ctx)
        if workload not in metric["workloads"]:
            assert value is None, metric["name"]
        elif metric["name"].endswith("_ms_per_iter") or metric["name"].endswith("_ms_per_step"):
            if metric["name"] != "conv_trunk.device_ms_per_iter":  # the CPU has no device time
                assert math.isfinite(value) and value > 0, metric["name"]
    assert ctx["trace"] == first
    assert set(ctx["trace"]) == {"units", "window_s", "busy_s", "launches", "device_ops", "idle_gaps"}
    units = spans.UNITS[ctx["traffic"]["kind"]]
    want = ctx["traffic"]["iterations"] if ctx["traffic"]["kind"] == "pgd" else ctx["traffic"]["trace"]["steps"]
    assert ctx["spans"]["counters"][units] == want


def test_a_program_without_spans_gives_no_reading(monkeypatch):
    from robustbnns_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "spans_on")
    ctx = _traced_ctx("model_0.pgd.s100")
    assert all(_read(m["name"], ctx) is None for m in NEW)
    assert ctx["spans"] is None
