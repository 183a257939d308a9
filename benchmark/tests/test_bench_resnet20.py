"""The cells ``resnet20.pgd.s100.eps8`` and ``model_0.svi.b128``, and
``resnet20``'s reference, work counts and two metrics, as the other test
files hold the first cells: the reference against the program's CPU path,
the counts against hand figures and the program's shapes, tiny runs of each
cell (sound: correct; the control and broken attacks: not correct), and
each metric on known stretches and where it finds nothing to read."""
from __future__ import annotations

import importlib
import json
import math
import os

import pytest
import torch
from conftest import ROOT, run_tiny, tiny_spec

from benchmark import harness, work
from benchmark import trace as tracing
from benchmark.reference import arch_resnet20, draws
from benchmark.reference import pgd as ref_pgd
from benchmark.reference.precision import PRECISIONS

NEW_CELLS = ["resnet20.pgd.s100.eps8", "model_0.svi.b128"]
METRICS_DIR = os.path.join(ROOT, "benchmark", "metrics")
RESNET = harness.cell_spec("resnet20.pgd.s100.eps8")
F64 = PRECISIONS["float64"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's convs: beside other test workers
    on the same cores, 8 OpenMP threads a process slowed a 40-iteration
    ResNet-20 PGD at S 3, batch 4 from 0.7 s to 262 s (one thread: 1.8 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _read(name: str, ctx: dict):
    return harness.read_metric(METRICS_DIR, name, ctx)


def _arch():
    from robustbnns_tpu_torch.models.architectures import build_architecture

    c = RESNET["config"]
    return build_architecture(c["architecture"], c["activation"], tuple(c["input_shape"]), c["output_size"],
                              c["hidden_size"], dataset_name=c["dataset"])


def test_resnet20_work_at_the_published_widths():
    # He et al.: 3x3 convs of 16 channels on 32x32 (7), 32 on 16x16 (6), 64 on 8x8 (6), then 64 -> 10
    c = RESNET["config"]
    stage = [2.0 * side * side * width * 9 * width for side, width in ((32, 16), (16, 32), (8, 64))]
    hand = 2.0 * 32 * 32 * 16 * 27 + 6 * stage[0] + stage[1] * (5 + 0.5) + stage[2] * (5 + 0.5) + 2.0 * 64 * 10
    assert sum(work.arch(c).forward_flops(c)) == hand == 81_102_080
    flops = work.pgd_iteration_flops(c, RESNET["traffic"])
    assert flops == 2 * 81_102_080 * 100 * 128 and round(flops / 1e12, 3) == 2.076
    assert sum(math.prod(s["w"]) + math.prod(s["b"]) for s in work.arch(c).param_shapes(c)) == 269_034


def test_resnet20_param_shapes_are_the_programs():
    c = RESNET["config"]
    arch = _arch()
    params = arch.init(torch.Generator().manual_seed(0))
    shapes = work.arch(c).param_shapes(c)
    assert [{k: tuple(v.shape) for k, v in layer.items()} for layer in params] == [
        {"b": s["b"], "w": s["w"]} for s in shapes]
    assert [s["fan_in"] for s in shapes] == [fan_in for fan_in, _ in arch.dims]
    assert c["parameters"] == 269_034 and c["input_shape"] == [32, 32, 3]


def test_resnet20_logits_predictive_and_gradient_are_the_programs():
    """The reference's float64 logits, predictive and input gradient against
    the program's unfused fresh-draw path at S 3, batch 4."""
    from robustbnns_tpu_torch.attacks.gradient_attacks import _input_gradients
    from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior
    from robustbnns_tpu_torch.predict import sample_eps, svi_predict

    arch = _arch()
    gen = torch.Generator().manual_seed(1)
    loc = [dict(layer) for layer in arch.init(gen)]
    rho = [{k: torch.full_like(v, -3.0) for k, v in layer.items()} for layer in loc]
    x = torch.rand((4, 32, 32, 3), generator=gen)
    labels = torch.tensor([0, 3, 9, 1])
    stacked = [{k: v + 0.1 * torch.randn((3,) + v.shape, generator=gen) for k, v in layer.items()} for layer in loc]
    want = arch.apply(tuple(stacked), x).double()
    got = arch_resnet20.logits([{k: v.double() for k, v in layer.items()} for layer in stacked], x, "relu", F64)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))

    post = MeanFieldPosterior(tuple(loc), tuple(rho))

    def forward(x, generator):
        return svi_predict(arch, post, x, sample_eps(post.loc, 3, generator=generator))

    state = torch.Generator().manual_seed(8).get_state()
    program = torch.Generator()
    program.set_state(state)
    want_grad = _input_gradients(forward, x, labels, program)
    program.set_state(state)
    want_probs = forward(x, program)
    w = ref_pgd.sampled_weights(loc, rho, draws.draw_seed(state), 3, False, torch.float64)
    probs, grad = ref_pgd.predictive_and_gradient(arch_resnet20, w, x, labels, "relu", F64)
    assert torch.allclose(probs, want_probs.double(), atol=1e-6)
    assert torch.allclose(grad, want_grad.double(), atol=1e-5 * float(grad.abs().max()))


@pytest.mark.parametrize("workload", NEW_CELLS)
def test_a_sound_run_is_correct(workload):
    result = run_tiny(tiny_spec(workload))
    assert result["correct"], result["checks"]
    assert result["metrics"] and list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", NEW_CELLS)
def test_the_control_is_not_correct_at_a_small_size(workload):
    spec = tiny_spec(workload)
    kind = importlib.import_module(f"benchmark.kinds.{spec['traffic']['kind']}")
    cell = kind.Cell(spec, 31, "cpu")
    cell.window(0.05)
    cell.release()
    checks = cell.check("tf32")
    assert any(not checks[name] <= limit for name, limit in spec["limits"].items()), json.dumps(checks)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_broken_attack_on_resnet20_is_not_correct(monkeypatch, fault):
    from robustbnns_tpu_torch.attacks import gradient_attacks as ga

    if fault == "unchanged":  # the step returns its state unchanged
        monkeypatch.setattr(ga, "_gradient_sign", lambda g: torch.zeros_like(g))
    elif fault == "half_batch":  # half of the batch left out, the rest's loss doubled
        ce = ga.ce_on_outputs

        def half(out, labels):
            h = out.shape[0] // 2
            return torch.cat([2.0 * ce(out[:h], labels[:h]), 0.0 * ce(out[h:], labels[h:])])

        monkeypatch.setattr(ga, "ce_on_outputs", half)
    else:  # an answer altered where it is produced
        pgd = ga.pgd_attack

        def altered(*args, **kwargs):
            x = pgd(*args, **kwargs).clone()
            x[0, 16, 16, 0] = 1.0 - x[0, 16, 16, 0]
            return x

        monkeypatch.setattr(ga, "pgd_attack", altered)
    result = run_tiny(tiny_spec("resnet20.pgd.s100.eps8"))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", NEW_CELLS)
def test_each_window_counts_its_own_work(workload):
    spec = tiny_spec(workload)
    kind = importlib.import_module(f"benchmark.kinds.{spec['traffic']['kind']}")
    cell = kind.Cell(spec, 5, "cpu")
    first, second = cell.window(0.0), cell.window(0.0)
    unit = spec["traffic"]["batch_size"] if spec["traffic"]["kind"] == "pgd" else spec["traffic"]["train_images"]
    assert first["units"] == second["units"] == unit


@pytest.mark.parametrize("workload", NEW_CELLS)
def test_each_listed_metric_reads_the_new_cells(workload):
    """A tiny traced run of each new cell: every per-layer metric that lists
    it reads a finite number there, but those of device time (the CPU has
    none); ``resnet.cudnn_convs_per_iter`` reads 19 (every conv on cuDNN)."""
    spec = tiny_spec(workload)
    kind = importlib.import_module(f"benchmark.kinds.{spec['traffic']['kind']}")
    cell = kind.Cell(spec, 20261018, "cpu")
    ctx = {"config": spec["config"], "traffic": spec["traffic"], "window": cell.window(0.05), "setup_s": 0.0,
           "trace": tracing.profile(cell.stretch, "cpu")}
    cell.release()
    device_time = ("conv_trunk.device_ms_per_iter", "resnet.trunk_roofline", "pgd.loop_idle_pct",
                   "predictive.idle_pct", "predictive.launches_per_iter", "pgd.launches_per_iter",
                   "svi.launches_per_step", "device_idle_pct.pgd", "device_idle_pct.svi")
    for name in spec["per_layer"]:
        value = _read(name, ctx)
        if name not in device_time:
            assert value is not None and math.isfinite(value), name
    if workload.startswith("resnet20"):
        assert _read("resnet.cudnn_convs_per_iter", ctx) == 19
        assert ctx["spans"]["counters"]["resnet.forwards"] == ctx["traffic"]["iterations"]


def _spans_ctx(counters: dict, device_s: float = 0.5, kind: str = "pgd") -> dict:
    return {"config": RESNET["config"], "traffic": dict(RESNET["traffic"], kind=kind), "trace": {"units": 40},
            "spans": {"counters": counters, "conv_trunk_device_s": device_s}}


def test_the_trunk_roofline_is_the_forwards_bound_over_their_device_time():
    # one forward at S 100, batch 128: 81,102,080 FLOP an image and draw, 15.49 ms at 67 TFLOP/s
    bound_s = 81_102_080 * 128 * 100 / work.PEAKS["fp32_flops_per_s"]
    assert bound_s == pytest.approx(15.494e-3, rel=1e-4)
    c = _spans_ctx({"attack.iterations": 40, "resnet.forwards": 40, "resnet.cudnn_convs": 760}, 40 * 0.05)
    assert _read("resnet.trunk_roofline", c) == pytest.approx(100 * bound_s / 0.05)
    assert _read("resnet.cudnn_convs_per_iter", c) == 19
    c = _spans_ctx({"attack.iterations": 40, "resnet.forwards": 40}, 40 * 0.05)  # no conv left to the library
    assert _read("resnet.cudnn_convs_per_iter", c) == 0


@pytest.mark.parametrize("case", ["no_resnet", "no_spans", "untraced", "svi", "no_device_time"])
def test_the_resnet_metrics_read_nothing_without_their_counters(case):
    c = _spans_ctx({"attack.iterations": 40, "resnet.forwards": 40, "resnet.cudnn_convs": 760})
    if case == "no_resnet":  # model_0's trunk, or a program without resnet20
        c = _spans_ctx({"attack.iterations": 40, "grouped_conv.fwd": 40})
    elif case == "no_spans":
        c["spans"] = None
    elif case == "untraced":
        c = dict(c, trace=None)
        del c["spans"]
    elif case == "svi":
        c = _spans_ctx({"svi.steps": 50, "resnet.forwards": 550}, kind="svi")
    if case == "no_device_time":  # the CPU: the roofline alone has nothing to read
        c["spans"]["conv_trunk_device_s"] = 0.0
        assert _read("resnet.cudnn_convs_per_iter", c) == 19
    else:
        assert _read("resnet.cudnn_convs_per_iter", c) is None
    assert _read("resnet.trunk_roofline", c) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", NEW_CELLS)
def test_the_control_is_not_correct_at_the_cells_size(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    spec = harness.cell_spec(workload)
    kind = importlib.import_module(f"benchmark.kinds.{spec['traffic']['kind']}")
    for seed in (41, 42):
        cell = kind.Cell(spec, seed, "cuda")
        cell.window(1.0)  # one batch or epoch: what a run's check keeps
        cell.release()
        checks = cell.check("tf32")
        assert any(not checks[name] <= limit for name, limit in spec["limits"].items()), json.dumps(checks)
