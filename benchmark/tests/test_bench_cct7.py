"""The cells ``cct7.pgd.s10.eps8`` and ``model_0.pgd.s10``, and ``cct7``'s
reference, work counts and two metrics, as ``test_bench_resnet20.py`` holds
``resnet20``'s: the benchmark's reference against the tests' reference and
the program's CPU path, the counts against hand figures and the program's
shapes, tiny runs of each cell (sound: correct; the control: not correct),
and each new metric on known stretches and where it finds nothing to
read."""
from __future__ import annotations

import importlib
import json
import math
import os
import sys

import pytest
import torch
from conftest import ROOT, run_tiny, tiny_spec

from benchmark import harness, work
from benchmark import trace as tracing
from benchmark.reference import arch_cct7, draws
from benchmark.reference import pgd as ref_pgd
from benchmark.reference.precision import PRECISIONS

sys.path.insert(0, os.path.join(ROOT, "tests"))
import cct7_reference  # noqa: E402

NEW_CELLS = ["cct7.pgd.s10.eps8", "model_0.pgd.s10"]
METRICS_DIR = os.path.join(ROOT, "benchmark", "metrics")
CCT = harness.cell_spec("cct7.pgd.s10.eps8")
F64 = PRECISIONS["float64"]
SMALL = dict(CCT["config"], hidden_size=16, input_shape=[8, 8, 3])  # 16 tokens of 16, 4 heads of 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as in ``test_bench_resnet20.py``: beside other
    test workers, many OpenMP threads a process slow small products."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _read(name: str, ctx: dict):
    return harness.read_metric(METRICS_DIR, name, ctx)


def _arch(config: dict):
    from robustbnns_tpu_torch.models.architectures import build_architecture

    return build_architecture(config["architecture"], config["activation"], tuple(config["input_shape"]),
                              config["output_size"], config["hidden_size"], dataset_name=config["dataset"])


def _tiny(workload: str) -> dict:
    """The tiny spec; for ``cct7`` on 8×8 images too, 16 tokens (256 make the
    attack's 40 iterations slow on the CPU)."""
    spec = tiny_spec(workload)
    if workload.startswith("cct7"):
        spec["config"] = dict(spec["config"], input_shape=[8, 8, 3])
    return spec


def _stacked(seed: int, n: int = 3):
    loc, _ = _seeded(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    return [{k: v + 0.05 * torch.randn((n,) + v.shape, generator=gen) for k, v in layer.items()} for layer in loc]


def _seeded(seed: int):
    from benchmark import inputs

    return inputs.seeded_posterior(SMALL, inputs.generator("cpu", seed, "posterior"))


def test_the_benchmarks_reference_is_the_tests_reference():
    """``benchmark/reference/arch_cct7.py`` (each draw under a checkpoint)
    against ``tests/cct7_reference.py`` in float64: the logits, and the input
    gradient of the attack's loss through the checkpoints."""
    stacked = _stacked(1)
    gen = torch.Generator().manual_seed(2)
    x, labels = torch.rand((2, 8, 8, 3), generator=gen, dtype=torch.float64), torch.tensor([3, 7])
    got = arch_cct7.logits(stacked, x, "relu", F64)
    want = cct7_reference.stacked_logits(stacked, x)
    assert got.shape == (3, 2, 10) and torch.allclose(got, want, rtol=0, atol=1e-12)
    probs, grad = ref_pgd.predictive_and_gradient(arch_cct7, stacked, x, labels, "relu", F64)
    want_probs, want_grad = cct7_reference.predictive_and_input_gradient(stacked, x, labels)
    assert torch.allclose(probs, want_probs, rtol=0, atol=1e-14)
    assert torch.allclose(grad, want_grad, rtol=0, atol=1e-12 * float(want_grad.abs().max()))


def test_cct7_work_at_the_published_widths():
    # Hassani et al.'s CCT-7/3x1: a 3x3 conv 3 -> 256 on 32x32, then per layer q|k|v and W_o
    # (256 -> 1024 over 256 tokens), 4 heads' q·kᵀ and p·v (256 x 256 x 64 each), the MLP 256 -> 512 -> 256
    c = CCT["config"]
    layer = 2.0 * 256 * 256 * 1024 + 4 * 2 * 2.0 * 256 * 256 * 64 + 2 * 2.0 * 256 * 256 * 512
    hand = 2.0 * 32 * 32 * 256 * 27 + 7 * layer + 2 * 2.0 * 256 * 256 + 2.0 * 256 * 10
    assert layer == 335_544_320
    assert sum(work.arch(c).forward_flops(c)) == hand == 2_363_233_280
    flops = work.pgd_iteration_flops(c, CCT["traffic"])
    assert flops == 2 * 2_363_233_280 * 10 * 128 and round(flops / 1e12, 2) == 6.05
    assert sum(math.prod(s["w"]) + math.prod(s["b"]) for s in work.arch(c).param_shapes(c)) == 3_760_139
    assert (c["parameters"], c["layers"], c["heads"], c["mlp"], c["tokens"]) == (3_760_139, 7, 4, 512, 256)
    assert c["fused_attacks"] is False and c["input_shape"] == [32, 32, 3]


@pytest.mark.parametrize("config", [CCT["config"], SMALL], ids=["published", "small"])
def test_cct7_param_shapes_are_the_programs(config):
    """Leaf for leaf: the work module's 39 shapes and fan-ins are the program's tree and ``dims``."""
    arch = _arch(config)
    params = arch.init(torch.Generator().manual_seed(0))
    shapes = work.arch(config).param_shapes(config)
    assert len(shapes) == len(params) == 39
    assert [{k: tuple(v.shape) for k, v in layer.items()} for layer in params] == [
        {"b": s["b"], "w": s["w"]} for s in shapes]
    assert [s["fan_in"] for s in shapes] == [fan_in for fan_in, _ in arch.dims]


def test_cct7_predictive_and_gradient_are_the_programs():
    """The reference's float64 predictive and input gradient against the
    program's unfused fresh-draw path at S 3, batch 2, the draws worked out
    again from the forward's seed."""
    from robustbnns_tpu_torch.attacks.gradient_attacks import _input_gradients
    from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior
    from robustbnns_tpu_torch.predict import sample_eps, svi_predict

    arch = _arch(SMALL)
    loc, rho = _seeded(3)
    post = MeanFieldPosterior(tuple(loc), tuple(rho))
    gen = torch.Generator().manual_seed(4)
    x, labels = torch.rand((2, 8, 8, 3), generator=gen), torch.tensor([0, 9])

    def forward(x, generator):
        return svi_predict(arch, post, x, sample_eps(post.loc, 3, generator=generator))

    state = torch.Generator().manual_seed(8).get_state()
    program = torch.Generator()
    program.set_state(state)
    want_grad = _input_gradients(forward, x, labels, program)
    program.set_state(state)
    want_probs = forward(x, program)
    w = ref_pgd.sampled_weights(loc, rho, draws.draw_seed(state), 3, False, torch.float64)
    probs, grad = ref_pgd.predictive_and_gradient(arch_cct7, w, x, labels, "relu", F64)
    assert torch.allclose(probs, want_probs.double(), atol=1e-6)
    assert torch.allclose(grad, want_grad.double(), atol=1e-5 * float(grad.abs().max()))


@pytest.mark.parametrize("workload", NEW_CELLS)
def test_a_sound_run_is_correct(workload):
    result = run_tiny(_tiny(workload))
    assert result["correct"], result["checks"]
    assert result["metrics"] and list(result)[-1] == "checks"


@pytest.mark.parametrize("workload", NEW_CELLS)
def test_the_control_is_not_correct_at_a_small_size(workload):
    spec = _tiny(workload)
    kind = importlib.import_module(f"benchmark.kinds.{spec['traffic']['kind']}")
    cell = kind.Cell(spec, 31, "cpu")
    cell.window(0.05)
    cell.release()
    checks = cell.check("tf32")
    assert any(not checks[name] <= limit for name, limit in spec["limits"].items()), json.dumps(checks)


@pytest.mark.parametrize("workload", NEW_CELLS)
def test_each_listed_metric_reads_the_new_cells(workload):
    """A tiny traced run of each new cell: every per-layer metric that lists
    it reads a finite number there, but those of device time (the CPU has
    none); the spans stretch counts a ``cct7`` forward an iteration, 7 plain
    attention calls each on the CPU and no fused one, so that
    ``cct.attention_ms_per_iter`` reads nothing."""
    spec = _tiny(workload)
    kind = importlib.import_module(f"benchmark.kinds.{spec['traffic']['kind']}")
    cell = kind.Cell(spec, 20261019, "cpu")
    ctx = {"config": spec["config"], "traffic": spec["traffic"], "window": cell.window(0.05), "setup_s": 0.0,
           "trace": tracing.profile(cell.stretch, "cpu")}
    cell.release()
    device_time = ("conv_trunk.device_ms_per_iter", "pgd.loop_idle_pct", "predictive.idle_pct",
                   "predictive.launches_per_iter", "pgd.launches_per_iter", "device_idle_pct.pgd",
                   "grouped_conv_roofline", "grouped_conv.dgrad_roofline", "cct.trunk_roofline",
                   "cct.attention_ms_per_iter")
    for name in spec["per_layer"]:
        value = _read(name, ctx)
        if name not in device_time:
            assert value is not None and math.isfinite(value), name
    counters = ctx["spans"]["counters"]
    if workload.startswith("cct7"):
        iterations = ctx["traffic"]["iterations"]
        assert counters["cct.forwards"] == iterations and counters["cct.plain_attention"] == 7 * iterations
        assert "cct.attention" not in counters and _read("cct.attention_ms_per_iter", ctx) is None
        assert set(spec["per_layer"]) >= {"cct.attention_ms_per_iter", "cct.trunk_roofline",
                                          "conv_trunk.device_ms_per_iter"}
    else:
        assert "cct.forwards" not in counters
        assert set(spec["per_layer"]) >= {"grouped_conv_roofline", "grouped_conv.dgrad_roofline"}


def _ctx(counters: dict, device_ops: dict, device_s: float = 0.5, kind: str = "pgd") -> dict:
    return {"config": CCT["config"], "traffic": dict(CCT["traffic"], kind=kind),
            "trace": {"units": 40, "device_ops": device_ops},
            "spans": {"counters": counters, "conv_trunk_device_s": device_s}}


FMHA = {"fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel<float>::Params)": 0.3,
        "fmha_cutlassB_f32_aligned_64x64_k64_sm80(PyTorchMemEffAttention::AttentionBackwardKernel<float>)": 0.5,
        "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x16_warpgroupsize1x1x1_execute": 2.0,
        "void at::native::vectorized_layer_norm_kernel<float, float>(int, float, float const*)": 0.4}


def test_the_new_metrics_read_known_stretches():
    # one forward at S 10, batch 128: 2,363,233,280 FLOP an image and draw, 45.15 ms at 67 TFLOP/s
    bound_s = 2_363_233_280 * 128 * 10 / work.PEAKS["fp32_flops_per_s"]
    assert bound_s == pytest.approx(45.15e-3, rel=1e-3)
    counters = {"attack.iterations": 40, "cct.forwards": 40, "cct.attention": 280}
    c = _ctx(counters, FMHA, 40 * 0.09)
    assert _read("cct.trunk_roofline", c) == pytest.approx(100 * bound_s / 0.09)
    assert _read("cct.attention_ms_per_iter", c) == pytest.approx(1e3 * 0.8 / 40)
    own = _ctx(counters, {"cct_attention_fwd_f32(float const*)": 0.2, "ampere_sgemm_128x64_nn": 1.0})
    assert _read("cct.attention_ms_per_iter", own) == pytest.approx(1e3 * 0.2 / 40)


@pytest.mark.parametrize("case", ["no_cct", "plain_route", "no_spans", "untraced", "svi", "no_device_time"])
def test_the_new_metrics_read_nothing_without_their_mechanism(case):
    c = _ctx({"attack.iterations": 40, "cct.forwards": 40, "cct.attention": 280}, FMHA)
    if case == "no_cct":  # resnet20's trunk, or a program without cct7
        c = _ctx({"attack.iterations": 40, "resnet.forwards": 40}, {"ampere_sgemm_128x64_nn": 1.0})
    elif case == "plain_route":  # the attention on the plain route: its kernels are GEMMs like the rest
        c = _ctx({"attack.iterations": 40, "cct.forwards": 40, "cct.plain_attention": 280}, FMHA)
        assert _read("cct.trunk_roofline", c) is not None
        assert _read("cct.attention_ms_per_iter", c) is None
        return
    elif case == "no_spans":
        c["spans"] = None
    elif case == "untraced":
        c = dict(c, trace=None)
        del c["spans"]
    elif case == "svi":
        c = _ctx({"svi.steps": 50, "cct.forwards": 550, "cct.attention": 3850}, FMHA, kind="svi")
    if case == "no_device_time":  # the CPU: no kernel, no device time
        c["spans"]["conv_trunk_device_s"] = 0.0
        c["trace"]["device_ops"] = {}
    assert _read("cct.trunk_roofline", c) is None
    assert _read("cct.attention_ms_per_iter", c) is None


@pytest.mark.cuda
def test_the_control_is_not_correct_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    spec = harness.cell_spec("cct7.pgd.s10.eps8")
    kind = importlib.import_module(f"benchmark.kinds.{spec['traffic']['kind']}")
    for seed in (41, 42):
        cell = kind.Cell(spec, seed, "cuda")
        cell.window(1.0)  # one batch: what a run's check keeps
        cell.release()
        checks = cell.check("tf32")
        assert any(not checks[name] <= limit for name, limit in spec["limits"].items()), json.dumps(checks)
