"""The work counts against hand figures and against the program's own shapes."""
from __future__ import annotations

import json
import math
import os

import pytest
import torch
from conftest import ROOT

from benchmark import work


def _config(name: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


PGD_S100 = {"n_samples": 100, "batch_size": 128}


def test_model_7_pgd_iteration_at_s100():
    # 4 S B sum(I O): forward and input gradient of 784-1024-1024-10
    assert work.pgd_iteration_flops(_config("model_7"), PGD_S100) == 4 * 100 * 128 * 1_861_632
    assert round(work.pgd_iteration_flops(_config("model_7"), PGD_S100) / 1e9, 1) == 95.3


def test_model_0_pgd_iteration_at_s100():
    per_image_draw = 2 * (24 * 24 * 32 * 25 + 8 * 8 * 512 * 800 + 7 * 7 * 512 * 10)  # 53.85 MFLOP forward
    assert work.pgd_iteration_flops(_config("model_0"), PGD_S100) == 2 * per_image_draw * 100 * 128
    assert round(work.pgd_iteration_flops(_config("model_0"), PGD_S100) / 1e12, 3) == 1.379


def test_model_7_svi_step():
    fwd = 2 * 1_861_632
    hand = 128 * (fwd * 12 + 2 * (1024 * 1024 + 1024 * 10))  # ELBO fwd + weight grads + 10 draws, + input grads
    assert work.svi_step_flops(_config("model_7"), {"batch_size": 128, "accuracy_samples": 10}) == hand


def test_sampled_dense_bound_at_s10_is_the_kernel_tables():
    # chip_smoke's bounds of the six calls at B = 128, S = 10 (PERF.md's kernel table): 0.1448 ms
    ms = 1e3 * work.sampled_dense_iteration_bound_s(_config("model_7"), {"n_samples": 10, "batch_size": 128})
    assert ms == pytest.approx(0.0307 * 2 + 0.0401 * 2 + 0.0016 * 2, abs=5e-4)


@pytest.mark.parametrize("name", ["model_7", "model_0"])
def test_param_shapes_are_the_programs(name):
    from robustbnns_tpu_torch.models.architectures import build_architecture

    c = _config(name)
    arch = build_architecture(c["architecture"], c["activation"], tuple(c["input_shape"]), c["output_size"],
                              c["hidden_size"], dataset_name=c["dataset"])
    params = arch.init(torch.Generator().manual_seed(0))
    shapes = work.arch(c).param_shapes(c)
    assert [{k: tuple(v.shape) for k, v in layer.items()} for layer in params] == [
        {"b": s["b"], "w": s["w"]} for s in shapes]
    assert [s["fan_in"] for s in shapes] == [fan_in for fan_in, _ in arch.dims]
    assert sum(math.prod(s["w"]) + math.prod(s["b"]) for s in shapes) == c["parameters"]
