"""Inputs and weights come from the seed alone."""
from __future__ import annotations

import json
import os

import torch
from conftest import ROOT

from benchmark import inputs

with open(os.path.join(ROOT, "benchmark", "configs", "model_0.json")) as f:
    CONFIG = json.load(f)


def _made(seed: int):
    loc, rho = inputs.seeded_posterior(CONFIG, inputs.generator("cpu", seed, "posterior"))
    data = inputs.generator("cpu", seed, "images")
    return [loc, rho, inputs.images(CONFIG, data, (2, 3)), inputs.labels(CONFIG, data, (2, 3)),
            inputs.normal_posterior(CONFIG, inputs.generator("cpu", seed, "init"))]


def _flat(made) -> list:
    out = []
    for item in made:
        if torch.is_tensor(item):
            out.append(item)
        elif isinstance(item, dict):
            out.extend(item[k] for k in sorted(item))
        else:
            out.extend(_flat(item))
    return out


def test_the_same_seed_gives_the_same_inputs():
    seed = 2**31 + 12345  # the driver's seeds pass 32 signed bits
    assert all(torch.equal(a, b) for a, b in zip(_flat(_made(seed)), _flat(_made(seed))))


def test_another_seed_gives_other_inputs():
    a, b = _flat(_made(1)), _flat(_made(2))
    images = [i for i, t in enumerate(a) if t.dim() == 5][0]
    assert not torch.equal(a[images], b[images])
    assert not torch.equal(a[0], b[0])


def test_streams_and_sizes():
    assert inputs.sub_seed(7, "images") == inputs.sub_seed(7, "images") != inputs.sub_seed(7, "posterior")
    assert 0 <= inputs.sub_seed(2**40, "x") < 2**63
    x = _made(3)[2]
    assert x.shape == (2, 3, 28, 28, 1) and float(x.min()) >= 0 and float(x.max()) < 1
    loc, rho = _made(3)[:2]
    assert [tuple(layer["w"].shape) for layer in loc] == [(5, 5, 1, 32), (5, 5, 32, 512), (25088, 10)]
    scale = torch.nn.functional.softplus(rho[1]["w"][0, 0, 0, 0])
    assert abs(float(scale) - 0.01 / 800**0.5) < 1e-9


def test_each_window_counts_its_own_work(workload):
    import importlib

    from conftest import tiny_spec

    spec = tiny_spec(workload)
    kind = importlib.import_module(f"benchmark.kinds.{spec['traffic']['kind']}")
    cell = kind.Cell(spec, 5, "cpu")
    first, second = cell.window(0.0), cell.window(0.0)
    unit = spec["traffic"]["batch_size"] if spec["traffic"]["kind"] == "pgd" else spec["traffic"]["train_images"]
    assert first["units"] == second["units"] == unit
