"""The control, the reference computed in TF32 and put in the program's place,
comes out not correct against each cell's limits: at a CPU's size here, and
at the cell's own size on the card (``-m cuda``; the readings behind the
limits come from ``benchmark/tools/readings.py --control``)."""
from __future__ import annotations

import importlib
import json

import pytest
from conftest import tiny_spec

from benchmark import harness


def _control(spec: dict, seed: int, device, seconds: float) -> dict:
    kind = importlib.import_module(f"benchmark.kinds.{spec['traffic']['kind']}")
    cell = kind.Cell(spec, seed, device)
    cell.window(seconds)
    cell.release()
    return cell.check("tf32")


def _fails(checks: dict, limits: dict) -> bool:
    return any(not checks[name] <= limit for name, limit in limits.items())


def test_the_control_is_not_correct_at_a_small_size(workload):
    spec = tiny_spec(workload)
    checks = _control(spec, 31, "cpu", 0.05)
    assert _fails(checks, spec["limits"]), json.dumps(checks)


@pytest.mark.cuda
def test_the_control_is_not_correct_at_the_cells_size(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    spec = harness.cell_spec(workload)
    seconds = 12.0 if workload.startswith("model_0") else 2.0  # the batches that a run's check keeps
    for seed in (41, 42, 43):
        checks = _control(spec, seed, "cuda", seconds)
        assert _fails(checks, spec["limits"]), json.dumps(checks)
