"""Shared helpers of the benchmark's CPU tests: the repository's cells cut to
sizes a CPU run holds (the widths shrunk, the traffic's work too), run
through the harness with its look for a card skipped."""
from __future__ import annotations

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def tiny_spec(workload: str, **traffic) -> dict:
    """``workload``'s spec at hidden size 16, S = 3, batches of 4 (PGD) or
    epochs of 18 rows in 5 steps of 4, the last masked (SVI), limits and everything else as committed."""
    spec = harness.cell_spec(workload)
    spec["config"] = dict(spec["config"], hidden_size=16)
    t = dict(spec["traffic"])
    if t["kind"] == "pgd":
        t.update(n_samples=3, batch_size=4, pool_batches=3, trace={"min_batches": 1, "min_seconds": 0.0})
    else:
        t.update(batch_size=4, train_images=18, trace={"steps": 2})
    t.update(traffic)
    spec["traffic"] = t
    return spec


def run_tiny(spec: dict, seed: int = 20261018) -> dict:
    return harness.run_cell(spec, seed, 0.05, False, "cpu", time.time())


@pytest.fixture(params=["model_7.pgd.s100", "model_0.pgd.s100", "model_7.svi.b128"])
def workload(request) -> str:
    return request.param
