#!/usr/bin/env python3
"""Which device kernels of a ``model_0`` PGD iteration run inside
``aten::convolution_backward``, on one CUDA card.

Run from the repo root::

    python3 scripts/torch_conv_dgrad_split.py [--iterations 2] [--seed 1]

Builds the ``model_0.pgd.s100`` cell's BNN, posterior and first batch
(``benchmark/kinds/pgd.py``: S 100, B 128), warms the shapes, then profiles
``--iterations`` PGD iterations under ``torch.profiler`` and ties each kernel
to its launching host op by the profiler's correlation. Prints one line a
kernel name, most device time first: ms and launches an iteration, and
whether an ``aten::convolution_backward`` launched it (the conv trunk's
library backward: the first conv's input gradient, and the grouped conv's
weight and bias gradients, or its input gradient where no kernel computes
it), then the totals of both groups. The last line is the same as JSON.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.kinds.pgd import Cell  # noqa: E402
from robustbnns_tpu_torch.attacks.gradient_attacks import pgd_attack  # noqa: E402

OP = "aten::convolution_backward"


def split(events) -> dict:
    """Device seconds and launches by kernel name, and whether ``OP`` launched it."""
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    inside = defaultdict(list)
    for e in host:
        if e.name() == OP:
            inside[e.start_thread_id()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    ids = {e.correlation_id() for e in host if e.linked_correlation_id() == 0
           and any(start <= e.start_ns() <= end for start, end in inside.get(e.start_thread_id(), ()))}
    ranges = {e.name() for e in host}
    rows = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0 or e.name() in ranges:
            continue
        row = rows[(e.name(), e.linked_correlation_id() in ids)]
        row[0] += 1e-9 * e.duration_ns()
        row[1] += 1
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iterations", type=int, default=2)
    parser.add_argument("--seed", type=int, default=1)
    args = parser.parse_args()
    spec = harness.cell_spec("model_0.pgd.s100")
    traffic = spec["traffic"]
    cell = Cell(spec, args.seed, "cuda")
    forward = cell.model.predictive_fn(traffic["n_samples"])

    def run():
        pgd_attack(forward, cell.x[0], cell.y[0], epsilon=traffic["epsilon"], iters=args.iterations,
                   generator=torch.Generator().manual_seed(args.seed))
        torch.cuda.synchronize()

    run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    rows = split(prof.profiler.kineto_results.events())
    n = args.iterations
    totals = {True: [0.0, 0], False: [0.0, 0]}
    print(f"{torch.cuda.get_device_name(0)}; model_0 PGD S {traffic['n_samples']} B {traffic['batch_size']}, "
          f"{n} iterations; ms and launches an iteration")
    for (name, by_op), (seconds, launches) in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        totals[by_op][0] += seconds
        totals[by_op][1] += launches
        where = OP if by_op else "elsewhere"
        print(f"{1e3 * seconds / n:9.3f} ms {launches / n:8.2f}  {where:28s} {name[:150]}")
    summary = {("in " + OP if by_op else "elsewhere"): {"ms": 1e3 * s / n, "launches": k / n}
               for by_op, (s, k) in totals.items()}
    print(json.dumps({"dgrad_split": summary}))


if __name__ == "__main__":
    main()
