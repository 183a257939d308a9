#!/usr/bin/env python3
"""Where the time of one HMC potential evaluation goes under each precision, on the card.

Run from the repo root on a machine with a card::

    python3 scripts/torch_bf16_eval_profile.py [--batch 5000] [--evals 10]

One value-and-gradient evaluation of ``model_3``'s potential (Fashion-MNIST
fc2-1024, D = 1,863,690, random inputs and labels at ``--batch``) through
``inference.hmc._Potential`` at ``precision="high"`` (exact f32) and under the
bf16 scope of ``precision="default"``: the median wall ms of ``--evals``
evaluations between two synchronisations, in turns, then each side's device
kernels under ``torch.profiler`` over ``--evals`` evaluations (device ms an
evaluation by kernel, largest first). The card's name and power limit come
first.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", default=5000, type=int)
    parser.add_argument("--evals", default=10, type=int)
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("bf16_eval_profile: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    from robustbnns_tpu_torch.inference import hmc
    from robustbnns_tpu_torch.models.architectures import build_architecture
    from robustbnns_tpu_torch.models.bnn import bnn_potential
    from robustbnns_tpu_torch.utils.device import resolve_device
    from robustbnns_tpu_torch.utils.pytree import flatten_tree_to_vector

    device = resolve_device("cuda")
    arch = build_architecture("fc2", "leaky", (28, 28, 1), 10, 1024, "fashion_mnist")
    gen = torch.Generator(device=device).manual_seed(0)
    q, unravel = flatten_tree_to_vector(arch.init(gen))
    data = (torch.rand((args.batch, 28, 28, 1), generator=gen, device=device),
            torch.randint(0, 10, (args.batch,), generator=gen, device=device))
    sides = {"high": hmc._Potential(bnn_potential(arch, unravel), data),
             "default": hmc._Potential(bnn_potential(arch, unravel), data, bf16=True)}

    def run(vg):
        for _ in range(args.evals):
            vg(q)
        torch.cuda.synchronize()

    walls = {name: [] for name in sides}
    for name in ("high", "default", "default", "high", "high", "default"):
        run(sides[name])
        t0 = time.perf_counter()
        run(sides[name])
        walls[name].append(1e3 * (time.perf_counter() - t0) / args.evals)
    for name, vg in sides.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run(vg)
        rows = sorted(((e.key, e.self_device_time_total / 1e3 / args.evals, e.count // args.evals)
                       for e in prof.key_averages() if e.self_device_time_total > 0), key=lambda r: -r[1])
        total = sum(ms for _, ms, _ in rows)
        print(f"[{name}] B={args.batch}: {statistics.median(walls[name]):.3f} ms wall an evaluation (medians of "
              f"{[round(w, 3) for w in walls[name]]}), {total:.3f} ms of device kernels an evaluation")
        for key, ms, calls in rows[:12]:
            print(f"[{name}]   {ms:8.4f} ms  x{calls:<3d} {key[:110]}")


if __name__ == "__main__":
    main()
