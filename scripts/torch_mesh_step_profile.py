#!/usr/bin/env python3
"""Where the host time of a meshed SVI step goes at one rank, on the card.

Run from the repo root on a machine with a card::

    python3 scripts/torch_mesh_step_profile.py [--steps 20]

Joins a one-rank NCCL group (``make_mesh``), then runs ``--steps`` SVI steps
of ``model_7`` (MNIST fc2-1024, batch 128, the 10-draw train accuracy) as one
``svi_train`` call without and with the mesh, in turns, three times each,
and prints each side's median wall ms a step; then one call of each side
under ``cProfile``, printing the functions with the most own time. The
card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", default=20, type=int)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("mesh_step_profile: no CUDA card")
    os.environ.setdefault("ROBUSTBNNS_SYNTH_CACHE", os.path.join(tempfile.gettempdir(), "robustbnns_synthetic"))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())

    from robustbnns_tpu_torch.config import saved_BNNs
    from robustbnns_tpu_torch.data.datasets import load_dataset
    from robustbnns_tpu_torch.inference.svi import svi_train
    from robustbnns_tpu_torch.models.architectures import build_architecture
    from robustbnns_tpu_torch.parallel import make_mesh

    cfg = saved_BNNs["model_7"]
    x, y, _, _, shape, classes = load_dataset("mnist", n_inputs=60000, fallback="synthetic")
    n = args.steps * 128
    x = torch.as_tensor(x[:n], device="cuda")
    y = torch.as_tensor(y[:n], device="cuda")
    arch = build_architecture(cfg.architecture, cfg.activation, shape, classes, cfg.hidden_size, cfg.dataset)
    mesh = make_mesh(device="cuda")

    def run(m):
        return svi_train(arch, x, y, epochs=1, lr=cfg.lr, batch_size=128, verbose=False, device="cuda", mesh=m)

    def step_ms(m) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(m)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / args.steps

    run(None), run(mesh)  # warm
    walls = {"unmeshed": [], "meshed": []}
    for _ in range(3):
        for label, m in (("unmeshed", None), ("meshed", mesh), ("meshed", mesh), ("unmeshed", None)):
            walls[label].append(step_ms(m))
    for label, values in walls.items():
        print(f"[step-profile] {label}: {statistics.median(values):.3f} ms a step (median of {len(values)}: "
              f"{[round(v, 3) for v in values]})")
    for label, m in (("unmeshed", None), ("meshed", mesh)):
        profiler = cProfile.Profile()
        profiler.enable()
        run(m)
        torch.cuda.synchronize()
        profiler.disable()
        out = io.StringIO()
        pstats.Stats(profiler, stream=out).sort_stats("tottime").print_stats(18)
        print(f"[step-profile] {label} under cProfile, {args.steps} steps:\n{out.getvalue()}")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
