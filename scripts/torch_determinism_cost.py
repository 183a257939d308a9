#!/usr/bin/env python3
"""What cuDNN's deterministic algorithms cost an ensemble's training on the card.

Trains the 10 conv-512 members of ``model_0`` for one epoch on the first
5,000 MNIST surrogate images, twice as every entry point runs them (cuDNN held
to its deterministic algorithms by ``utils.device.exact_f32``) and twice with
cuDNN free to choose, and prints each epoch's seconds, whether each pair gave
bit-equal stacked leaves, and the ratio. TF32 stays off in both. Run once from
the repo root on a machine with a card::

    python3 scripts/torch_determinism_cost.py [--images 5000] [--members 10]
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
    parser.add_argument("--images", default=5000, type=int)
    parser.add_argument("--members", default=10, type=int)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("determinism_cost: no CUDA card")

    from robustbnns_tpu_torch.config import saved_NNs
    from robustbnns_tpu_torch.data.datasets import load_dataset
    from robustbnns_tpu_torch.models import build_architecture, train_ensemble
    from robustbnns_tpu_torch.utils import device as device_module
    from robustbnns_tpu_torch.utils.pytree import tree_leaves

    cfg = saved_NNs["model_0"]
    x, y, _, _, shape, out = load_dataset(cfg.dataset, n_inputs=60000, fallback="synthetic")
    x = torch.as_tensor(x[: args.images], device="cuda")
    y = torch.as_tensor(y[: args.images], device="cuda")
    arch = build_architecture(cfg.architecture, cfg.activation, shape, out, cfg.hidden_size, cfg.dataset)

    def epoch():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = train_ensemble(arch, x, y, ensemble_size=args.members, epochs=1, lr=0.01, batch_size=100,
                               device="cuda", verbose=False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, tree_leaves(model.stacked_params)

    def pair():
        epoch()  # warm: cuDNN's choice of algorithm and the allocator
        (t1, a), (t2, b) = epoch(), epoch()
        return [t1, t2], sum(not torch.equal(u, v) for u, v in zip(a, b)), len(a)

    pinned_s, pinned_parted, n_leaves = pair()
    exact_f32 = device_module.exact_f32

    def free_f32():
        exact_f32()
        torch.backends.cudnn.deterministic = False

    device_module.exact_f32 = free_f32
    try:
        free_s, free_parted, _ = pair()
    finally:
        device_module.exact_f32 = exact_f32
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    cost = statistics.median(pinned_s) - statistics.median(free_s)
    print(f"{card}: {args.members} conv-512 members, one epoch of {args.images} images at batch 100: "
          f"deterministic cuDNN {[round(t, 3) for t in pinned_s]} s ({pinned_parted} of {n_leaves} leaves parted), "
          f"free {[round(t, 3) for t in free_s]} s ({free_parted} of {n_leaves} parted); determinism costs "
          f"{cost:.3f} s an epoch ({cost * 60000 / args.images:.3f} s scaled to 60,000 images), "
          f"x{statistics.median(pinned_s) / statistics.median(free_s):.3f}")


if __name__ == "__main__":
    main()
