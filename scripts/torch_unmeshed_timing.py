#!/usr/bin/env python3
"""Wall time of the unmeshed SVI epoch and fused PGD of ``model_7`` on the
card, for the port of one tree: to hold a change's paths without a mesh to
an earlier tree's, in turns in one call.

Run from the repo root on a machine with a card, once per tree, alternating::

    git archive <commit> | tar -x -C build/parent_tree
    for t in build/parent_tree . . build/parent_tree; do
        python3 scripts/torch_unmeshed_timing.py --tree $t; done

Each run imports ``robustbnns_tpu_torch`` from ``--tree`` (its kernels build
into that tree's ``build/kernels``), trains ``model_7`` (MNIST fc2-1024) for
``--epochs`` SVI epochs of 60,000 surrogate images at batch 128 (the 10-draw
train accuracy on), then runs 40-step fused PGD on 256 images at S = 10,
``--reps`` times, on a seeded random posterior; it prints one JSON line:
the tree, the card's name and power limit, each epoch's seconds and each
PGD run's ms per iteration.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--epochs", default=2, type=int)
    parser.add_argument("--reps", default=5, type=int)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch

    if not torch.cuda.is_available():
        sys.exit("unmeshed_timing: no CUDA card")
    os.environ.setdefault("ROBUSTBNNS_SYNTH_CACHE", os.path.join(tempfile.gettempdir(), "robustbnns_synthetic"))

    from robustbnns_tpu_torch.attacks.gradient_attacks import attack
    from robustbnns_tpu_torch.config import saved_BNNs
    from robustbnns_tpu_torch.data.datasets import load_dataset
    from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior, svi_train
    from robustbnns_tpu_torch.models.bnn import BNN

    cfg = saved_BNNs["model_7"]
    x, y, x_test, y_test, shape, classes = load_dataset("mnist", n_inputs=60000, fallback="synthetic")
    bnn = BNN.from_config(cfg, shape, classes, device="cuda")
    _, history = svi_train(bnn.arch, x, y, epochs=args.epochs, lr=cfg.lr, batch_size=128, verbose=False,
                           device="cuda")

    gen = torch.Generator(device="cuda").manual_seed(7)
    loc = bnn.arch.init(gen)  # softplus(rho) = 1e-2 of each layer's init bound, as chip_smoke.py's posterior
    rho = tuple({k: torch.full_like(v, math.log(math.expm1(1e-2 / math.sqrt(i)))) for k, v in layer.items()}
                for layer, (i, _) in zip(loc, bnn.arch.dims))
    bnn.posterior = MeanFieldPosterior(loc, rho)
    xs = torch.as_tensor(x_test[:256], device="cuda")
    ys = torch.as_tensor(y_test[:256], device="cuda")

    def pgd_ms() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        attack(bnn, xs, ys, method="pgd", n_samples=10, fused=True, save=False, verbose=False)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (2 * 40)  # two batches of 128, 40 iterations each

    pgd_ms()  # the kernels' first launch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"tree": args.tree, "card": smi, "svi_epoch_s": history["seconds"],
                      "pgd_iteration_ms": [pgd_ms() for _ in range(args.reps)]}))


if __name__ == "__main__":
    main()
