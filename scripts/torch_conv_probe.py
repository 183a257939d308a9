#!/usr/bin/env python3
"""Time the conv architectures' stacked-draw designs on one CUDA card.

Run from the repo root::

    python3 scripts/torch_conv_probe.py [--reps 5]

At ``model_0``'s widths (MNIST conv-512, batch 128) and S draws, times the
forward plus input gradient of the S-draw predictive's summed cross-entropy
for four designs of the stacked ``apply``:

* ``grouped`` — the port's: one conv with S·32 output channels, one grouped
  conv (``groups=S``), a batched head;
* ``im2col`` — the first conv as in ``grouped``, the second as one batched
  GEMM over draws on its im2col matrix (``F.unfold``);
* ``vmap`` — ``torch.func.vmap`` of the one-draw ``apply`` over the draws;
* ``loop`` — a Python loop over the draws, one-draw ``apply`` each;

each with cuDNN's default algorithm choice and with
``torch.backends.cudnn.benchmark``; then the no-grad 500-draw forward of
``grouped``, ``im2col`` and ``loop``, and one
SVI step (ELBO backward, Adam, the 10-draw train accuracy). Every time is the
median of ``--reps`` calls between two CUDA events, after two warm-up calls;
peak memory from ``torch.cuda.max_memory_allocated``. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402


def timed(fn, reps):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), torch.cuda.max_memory_allocated() / 2**30


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_conv_probe: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())

    from robustbnns_tpu_torch.attacks.gradient_attacks import ce_on_outputs
    from robustbnns_tpu_torch.config import saved_BNNs
    from robustbnns_tpu_torch.inference.svi import sample_meanfield_eps, svi_train
    from robustbnns_tpu_torch.models.architectures import ACTIVATIONS
    from robustbnns_tpu_torch.models.bnn import BNN
    from robustbnns_tpu_torch.predict import sample_eps
    from robustbnns_tpu_torch.utils.pytree import map_params

    bnn = BNN.from_config(saved_BNNs["model_0"], (28, 28, 1), 10, device="cuda")
    print(f"[probe] tf32 after resolve_device: matmul {torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    arch = bnn.arch
    act = ACTIVATIONS[arch.activation]
    gen = torch.Generator(device="cuda").manual_seed(0)
    loc = arch.init(gen)
    rho = map_params(lambda v: torch.full_like(v, -6.0), loc)
    from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior

    post = MeanFieldPosterior(loc, rho)
    batch = 128
    x = torch.rand((batch, 28, 28, 1), generator=gen, device="cuda")
    labels = torch.randint(0, 10, (batch,), generator=gen, device="cuda")

    def loss_of(logits):
        probs = torch.softmax(logits, -1)
        return ce_on_outputs(probs.reshape(-1, 10), labels.repeat(probs.shape[0])).sum()

    def im2col(w, xr):
        """The second conv as one batched GEMM over draws on its im2col matrix."""
        n = w[0]["w"].shape[0]
        h = xr.permute(0, 3, 1, 2)
        w1 = w[0]["w"].permute(0, 4, 3, 1, 2).reshape(-1, 1, 5, 5)
        h = F.max_pool2d(act(F.conv2d(h, w1, w[0]["b"].reshape(-1))), 2, 2)  # (B, S·32, 12, 12)
        b = h.shape[0]
        cols = F.unfold(h.reshape(b * n, 32, 12, 12), 5)  # (B·S, 800, 64), rows (c, kh, kw)
        cols = cols.reshape(b, n, 800, 64).permute(1, 0, 3, 2).reshape(n, b * 64, 800)
        w2 = w[1]["w"].permute(0, 3, 1, 2, 4).reshape(n, 800, -1)
        h = torch.baddbmm(w[1]["b"].unsqueeze(1), cols, w2)  # (S, B·64, hidden)
        h = act(h).reshape(n * b, 8, 8, -1).permute(0, 3, 1, 2)
        h = F.max_pool2d(h, 2, 1).permute(0, 2, 3, 1).reshape(n, b, -1)
        return torch.baddbmm(w[2]["b"].unsqueeze(1), h, w[2]["w"])

    designs = {
        "grouped": lambda w, xr: arch.apply(w, xr),
        "im2col": im2col,
        "vmap": lambda w, xr: torch.func.vmap(arch.apply, in_dims=(0, None))(w, xr),
        "loop": lambda w, xr: torch.stack([arch.apply(map_params(lambda v: v[s], w), xr)
                                           for s in range(w[0]["w"].shape[0])]),
    }
    results = []
    flops_per_image = 2 * (24 * 24 * 32 * 25 + 8 * 8 * 512 * 800 + 7 * 7 * 512 * 10)
    for n in (10, 100):
        w = sample_meanfield_eps(post, sample_eps(loc, n, seeds=range(n), device="cuda"))
        for name, apply in designs.items():
            for bench in (False, True):
                torch.backends.cudnn.benchmark = bench

                def step():
                    xr = x.clone().requires_grad_(True)
                    (g,) = torch.autograd.grad(loss_of(apply(w, xr)), xr)
                    return g

                ms, gib = timed(step, args.reps)
                tflops = 3 * flops_per_image * batch * n / (ms * 1e-3) / 1e12
                row = {"S": n, "design": name, "cudnn_benchmark": bench, "ms": ms, "peak_gib": gib,
                       "tflops_at_3x_forward": tflops}
                results.append(row)
                print(f"[probe] forward + input gradient B={batch} S={n} {name:8s} benchmark={bench!s:5s}: "
                      f"{ms:.3f} ms, {tflops:.2f} TFLOP/s (3x forward), peak {gib:.2f} GiB", flush=True)
        if n == 100:  # the designs agree on the S = 100 predictive
            with torch.no_grad():
                outs = {name: torch.softmax(apply(w, x), -1).mean(0) for name, apply in designs.items()}
            ref = outs["loop"]
            print("[probe] S=100 probabilities, max |design - loop|: " + ", ".join(
                f"{name} {float((o - ref).abs().max()):.3e}" for name, o in outs.items()), flush=True)
    torch.backends.cudnn.benchmark = False
    w = sample_meanfield_eps(post, sample_eps(loc, 500, seeds=range(500), device="cuda"))
    for name in ("grouped", "im2col", "loop"):
        with torch.no_grad():
            ms, gib = timed(lambda: torch.softmax(designs[name](w, x), -1).mean(0), max(2, args.reps // 2))
        print(f"[probe] no-grad forward B={batch} S=500 {name}: {ms:.3f} ms, "
              f"{flops_per_image * batch * 500 / (ms * 1e-3) / 1e12:.2f} TFLOP/s, peak {gib:.2f} GiB", flush=True)
        results.append({"S": 500, "design": f"{name}-no-grad", "ms": ms, "peak_gib": gib})
    del w

    steps = 20
    xs = torch.rand((steps * batch, 28, 28, 1), generator=gen, device="cuda")
    ys = torch.nn.functional.one_hot(torch.randint(0, 10, (steps * batch,), generator=gen, device="cuda"), 10).float()
    run = lambda: svi_train(arch, xs, ys, epochs=1, lr=0.01, batch_size=batch, verbose=False, device="cuda")  # noqa: E731
    run()
    hist = run()[1]
    print(f"[probe] SVI step conv-512 batch {batch}, 10-draw train accuracy: "
          f"{1e3 * hist['seconds'][0] / steps:.3f} ms wall", flush=True)
    results.append({"design": "svi-step", "ms_wall": 1e3 * hist["seconds"][0] / steps})
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "conv_probe.json"), "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
