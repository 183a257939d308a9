"""Work counted from shapes: the operations and bytes a step needs, whatever
implements it, and the card's peaks (``peaks.json``).

Each architecture has a module ``arch_<name>.py`` here with
``param_shapes(config)`` (every layer's ``w`` and ``b`` and its fan-in) and
``forward_flops(config)`` (each layer's FLOP for one image under one draw,
2 per multiply-add). Counts cover the products (matmuls and convolutions);
elementwise work is left out.
"""
from __future__ import annotations

import importlib
import json
import os

with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as _f:
    PEAKS = json.load(_f)


def arch(config: dict):
    return importlib.import_module(f"benchmark.work.arch_{config['architecture']}")


def pgd_iteration_flops(config: dict, traffic: dict) -> float:
    """One PGD iteration: the S-draw forward and its input gradient, whose
    products are those of the forward again (every layer passes the
    gradient on, the first one to the image)."""
    per_image_draw = sum(arch(config).forward_flops(config))
    return 2.0 * per_image_draw * traffic["n_samples"] * traffic["batch_size"]


def svi_step_flops(config: dict, traffic: dict) -> float:
    """One SVI step: the one-draw ELBO forward, its backward (each layer's
    weight gradient, and the input gradient of every layer but the first),
    and the ``accuracy_samples``-draw accuracy forward."""
    layers = arch(config).forward_flops(config)
    per_image = sum(layers) * (2 + traffic["accuracy_samples"]) + sum(layers[1:])
    return per_image * traffic["batch_size"]


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: operations at the peak or bytes at HBM's bandwidth."""
    return max(flops / peak_flops, nbytes / PEAKS["hbm_bytes_per_s"])


def sampled_dense_iteration_bound_s(config: dict, traffic: dict) -> float:
    """The bound of one PGD iteration's sampled-dense calls on the fused path:
    per dense layer a forward and an input gradient, each ``2 S B I O`` FLOP
    at the FP32 peak, or its inputs read once and outputs written once
    (4-byte words), whichever is longer. The first layer takes the shared
    image (B, I), the others per-draw inputs (S, B, I)."""
    s, b = traffic["n_samples"], traffic["batch_size"]
    total = 0.0
    for li, layer in enumerate(arch(config).param_shapes(config)):
        i, o = layer["w"]
        x_words = b * i if li == 0 else s * b * i
        flops = 2.0 * s * b * i * o
        fwd_bytes = 4.0 * (x_words + 2 * i * o + 2 * o + s * b * o)
        dx_bytes = 4.0 * (s * b * o + 2 * i * o + x_words)
        total += sum(bound_s(flops, nb, PEAKS["fp32_flops_per_s"]) for nb in (fwd_bytes, dx_bytes))
    return total
