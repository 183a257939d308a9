"""Shapes and FLOP of ``cct7``, CCT-7/3×1: a 3×3 conv tokenizer (C -> d,
stride 1, pad 1, no bias; its ``b`` the positional table P (T, d)), a
max-pool 3/2 pad 1 to T tokens, 7 encoder layers (LN_pre, attention with
``[W_q|W_k|W_v|W_o]`` (d, 4d) and b_o, LN_1, an MLP d -> 2d -> d), LN_f,
sequence pooling (gate (d, 1)) and a dense head; the widths from
``hidden_size`` (d; 4 heads of d/4), as the program derives them. A
LayerNorm's ``w`` and ``b`` are its scale and shift, at fan-in 1.

``forward_flops`` gives each layer dict's products for one image under one
draw: the attention dict's ``q|k|v`` and ``W_o`` products and its 4 heads'
``q·kᵀ`` and ``p·v``, the pooling dict's gate and weighted sum. LayerNorm,
softmax, GELU, the max-pool and the residual adds carry none.
:func:`benchmark.work.pgd_iteration_flops` takes an iteration's input
gradient as one forward's products again; attention's input gradient takes
four T×T products a head where its forward takes two (``dV = Pᵀ·dO``, ``dP
= dO·Vᵀ``, ``dQ = dS·K``, ``dK = dSᵀ·Q``), so ``pgd_mfu`` undercounts an
iteration by 470 MFLOP an image and draw (7 layers' 67.1 M), beside the
4,726 it counts."""
from __future__ import annotations

LAYERS, HEADS, MLP_RATIO = 7, 4, 2


def _sizes(config: dict):
    h, w, c = config["input_shape"]
    d = config["hidden_size"]
    return c, d, ((h + 1) // 2) * ((w + 1) // 2), (h * w)


def param_shapes(config: dict) -> list:
    c, d, tokens, _ = _sizes(config)
    mlp, out = MLP_RATIO * d, config["output_size"]
    norm = {"w": (d,), "b": (d,), "fan_in": 1}
    layers = [{"w": (3, 3, c, d), "b": (tokens, d), "fan_in": 9 * c}]
    for _ in range(LAYERS):
        layers += [norm, {"w": (d, 4 * d), "b": (d,), "fan_in": d}, norm,
                   {"w": (d, mlp), "b": (mlp,), "fan_in": d}, {"w": (mlp, d), "b": (d,), "fan_in": mlp}]
    return layers + [norm, {"w": (d, 1), "b": (1,), "fan_in": d}, {"w": (d, out), "b": (out,), "fan_in": d}]


def forward_flops(config: dict) -> list:
    c, d, tokens, pixels = _sizes(config)
    mlp = MLP_RATIO * d
    attention = 2.0 * tokens * d * 4 * d + 2 * 2.0 * tokens * tokens * d  # q|k|v and W_o; q·kᵀ and p·v
    layer = [0.0, attention, 0.0, 2.0 * tokens * d * mlp, 2.0 * tokens * mlp * d]
    return [2.0 * pixels * d * 9 * c] + layer * LAYERS + [0.0, 2.0 * 2 * tokens * d, 2.0 * d * config["output_size"]]
