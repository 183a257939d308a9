"""Plain reference of ``cct7``, Hassani et al.'s CCT-7/3×1 (arXiv:2104.05704,
the paper's CIFAR-10 model), one draw at a time:

tokenizer ``t = maxpool3x3/2,pad1(act(conv3x3(x; stride 1, pad 1, no
bias)))``, the pixels in row-major (h, w) order as T tokens of width d, ``z
= t + P``; each of 7 layers ``z = LN_1(z + MHSA(LN_pre(z)))`` (4 heads of
d/4, ``q, k, v = LN_pre(z)·[W_q|W_k|W_v]`` with no bias, per head
``softmax(q·kᵀ/sqrt(d/4))·v``, then ``·W_o + b_o``), ``z = z + gelu(z·W_1 +
b_1)·W_2 + b_2`` (GELU in its erf form); head ``z = LN_f(z)``, ``p =
softmax_T(z·w_g + b_g)``, ``logits = (Σ_t p_t z_t)·W + b``. Every LayerNorm
over d, eps 1e-5.

Weights are a list of 39 layer dicts with a leading draw axis: the
tokenizer's conv ``w`` HWIO (S, 3, 3, C, d) and P (S, T, d) in ``b``; per
encoder layer LN_pre ``{γ, β}``, attention ``{[W_q|W_k|W_v|W_o] (S, d, 4d),
b_o}``, LN_1, ``{W_1, b_1}``, ``{W_2, b_2}``; then LN_f, the pooling's
``{w_g (S, d, 1), b_g (S, 1)}`` and the head. Inputs NHWC.

Each draw runs under ``torch.utils.checkpoint``: its activations are not
kept, and its backward computes its forward again. The cell's batch of 128
at S 10 would keep about 90 GB of float64 activations otherwise; one draw
keeps about 9. Imports torch alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.activations import ACTIVATIONS

LAYERS, HEADS = 7, 4


def _layer_norm(z, layer, prec):
    mean = z.mean(-1, keepdim=True)
    var = ((z - mean) ** 2).mean(-1, keepdim=True)
    return (z - mean) / torch.sqrt(var + 1e-5) * layer["w"].to(prec.dtype) + layer["b"].to(prec.dtype)


def _matmul(a, b, prec):
    return torch.matmul(prec.operand(a), prec.operand(b))


def _attention(z, layer, prec):
    width = z.shape[-1]
    head = width // HEADS
    w = layer["w"]
    q, k, v = (_matmul(z, w[:, i * width:(i + 1) * width], prec) for i in range(3))
    heads = []
    for h in range(HEADS):
        cols = slice(h * head, (h + 1) * head)
        scores = _matmul(q[..., cols], k[..., cols].transpose(-1, -2), prec) / head ** 0.5
        heads.append(_matmul(torch.softmax(scores, -1), v[..., cols], prec))
    return _matmul(torch.cat(heads, -1), w[:, 3 * width:], prec) + layer["b"].to(prec.dtype)


def _one_draw(layers: list, x: torch.Tensor, activation: str, prec) -> torch.Tensor:
    x = x.permute(0, 3, 1, 2)
    t = F.conv2d(prec.operand(x), prec.operand(layers[0]["w"].permute(3, 2, 0, 1)), None, stride=1, padding=1)
    t = F.max_pool2d(ACTIVATIONS[activation](t), 3, 2, 1)
    z = t.flatten(2).transpose(1, 2) + layers[0]["b"].to(prec.dtype)
    for i in range(LAYERS):
        ln_pre, attn, ln_1, mlp_1, mlp_2 = layers[1 + 5 * i:6 + 5 * i]
        z = _layer_norm(z + _attention(_layer_norm(z, ln_pre, prec), attn, prec), ln_1, prec)
        hidden = F.gelu(_matmul(z, mlp_1["w"], prec) + mlp_1["b"].to(prec.dtype))
        z = z + _matmul(hidden, mlp_2["w"], prec) + mlp_2["b"].to(prec.dtype)
    z = _layer_norm(z, layers[-3], prec)
    pool = torch.softmax(_matmul(z, layers[-2]["w"], prec) + layers[-2]["b"].to(prec.dtype), dim=1)
    v = _matmul(pool.transpose(1, 2), z, prec)[:, 0]
    return _matmul(v, layers[-1]["w"], prec) + layers[-1]["b"].to(prec.dtype)


def logits(weights: list, x: torch.Tensor, activation: str, prec) -> torch.Tensor:
    """(S, B, classes) logits, the S draws looped over."""
    out = []
    for s in range(weights[-1]["w"].shape[0]):
        layers = [{k: v[s] for k, v in layer.items()} for layer in weights]
        out.append(checkpoint(_one_draw, layers, x, activation, prec, use_reentrant=False))
    return torch.stack(out)
