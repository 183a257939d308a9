"""Plain reference of ``resnet20``, He et al.'s CIFAR-10 ResNet-20
(arXiv:1512.03385, sec. 4.2, n = 3), one draw at a time:

``h = act(conv3x3(x) + b)``; three stages of widths w, 2w, 4w with three
basic blocks each, ``y = act(conv3x3(h; stride s) + b1)``, ``h =
act(conv3x3(y) + b2 + shortcut(h))``, s = 2 in the first block of stages 2
and 3; the shortcut the identity or option A there (every other pixel, the
old channels between zeros a quarter of the new width on each side); every
conv padded by 1; global average pooling; ``logits = h @ W + b``. BatchNorm
in its inference form is folded into the convs' weights and biases.

Weights are a list of 20 layer dicts with a leading draw axis: conv ``w``
HWIO (S, 3, 3, C_in, C_out), head ``w`` (S, 4w, classes), ``b`` (S, O).
Inputs NHWC. Imports torch alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.activations import ACTIVATIONS


def _option_a(h: torch.Tensor, out_channels: int) -> torch.Tensor:
    h = h[:, :, ::2, ::2]
    zeros = h.new_zeros((h.shape[0], (out_channels - h.shape[1]) // 2) + h.shape[2:])
    return torch.cat([zeros, h, zeros], dim=1)


def logits(weights: list, x: torch.Tensor, activation: str, prec) -> torch.Tensor:
    """(S, B, classes) logits, the S draws looped over."""
    act = ACTIVATIONS[activation]
    head = weights[-1]
    out = []
    for s in range(head["w"].shape[0]):
        def conv(h, layer, stride):
            w = layer["w"][s].permute(3, 2, 0, 1)  # HWIO -> OIHW
            return F.conv2d(prec.operand(h), prec.operand(w), layer["b"][s].to(prec.dtype), stride=stride, padding=1)

        h = act(conv(x.permute(0, 3, 1, 2), weights[0], 1))
        i = 1
        for stage in range(3):
            for block in range(3):
                stride = 2 if stage and not block else 1
                y = conv(act(conv(h, weights[i], stride)), weights[i + 1], 1)
                h = act(y + (h if stride == 1 else _option_a(h, y.shape[1])))
                i += 2
        h = h.mean(dim=(2, 3))
        out.append(torch.matmul(prec.operand(h), prec.operand(head["w"][s])) + head["b"][s].to(prec.dtype))
    return torch.stack(out)
