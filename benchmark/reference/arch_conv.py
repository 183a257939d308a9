"""Plain reference of ``conv`` (ginevracoal/robustBNNs ``model_nn.py:77-121``):
Conv(C->32, k5, valid) -> act -> MaxPool(2) -> Conv(32->h, k5, valid) -> act
-> MaxPool(2, stride 1) -> Flatten in (h, w, c) order -> Linear(h/16 *
input_size, out), one draw at a time.

Weights are a list of layer dicts with a leading draw axis: conv ``w`` HWIO
(S, 5, 5, C_in, C_out), dense ``w`` (S, I, O), ``b`` (S, O). Inputs NHWC.
Imports torch alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.activations import ACTIVATIONS


def logits(weights: list, x: torch.Tensor, activation: str, prec) -> torch.Tensor:
    """(S, B, classes) logits, the S draws looped over."""
    act = ACTIVATIONS[activation]
    conv1, conv2, head = weights
    out = []
    for s in range(head["w"].shape[0]):
        h = x.permute(0, 3, 1, 2)
        for layer, stride in ((conv1, 2), (conv2, 1)):
            w = layer["w"][s].permute(3, 2, 0, 1)  # HWIO -> OIHW
            h = F.conv2d(prec.operand(h), prec.operand(w), layer["b"][s].to(prec.dtype))
            h = F.max_pool2d(act(h), 2, stride)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        out.append(torch.matmul(prec.operand(h), prec.operand(head["w"][s])) + head["b"][s].to(prec.dtype))
    return torch.stack(out)
