"""Plain reference of ``fc2`` (and of any stack of dense layers):
Flatten -> Linear(in, h) -> act -> Linear(h, h) -> act -> Linear(h, out),
with S weight draws at once (ginevracoal/robustBNNs ``model_nn.py:77-121``).

Weights are a list of layer dicts, ``w`` (S, I, O) and ``b`` (S, O); inputs
NHWC, flattened in (h, w, c) order. Imports torch alone.
"""
from __future__ import annotations

import torch

from benchmark.reference.activations import ACTIVATIONS


def logits(weights: list, x: torch.Tensor, activation: str, prec) -> torch.Tensor:
    """(S, B, classes) logits of the S draws for the batch ``x`` (B, h, w, c)."""
    act = ACTIVATIONS[activation]
    h = x.reshape(x.shape[0], -1)
    for li, layer in enumerate(weights):
        h = torch.matmul(prec.operand(h), prec.operand(layer["w"])) + layer["b"].to(prec.dtype)[:, None, :]
        if li < len(weights) - 1:
            h = act(h)
    return h

