"""The reference's activations (ginevracoal/robustBNNs ``model_nn.py``; the
leaky slope is torch's default, 0.01)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    "relu": F.relu,
    "leaky": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "sigm": torch.sigmoid,
    "tanh": torch.tanh,
}
