"""Pad-and-mask batching and per-class subsets (port of
``robustbnns_tpu/data/loaders.py``).

The reference's DataLoader keeps the partial last batch; the batches here are
padded with zeros and carry a validity mask instead, so sums and accuracies
over the real rows match exactly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class EpochBatches(NamedTuple):
    """``x``: (num_batches, batch_size, ...); ``y`` likewise; ``mask``:
    (num_batches, batch_size), 1.0 for real rows and 0.0 for padding."""

    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor


def batch_arrays(
    x: torch.Tensor,
    y: torch.Tensor,
    batch_size: int,
    *,
    perm: Optional[torch.Tensor] = None,
) -> EpochBatches:
    """Pad + reshape tensors into equal batches (on the tensors' device)."""
    n = x.shape[0]
    num_batches = -(-n // batch_size)
    pad = num_batches * batch_size - n
    if perm is not None:
        x, y = x[perm], y[perm]
    mask = torch.cat([x.new_ones(n), x.new_zeros(pad)])
    x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    y = torch.cat([y, y.new_zeros((pad,) + tuple(y.shape[1:]))])
    return EpochBatches(
        x=x.reshape((num_batches, batch_size) + tuple(x.shape[1:])),
        y=y.reshape((num_batches, batch_size) + tuple(y.shape[1:])),
        mask=mask.reshape(num_batches, batch_size),
    )


def classwise_arrays(
    x: np.ndarray,
    y: np.ndarray,
    n_inputs: Optional[int],
    num_classes: int,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per-class subsets, the first ``n_inputs`` of each (reference ``utils.py:39-64``)."""
    labels = np.argmax(y, axis=-1)
    return [(x[labels == c][:n_inputs], y[labels == c][:n_inputs]) for c in range(num_classes)]
