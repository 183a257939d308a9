"""Pad-and-mask batching, the reshuffling epoch iterator and per-class
subsets (port of ``robustbnns_tpu/data/loaders.py``).

The reference's DataLoader keeps the partial last batch; the batches here are
padded with zeros and carry a validity mask instead, so sums and accuracies
over the real rows match exactly.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

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


class Batches:
    """Epoch iterator with a fresh permutation each epoch (JAX
    ``data/loaders.py:63-99``; the reference's ``DataLoader(shuffle=True)``,
    ``utils.py:30-35``), the data kept on its device.

    Epoch ``e``'s permutation comes from a CPU ``torch.Generator`` seeded from
    ``(seed, e)``, so an epoch's order depends on nothing drawn before it. It
    matches JAX's ``permutation(fold_in(key, e))`` only in distribution;
    :meth:`epoch` takes an explicit ``perm`` (a test's JAX permutation).
    """

    def __init__(self, x: torch.Tensor, y: torch.Tensor, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0) -> None:
        self.x, self.y = torch.as_tensor(x), torch.as_tensor(y)
        self.batch_size = int(batch_size)
        self.shuffle, self.seed = shuffle, int(seed)
        self.n = self.x.shape[0]
        self.num_batches = -(-self.n // self.batch_size)

    def permutation(self, epoch_idx: int) -> torch.Tensor:
        """Epoch ``epoch_idx``'s order of the rows, on the data's device."""
        state = np.random.SeedSequence([self.seed, int(epoch_idx)]).generate_state(1, dtype=np.uint64)[0]
        generator = torch.Generator().manual_seed(int(state))
        return torch.randperm(self.n, generator=generator).to(self.x.device)

    def epoch(self, epoch_idx: int, perm: Optional[torch.Tensor] = None) -> EpochBatches:
        """Epoch ``epoch_idx`` as padded batches: its own permutation (or
        ``perm``) when shuffling, the stored order otherwise."""
        if perm is None and self.shuffle:
            perm = self.permutation(epoch_idx)
        if perm is not None:
            perm = torch.as_tensor(perm, device=self.x.device)
        return batch_arrays(self.x, self.y, self.batch_size, perm=perm)

    def __iter__(self) -> Iterator[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Epoch 0's ``(x, y, mask)`` batches, as JAX's ``__iter__``."""
        eb = self.epoch(0)
        for i in range(self.num_batches):
            yield eb.x[i], eb.y[i], eb.mask[i]


def classwise_arrays(
    x: np.ndarray,
    y: np.ndarray,
    n_inputs: Optional[int],
    num_classes: int,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Per-class subsets, the first ``n_inputs`` of each (reference ``utils.py:39-64``)."""
    labels = np.argmax(y, axis=-1)
    return [(x[labels == c][:n_inputs], y[labels == c][:n_inputs]) for c in range(num_classes)]
