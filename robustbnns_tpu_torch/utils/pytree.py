"""Parameter-tree helpers (port of ``robustbnns_tpu/utils/pytree.py``, the slice's part).

Network parameters are a tuple of ``{"w", "b"}`` tensor dicts, one per layer.
Leaves are visited in JAX's flatten order: tuple index, then sorted dict keys.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

Params = tuple  # tuple of {"w": tensor, "b": tensor}


def map_params(fn: Callable[..., Any], *trees: Params) -> Params:
    """Apply ``fn`` leafwise across parameter trees of one structure."""
    return tuple(
        {k: fn(*(t[li][k] for t in trees)) for k in sorted(trees[0][li])}
        for li in range(len(trees[0]))
    )


def tree_leaves(tree: Params) -> list:
    """The leaves of a parameter tree in JAX's flatten order."""
    return [layer[k] for layer in tree for k in sorted(layer)]


def normal_like_tree(generator: torch.Generator, tree: Params) -> Params:
    """Iid standard-normal leaves shaped like ``tree``, drawn on the generator's device.

    Used for the guide's random init (reference ``model_bnn.py:125-126``) and
    for reparameterized weight draws.
    """
    return map_params(
        lambda x: torch.randn(
            x.shape, generator=generator, device=generator.device, dtype=x.dtype
        ),
        tree,
    )
