"""Parameter-tree helpers (port of ``robustbnns_tpu/utils/pytree.py``).

Network parameters are a tuple of ``{"w", "b"}`` tensor dicts, one per layer.
Leaves are visited in JAX's flatten order: tuple index, then sorted dict keys
(``b`` before ``w``). A *stacked* tree carries a leading sample axis on every
leaf: the HMC posterior, and the S draws the predictive runs at once.
"""
from __future__ import annotations

import math
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


def tree_size(tree: Params) -> int:
    """Total number of scalar parameters in a tree."""
    return sum(v.numel() for v in tree_leaves(tree))


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


def stack_trees(trees: list) -> Params:
    """Stack identically-structured trees along a new leading axis."""
    return map_params(lambda *xs: torch.stack(xs), *trees)


def index_tree(tree: Params, idx) -> Params:
    """Index every leaf's leading axis (select draws from a stacked tree)."""
    return map_params(lambda x: x[idx], tree)


def slice_tree(tree: Params, n: int) -> Params:
    """The first ``n`` entries along every leaf's leading axis."""
    return map_params(lambda x: x[:n], tree)


def flatten_tree_to_vector(tree: Params):
    """A tree as one 1-D vector in ``jax.flatten_util.ravel_pytree``'s order,
    and the function that undoes it.

    ``unravel(q)`` returns *views* of ``q`` (``torch.split`` and ``view``, no
    copy), so the gradient of a function of ``unravel(q)`` with respect to
    ``q`` comes back as one flat tensor. ``q`` may carry leading axes
    (chains, draws): ``(..., D)`` gives leaves of shape ``(..., *leaf.shape)``.
    """
    leaves = tree_leaves(tree)
    shapes = [tuple(v.shape) for v in leaves]
    sizes = [math.prod(s) for s in shapes]
    keys = [sorted(layer) for layer in tree]
    flat = torch.cat([v.reshape(-1) for v in leaves])

    def unravel(q: torch.Tensor) -> Params:
        if q.shape[-1] != sum(sizes):
            raise ValueError(f"expected a last axis of {sum(sizes)}, got {tuple(q.shape)}")
        lead = tuple(q.shape[:-1])
        parts = iter(p.view(lead + s) for p, s in zip(torch.split(q, sizes, dim=-1), shapes))
        return tuple({k: next(parts) for k in layer_keys} for layer_keys in keys)

    return flat, unravel


def tree_map_with_path_names(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """Map ``fn(name, leaf)`` over a tree with '/'-joined string paths, the
    JAX package's (``_path_str``, ``pytree.py:62-77``): a dict key as itself
    (keys in sorted order), a list or tuple index as its number, a NamedTuple
    field as ``.name``; ``None`` stays ``None``, and a bare leaf has the path ''.
    Tuples of ``{"w", "b"}`` layers give ``0/b``, ``0/w``, ...; a
    ``MeanFieldPosterior`` gives ``.loc/0/b``, ..."""

    def go(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: go(node[k], path + (str(k),)) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(go(v, path + ("." + f,)) for f, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(go(v, path + (str(i),)) for i, v in enumerate(node))
        return fn("/".join(path), node)

    return go(tree, ())
