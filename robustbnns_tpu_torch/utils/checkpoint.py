"""Checkpointing: parameter trees <-> ``.npz`` files keyed by flattened paths
(port of ``robustbnns_tpu/utils/checkpoint.py``, npz backend).

The on-disk layout is the JAX package's: one compressed ``.npz`` holding every
leaf under its '/'-joined tree path (``_path_to_str``, ``checkpoint.py:242``),
plus a JSON meta blob under ``__robustbnns_meta__``. A mean-field posterior's
leaves are ``loc/0/b``, ``loc/0/w``, ..., ``rho/2/w``. So a posterior saved by
either package loads in the other unchanged.

The backend switch is the JAX package's (``_backend``, ``checkpoint.py:35-40``):
``backend=`` first, then ``ROBUSTBNNS_CKPT_BACKEND``, then ``npz``; any other
name than ``npz`` or ``orbax`` is a ``ValueError``. The Orbax backend is not
ported: a save under ``orbax``, and a load of an Orbax directory
(``<path>.orbax``, or a path ending in ``.orbax``) that has no npz beside it,
raise ``NotImplementedError`` naming Orbax, before anything is written or
read. The port's saves are synchronous, so :func:`wait_for_checkpoints` has
nothing to wait for.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Any, Iterator, Optional

import numpy as np
import torch

from robustbnns_tpu_torch.parallel.mesh import write_on_rank_zero

_META_KEY = "__robustbnns_meta__"
_ORBAX_SUFFIX = ".orbax"


def _flatten_with_names(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(name, leaf) pairs in JAX's flatten order: NamedTuple fields and sequence
    indices in order, dict keys sorted."""
    join = (lambda p: f"{prefix}/{p}") if prefix else str
    if hasattr(tree, "_fields"):
        for field in tree._fields:
            yield from _flatten_with_names(getattr(tree, field), join(field))
    elif isinstance(tree, (tuple, list)):
        for i, sub in enumerate(tree):
            yield from _flatten_with_names(sub, join(i))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_names(tree[k], join(k))
    else:
        yield (prefix or "__root__"), tree


def _rebuild(template: Any, leaves: Iterator[Any]) -> Any:
    """A tree shaped like ``template`` whose leaves come from ``leaves`` in order."""
    if hasattr(template, "_fields"):
        return type(template)(*(_rebuild(getattr(template, f), leaves) for f in template._fields))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(sub, leaves) for sub in template)
    if isinstance(template, dict):
        rebuilt = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: rebuilt[k] for k in template}
    return next(leaves)


def _surrogate_meta() -> dict:
    from robustbnns_tpu_torch.data.datasets import surrogate_fingerprint

    return surrogate_fingerprint() or {}


def _warn_surrogate_mismatch(path: str) -> None:
    from robustbnns_tpu_torch.data.datasets import SURROGATE_VERSION

    try:
        meta = load_meta(path)
    except (OSError, ValueError):
        return
    v = meta.get("surrogate_version")
    if v is not None and v != SURROGATE_VERSION:
        warnings.warn(
            f"checkpoint {path} was trained on synthetic-surrogate data version "
            f"{v}, but this process generates version {SURROGATE_VERSION} — the "
            "distributions differ, so evaluating this model on the current "
            "surrogate will score ~chance. Retrain, or check out the matching "
            "code version.",
            stacklevel=3,
        )


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _backend(backend: Optional[str]) -> str:
    backend = backend or os.environ.get("ROBUSTBNNS_CKPT_BACKEND", "npz")
    if backend not in ("npz", "orbax"):
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    return backend


def _orbax_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the Orbax checkpoint backend (ROBUSTBNNS_CKPT_BACKEND=orbax) is not "
        "ported; the port writes npz only, and npz checkpoints load in both packages "
        "(save with backend='npz')"
    )


def _refuse_orbax(path: str) -> None:
    """Raise when ``path`` names an Orbax checkpoint and no npz: the path ends
    in ``.orbax`` (the one JAX's save returns) or ``<path>.orbax`` is a
    directory (JAX ``load_pytree``'s detection, ``checkpoint.py:165-171``)."""
    if os.path.exists(_npz_path(path)):
        return
    stem = path.removesuffix(".npz")
    if stem.endswith(_ORBAX_SUFFIX) or os.path.isdir(stem + _ORBAX_SUFFIX):
        raise _orbax_not_ported(f"checkpoint {path} is an Orbax directory")


def save_pytree(tree: Any, path: str, meta: Optional[dict] = None, backend: Optional[str] = None) -> str:
    """Save a tree of tensors or arrays to ``path`` (``.npz`` appended if missing).

    ``backend`` (or ``ROBUSTBNNS_CKPT_BACKEND``) ``orbax`` raises
    ``NotImplementedError`` before anything is written. Saves from a process
    that served synthetic surrogate data are tagged with the surrogate
    generator version. Under a default mesh (``--mesh``) rank 0 writes and
    every rank waits for it (:func:`.parallel.mesh.write_on_rank_zero`).
    """
    if _backend(backend) == "orbax":
        raise _orbax_not_ported(f"cannot save {path}")
    meta = {**_surrogate_meta(), **(meta or {})}
    path = _npz_path(path)

    def write():
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        arrays = {
            name: (leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf))
            for name, leaf in _flatten_with_names(tree)
        }
        arrays[_META_KEY] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
        np.savez_compressed(path, **arrays)

    write_on_rank_zero(write)
    return path


def load_pytree(template: Any, path: str, device="cpu") -> Any:
    """Load a file written by :func:`save_pytree` (either package) into the
    structure of ``template``, as float tensors on ``device``.

    Warns when the checkpoint's synthetic-surrogate version differs from this
    process's generator. A JAX Orbax checkpoint raises ``NotImplementedError``.
    """
    _refuse_orbax(path)
    _warn_surrogate_mismatch(path)
    path = _npz_path(path)
    leaves = []
    with np.load(path, allow_pickle=False) as data:
        for name, leaf in _flatten_with_names(template):
            if name not in data:
                raise KeyError(f"checkpoint {path} is missing leaf {name!r}")
            arr = data[name]
            if hasattr(leaf, "shape") and tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint leaf {name!r} has shape {arr.shape}, "
                    f"expected {tuple(leaf.shape)}"
                )
            leaves.append(torch.as_tensor(arr, device=device))
    return _rebuild(template, iter(leaves))


def load_meta(path: str) -> dict:
    _refuse_orbax(path)
    with np.load(_npz_path(path), allow_pickle=False) as data:
        if _META_KEY not in data:
            return {}
        return json.loads(bytes(data[_META_KEY]).decode("utf-8"))


def wait_for_checkpoints() -> None:
    """Return at once: the port's saves are synchronous npz writes, so none is
    ever in flight (JAX's waits for its async Orbax saves and returns at once
    when none is pending, ``checkpoint.py:149-152``)."""


def params_from_numpy(tree, device="cpu"):
    """A JAX parameter tree (a sequence of ``{"w", "b"}`` dicts of arrays) as
    the port's tree of float32 tensors on ``device``: an NN's parameters, an
    ensemble's stacked ``(E, ...)`` members or an HMC posterior's draws."""
    return tuple(
        {k: torch.tensor(np.asarray(v, np.float32), device=device) for k, v in layer.items()}
        for layer in tree
    )


def meanfield_from_numpy(loc, rho, device="cpu"):
    """The JAX posterior's numpy leaves (two trees of ``{"w", "b"}`` dicts) as
    the port's :class:`MeanFieldPosterior` of float32 tensors on ``device``."""
    from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior

    return MeanFieldPosterior(loc=params_from_numpy(loc, device), rho=params_from_numpy(rho, device))


def hmc_samples_from_numpy(samples, like=None, device="cpu"):
    """The JAX package's stacked HMC draws as the port's stacked parameter
    tree of float32 tensors on ``device``.

    ``samples`` is either the tree of JAX's ``bnn.samples`` (a sequence of
    ``{"w", "b"}`` dicts of ``(S, ...)`` arrays) or a flat ``(S, D)`` array in
    ``ravel_pytree`` order, which ``like`` (one parameter tree, e.g.
    ``arch.init(...)``) gives the shapes of.
    """
    from robustbnns_tpu_torch.utils.pytree import flatten_tree_to_vector

    if isinstance(samples, (tuple, list)):
        return params_from_numpy(samples, device)
    if like is None:
        raise ValueError("a flat (S, D) array needs `like`, a parameter tree, for its leaf shapes")
    _, unravel = flatten_tree_to_vector(like)
    flat = torch.tensor(np.asarray(samples, np.float32), device=device)
    return tuple({k: v.contiguous() for k, v in layer.items()} for layer in unravel(flat))
