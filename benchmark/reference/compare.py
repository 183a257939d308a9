"""The numbers that decide ``correct``: each reads how far the program (or
the control, or a planted fault) lies from the reference, and is held to a
limit of its cell (``benchmark/limits/<cell>.json``). A non-finite value in
what is judged reads as ``inf``. Imports torch alone.
"""
from __future__ import annotations

import math

import torch


def _floored(scale: torch.Tensor) -> torch.Tensor:
    """Each entry of ``scale``, but no smaller than their median."""
    return torch.maximum(scale, scale.median())


def image_gaps(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per image, ``||got - ref||_2`` over ``||ref||_2``, or over the median
    image's where that is larger (an image whose gradient is all but zero is
    held to the batch's scale); ``inf`` where ``got`` is not finite."""
    if not bool(torch.isfinite(got).all()):
        return torch.full((got.shape[0],), math.inf, dtype=torch.float64)
    diff = (got.double() - ref.double()).flatten(1).norm(dim=1)
    scale = _floored(ref.double().flatten(1).norm(dim=1))
    if float(scale.max()) == 0.0:
        return torch.where(diff == 0.0, 0.0, math.inf)
    return diff / scale


def image_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst image's gap (:func:`image_gaps`)."""
    return float(image_gaps(got, ref).max())


def mean_image_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The images' mean gap (:func:`image_gaps`): an error of every image
    reads in full, one image's reads at a batch's share."""
    return float(image_gaps(got, ref).mean())


def mismatch(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of entries where ``got`` is not ``want`` bit for bit (a
    non-finite entry never matches)."""
    return float((~(got == want)).double().mean())


def norm_gaps(got: list, ref: list) -> list:
    """Per leaf, ``| ||got|| - ||ref|| |`` over ``||ref||``, or over the median
    leaf's norm where that is larger."""
    got_n = torch.stack([g.double().norm() for g in got])
    ref_n = torch.stack([r.double().norm() for r in ref])
    if not bool(torch.isfinite(got_n).all()):
        return [math.inf] * len(got)
    return [float(v) for v in (got_n - ref_n).abs() / _floored(ref_n)]


def step_gaps(after: list, want: list, before: list) -> list:
    """Per leaf, ``||after - want||`` over the step ``||want - before||``, or
    over the median leaf's step where that is larger; ``inf`` where ``after``
    is not finite."""
    if not all(bool(torch.isfinite(a).all()) for a in after):
        return [math.inf] * len(after)
    diff = torch.stack([(a.double() - w.double()).norm() for a, w in zip(after, want)])
    step = _floored(torch.stack([(w.double() - b.double()).norm() for w, b in zip(want, before)]))
    return [float(v) for v in diff / step]


def moved_leaves(grad_ref: list, share: float = 1e-3) -> list:
    """Whether each leaf's reference gradient reaches ``share`` of the median
    leaf's norm: a leaf below it moves under Adam by round-off alone."""
    norms = torch.stack([g.double().norm() for g in grad_ref])
    return [bool(n >= share * norms.median()) for n in norms]


def relative_gap(got: float, ref: float) -> float:
    if not math.isfinite(got):
        return math.inf
    return abs(got - ref) / abs(ref) if ref else (0.0 if got == ref else math.inf)
