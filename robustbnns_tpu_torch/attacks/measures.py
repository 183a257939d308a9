"""Robustness measures (port of ``robustbnns_tpu/attacks/measures.py``).

Faithful quirk: :func:`softmax_difference` re-applies softmax to the model
outputs (reference ``adversarialAttacks.py:36-37``) even when those outputs are
already averaged probabilities — a double softmax that compresses the
differences. ``renormalize=False`` gives the plain variant.
"""
from __future__ import annotations

import torch


def softmax_difference(
    original_predictions: torch.Tensor,
    adversarial_predictions: torch.Tensor,
    *,
    renormalize: bool = True,
) -> torch.Tensor:
    """Pointwise l-inf norm of the softmax-output difference, in [0, 1]."""
    if original_predictions.shape[0] != adversarial_predictions.shape[0]:
        raise ValueError("Input arrays should have the same length.")
    if renormalize:
        original_predictions = torch.softmax(original_predictions, dim=-1)
        adversarial_predictions = torch.softmax(adversarial_predictions, dim=-1)
    return (original_predictions - adversarial_predictions).abs().amax(dim=-1)


def check_softmax_difference_range(norms: torch.Tensor) -> None:
    """The reference's runtime guard (``adversarialAttacks.py:48-49``)."""
    if float(norms.min()) < 0.0 or float(norms.max()) > 1.0:
        raise ValueError("Softmax difference should be in [0,1]")


def softmax_robustness(
    original_outputs: torch.Tensor,
    adversarial_outputs: torch.Tensor,
    *,
    renormalize: bool = True,
    verbose: bool = True,
) -> torch.Tensor:
    """Pointwise robustness ``1 - softmax_difference`` (reference ``:53-62``)."""
    diffs = softmax_difference(original_outputs, adversarial_outputs, renormalize=renormalize)
    check_softmax_difference_range(diffs)
    robustness = 1.0 - diffs
    if verbose:
        print(f"avg softmax robustness = {float(robustness.mean()):.2f}")
    return robustness
