"""Fused SVI posterior predictive for dense architectures (port of
``robustbnns_tpu/ops/fused_predict.py``).

Chains :func:`sampled_dense` and :func:`sampled_dense_xs` through an
``fc``/``fc2`` network: every layer draws its S weight samples inside the
kernel, with per-layer decorrelated seeds, so the whole S-sample predictive
touches device memory only for activations, never for sampled weights.
"""
from __future__ import annotations

import torch

from robustbnns_tpu_torch.models import architectures  # a module: architectures imports this package
from robustbnns_tpu_torch.ops.sampled_dense import sampled_dense, sampled_dense_xs
from robustbnns_tpu_torch.utils.prng import draw_seed

_LAYER_SEED_STRIDE = 1000003  # decorrelate per-layer noise streams
_MASK = 0xFFFFFFFF


def supports_fused(arch) -> bool:
    return arch.name in ("fc", "fc2")


def layer_seed(seed: int, layer: int) -> int:
    """The seed of layer ``layer``: ``seed + layer·1000003`` as an int32 wraps, as bits."""
    return (int(seed) + layer * _LAYER_SEED_STRIDE) & _MASK


def fused_logits(arch, posterior, x: torch.Tensor, n_samples: int, seed: int = 0) -> torch.Tensor:
    """The ``(S, batch, classes)`` logits of S fused draws.

    Differentiable in ``x`` and in every posterior leaf: the backward launches
    the dx kernels for an input that asks for its gradient and the dparams
    kernels for parameters that do.
    """
    if not supports_fused(arch):
        raise NotImplementedError(
            f"fused predictive supports fc/fc2 (got {arch.name!r}); "
            "use the unfused path for conv architectures"
        )
    act = architectures.ACTIVATIONS[arch.activation]
    loc, rho = posterior.loc, posterior.rho
    h = sampled_dense(
        x.reshape(x.shape[0], -1), loc[0]["w"], rho[0]["w"], loc[0]["b"], rho[0]["b"],
        n_samples, layer_seed(seed, 0),
    )
    for li in range(1, len(loc)):
        h = sampled_dense_xs(
            act(h), loc[li]["w"], rho[li]["w"], loc[li]["b"], rho[li]["b"],
            n_samples, layer_seed(seed, li),
        )
    return h


def svi_predict_fused(arch, posterior, x: torch.Tensor, n_samples: int, seed: int = 0) -> torch.Tensor:
    """Mean softmax over S fused draws — ``(batch, classes)``."""
    return torch.softmax(fused_logits(arch, posterior, x, n_samples, seed), dim=-1).mean(dim=0)


def fused_predictive_fn(arch, posterior, n_samples: int):
    """A stochastic ``f(x, generator) -> probs`` over the fused path.

    Each call draws one kernel seed from the CPU ``generator``, so attack loops
    get fresh draws every iteration without waiting for the device.
    """

    def forward(x, generator=None):
        if generator is None:
            raise ValueError("the fused predictive draws fresh weights: pass a CPU generator")
        return svi_predict_fused(arch, posterior, x, n_samples, draw_seed(generator))

    return forward
