"""Plain reference of one Bayesian PGD iteration (ginevracoal/robustBNNs
``adversarialAttacks.py:86-108``): the S-draw predictive (mean softmax), its
input gradient of ``CrossEntropyLoss`` on those probabilities, and the step
``x' = clamp(x0 + clamp(x + alpha * sign(g) - x0, -eps, eps), 0, 1)`` with
``alpha = 2 / max(x0)`` per image.

The draws are worked out again from the forward's seed (:mod:`.draws`); the
weights ``loc + softplus(rho) * eps`` and everything after them are computed
in the given precision, all S draws at once. Imports torch alone.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import draws


def softplus(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(t, 0.0) + torch.log1p(torch.exp(-t.abs()))


def sampled_weights(loc: list, rho: list, seed: int, n_samples: int, fused: bool, dtype) -> list:
    """The S weight draws of a forward with seed ``seed``, as layer dicts with a leading draw axis."""
    device = loc[0]["w"].device
    if fused:
        out = []
        for li, (m, r) in enumerate(zip(loc, rho)):
            i_dim, o_dim = m["w"].shape
            seed_l = draws.layer_seed(seed, li)
            eps = draws.fused_noise(seed_l, range(n_samples), i_dim + 1, o_dim, device).to(dtype)
            out.append({"w": m["w"].to(dtype) + softplus(r["w"].to(dtype)) * eps[:, :i_dim],
                        "b": m["b"].to(dtype) + softplus(r["b"].to(dtype)) * eps[:, i_dim]})
        return out
    eps = draws.unfused_noise(seed, loc, n_samples, device)
    return [{k: m[k].to(dtype) + softplus(r[k].to(dtype)) * e[k].to(dtype) for k in m}
            for m, r, e in zip(loc, rho, eps)]


def predictive_and_gradient(arch, weights: list, x, labels, activation: str, prec):
    """``(probs (B, classes), d/dx sum_i CE(probs_i, y_i))`` of the draws ``weights``."""
    xr = x.detach().to(prec.dtype).requires_grad_(True)
    probs = torch.softmax(arch.logits(weights, xr, activation, prec), -1).mean(0)
    loss = -F.log_softmax(probs, dim=-1).gather(-1, labels[:, None]).sum()
    (grad,) = torch.autograd.grad(loss, xr)
    return probs.detach(), grad


def pgd_step(x, x0, grad, epsilon: float) -> torch.Tensor:
    """The next iterate from ``x`` (float32), the sign of ``grad`` with
    entries below float32's smallest normal counted as zero."""
    alpha = (2.0 / x0.reshape(x0.shape[0], -1).amax(dim=-1)).reshape((x0.shape[0],) + (1,) * (x0.dim() - 1))
    tiny = torch.finfo(torch.float32).tiny
    sign = torch.sign(torch.where(grad.abs() < tiny, 0.0, grad)).to(torch.float32)
    eta = torch.clamp(x + alpha * sign - x0, -epsilon, epsilon)
    return torch.clamp(x0 + eta, 0.0, 1.0)
