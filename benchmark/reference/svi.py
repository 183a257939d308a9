"""Plain reference of the trainer's SVI steps (ginevracoal/robustBNNs
``model_bnn.py:105-127,300-341``): the negative ELBO of one reparameterized
draw, ``KL(N(loc, softplus(rho)) || N(0, 1)) - sum_i log softmax(f_w(x_i))[y_i]``
summed over the batch's rows with the KL counted once, and Adam (b1 0.9, b2
0.999, eps 1e-8) on the leaves ``loc`` then ``rho``, each layer's ``b``
before its ``w``.

The rows and draws are made as the trainer makes them from its one generator
(:mod:`.draws`): each epoch ``randperm(n)`` of the rows, then per step the
ELBO draw and the accuracy draws, which the loss does not use. A step's rows
are the permutation's next ``batch``; the epoch's last step takes what is
left. Imports torch alone.

``fault`` plants one of the faults a training step can have, in the
reference put in the program's place: ``unchanged`` (the step leaves the
state as it was), ``half_batch`` (half of the batch left out, the sum over
the rest doubled), ``label`` (one row's label altered where the loss reads
it), ``ascent`` (the update's sign flipped).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import draws
from benchmark.reference.pgd import softplus

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def leaves(loc: list, rho: list) -> list:
    """The trainer's parameters in its order: every ``loc`` leaf, then every ``rho`` leaf."""
    return [tree[li][k] for tree in (loc, rho) for li, k in draws.leaf_order(loc)]


def _tree(flat: list, like: list) -> list:
    out, it = [dict() for _ in like], iter(flat)
    for li, k in draws.leaf_order(like):
        out[li][k] = next(it)
    return out


def epoch_steps(generator: torch.Generator, like: list, n: int, batch: int, acc_samples: int):
    """One epoch of the trainer's draws from ``generator``: yields each step's
    rows (indices into the epoch's ``n`` rows) and its ELBO noise."""
    perm = torch.randperm(n, generator=generator, device=generator.device)
    for start in range(0, n, batch):
        eps = draws.randn_tree(generator, like)
        if acc_samples:
            draws.randn_tree(generator, like, (acc_samples,))
        yield perm[start:start + batch], eps


def step_draws(seed: int, like: list, n: int, batch: int, acc_samples: int, epoch: int, step: int):
    """The rows and ELBO noise of step ``step`` of epoch ``epoch`` (both from
    0) of a trainer whose generator was seeded with ``seed``: every draw
    before it made again, in order."""
    generator = torch.Generator(device=like[0]["w"].device).manual_seed(int(seed))
    for e in range(epoch + 1):
        for k, (rows, eps) in enumerate(epoch_steps(generator, like, n, batch, acc_samples)):
            if (e, k) == (epoch, step):
                return rows, eps
    raise IndexError(f"no step {step} in epoch {epoch} of {n} rows in batches of {batch}")


def neg_elbo(arch, activation: str, params: list, like: list, eps: list, x, labels, prec, fault=None):
    n_leaves = len(params) // 2
    loc, rho = _tree(params[:n_leaves], like), _tree(params[n_leaves:], like)
    w = [{k: (loc[li][k] + softplus(rho[li][k]) * eps[li][k].to(prec.dtype))[None] for k in loc[li]}
         for li in range(len(like))]
    if fault == "label":
        labels = labels.clone()
        labels[0] = (labels[0] + 1) % w[-1]["b"].shape[-1]
    ll = F.log_softmax(arch.logits(w, x.to(prec.dtype), activation, prec)[0], dim=-1).gather(-1, labels[:, None])
    if fault == "half_batch":
        ll = 2.0 * ll[: ll.shape[0] // 2]
    kl = sum(torch.sum(0.5 * (s * s + m * m - 1.0) - torch.log(s))
             for m, s in ((p, softplus(r)) for p, r in zip(params[:n_leaves], params[n_leaves:])))
    return kl - ll.sum()


def adam(before: list, grads: list, m: list, v: list, step: int, lr: float, fault=None):
    """Adam's ``step``-th update (from 1) of the leaves ``before`` with their
    gradients and first and second moments before it. Returns the leaves and
    the moments after it."""
    if fault == "unchanged":
        return before, m, v
    sign = 1.0 if fault == "ascent" else -1.0
    m = [BETA1 * a + (1 - BETA1) * g for a, g in zip(m, grads)]
    v = [BETA2 * a + (1 - BETA2) * g * g for a, g in zip(v, grads)]
    after = [p + sign * lr * (a / (1 - BETA1**step)) / ((b / (1 - BETA2**step)).sqrt() + ADAM_EPS)
             for p, a, b in zip(before, m, v)]
    return after, m, v


def one_step(arch, activation: str, before: list, m: list, v: list, step: int, like: list, eps: list, x, labels,
             lr: float, prec, fault=None) -> dict:
    """The ``step``-th step (from 1) from the leaves ``before`` and Adam's
    moments ``m``, ``v`` on the rows ``x`` with class ``labels`` and the ELBO
    noise ``eps``, in ``prec``. Returns the loss, the gradients, and the
    leaves and moments before and after the step."""
    before = [p.detach().to(prec.dtype) for p in before]
    m, v = [t.to(prec.dtype) for t in m], [t.to(prec.dtype) for t in v]
    req = [p.clone().requires_grad_(True) for p in before]
    loss = neg_elbo(arch, activation, req, like, eps, x, labels, prec, fault)
    grads = [g.detach() for g in torch.autograd.grad(loss, req)]
    after, m_after, v_after = adam(before, grads, m, v, step, lr, fault)
    return {"step": step, "loss": float(loss.detach()), "grad": grads, "before": before, "after": after,
            "m": m, "v": v, "m_after": m_after, "v_after": v_after}


def first_steps(arch, activation: str, loc: list, rho: list, x, y, batch: int, seed: int, lr: float,
                acc_samples: int, n_steps: int, prec, fault=None) -> list:
    """The trainer's first ``n_steps`` steps from ``(loc, rho)`` over the rows
    ``x`` and one-hot ``y`` of its first epoch, with its generator seeded
    with ``seed`` (:func:`one_step`'s dict a step)."""
    generator = torch.Generator(device=loc[0]["w"].device).manual_seed(int(seed))
    params = leaves(loc, rho)
    m = v = [torch.zeros_like(p, dtype=prec.dtype) for p in params]
    out = []
    for step, (rows, eps) in enumerate(epoch_steps(generator, loc, x.shape[0], batch, acc_samples), 1):
        if step > n_steps:
            break
        out.append(one_step(arch, activation, params, m, v, step, loc, eps, x[rows], y[rows].argmax(-1), lr, prec,
                            fault))
        params, m, v = out[-1]["after"], out[-1]["m_after"], out[-1]["v_after"]
    return out
