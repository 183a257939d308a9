"""The SVI posterior predictive (port of ``robustbnns_tpu/predict.py``, the slice's part).

* **SVI BNN** — average of per-sample **softmax probabilities** over
  ``n_samples`` reparameterized draws (reference ``model_bnn.py:134-136,257``).
  With ``seeds`` the draws are seeded per sample, so the same seed always yields
  the same weights (``model_bnn.py:222-226``);
* **SVI avg_posterior** — the variational means plugged into the network, **raw
  logits** (``model_bnn.py:206-216``).

The unfused path materialises the S sampled weight sets and runs the network
on them with ``torch.matmul``, as the JAX package leaves that product to XLA.
Every predictive closure takes ``(x, generator=None)``: stochastic ones draw
from the CPU generator, deterministic ones ignore it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior, sample_meanfield_eps
from robustbnns_tpu_torch.utils.prng import draw_seed, keys_from_seeds
from robustbnns_tpu_torch.utils.pytree import map_params, normal_like_tree


def stacked_draws(posterior: MeanFieldPosterior, sample_keys: Sequence[torch.Generator]):
    """S weight draws with a leading sample axis, one per generator."""
    eps = [normal_like_tree(k, posterior.loc) for k in sample_keys]
    return sample_meanfield_eps(posterior, map_params(lambda *e: torch.stack(e), *eps))


def svi_predict(
    arch,
    posterior: MeanFieldPosterior,
    x: torch.Tensor,
    sample_keys: Optional[Sequence[torch.Generator]] = None,
    *,
    eps=None,
) -> torch.Tensor:
    """Mean softmax over the draws — ``(batch, classes)``.

    The draws come from ``sample_keys`` (one generator per draw, on the
    posterior's device), or from ``eps``, a stacked ``(S, ...)`` noise tree, so a
    test can inject another package's draws.
    """
    if (sample_keys is None) == (eps is None):
        raise ValueError("pass exactly one of `sample_keys` and `eps`")
    weights = (
        stacked_draws(posterior, sample_keys) if eps is None
        else sample_meanfield_eps(posterior, eps)
    )
    return torch.softmax(arch.apply(weights, x), dim=-1).mean(dim=0)


def svi_avg_posterior_predict(arch, posterior: MeanFieldPosterior, x: torch.Tensor) -> torch.Tensor:
    """Raw logits at the variational mean (reference ``model_bnn.py:206-216``)."""
    return arch.apply(posterior.loc, x)


def resolve_sample_keys(
    n_samples: int,
    generator: Optional[torch.Generator],
    seeds: Optional[Sequence[int]],
    device="cpu",
) -> list[torch.Generator]:
    """The reference's seeds-vs-fresh-draws rule (``model_bnn.py:198-232``).

    Seeds give one fresh generator per seed on ``device``; otherwise each draw's
    seed comes from the CPU ``generator``.
    """
    if seeds is not None:
        seeds = list(seeds)
        if len(seeds) != n_samples:
            raise ValueError("Number of seeds should match number of samples.")
        return keys_from_seeds(seeds, device)
    if generator is None:
        raise ValueError("pass either `generator` (fresh draws) or `seeds`")
    return keys_from_seeds([draw_seed(generator) for _ in range(n_samples)], device)


@torch.no_grad()
def batched_eval(forward_fn, x, y, *, batch_size: int = 128, generator=None):
    """Evaluate a predictive closure over a whole set, batch by batch.

    Returns ``(outputs, correct_count)`` with ``outputs`` cut to the real rows;
    the last batch is padded and masked (``data.loaders.batch_arrays``).
    """
    from robustbnns_tpu_torch.data.loaders import batch_arrays

    xb, yb, mb = batch_arrays(x, y, batch_size)
    outs, correct = [], x.new_zeros(())
    for bx, by, mask in zip(xb, yb, mb):
        out = forward_fn(bx, generator)
        correct = correct + ((out.argmax(-1) == by.argmax(-1)) * mask).sum()
        outs.append(out)
    return torch.cat(outs)[: x.shape[0]], correct
