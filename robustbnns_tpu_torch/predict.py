"""The posterior predictives of every model type (port of ``robustbnns_tpu/predict.py``).

* **NN** — raw logits (reference ``model_nn.py:126``);
* **SVI BNN** — average of per-sample **softmax probabilities** over
  ``n_samples`` reparameterized draws (reference ``model_bnn.py:134-136,257``).
  With ``seeds`` the draws are seeded per sample, so the same seed always yields
  the same weights (``model_bnn.py:222-226``); without, each call draws
  fresh noise, one ``randn`` per leaf for all S draws;
* **SVI avg_posterior** — the variational means plugged into the network, **raw
  logits** (``model_bnn.py:206-216``);
* **HMC BNN** — the stacked posterior indexed by ``seeds`` (default
  ``range(n_samples)``, ``model_bnn.py:248-249``), each draw's softmax
  averaged (``model_bnn.py:243-257``). Seeds are checked on the host: the
  reference raises past the last draw, where JAX would clamp the index and a
  bad index on the card would poison the CUDA context;
* **Ensemble** — the mean of the first ``n_samples`` members' **raw logits**
  (``model_ensemble.py:63-67``), deliberately unlike the BNN's probability
  average: attack gradients differ, so the reference's choice is kept.

The unfused path materialises the S sampled weight sets and runs the network
on them with ``torch.matmul`` and, for the conv architectures, ``F.conv2d``
(cuDNN), as the JAX package leaves those products to XLA.
Every predictive closure takes ``(x, generator=None)``: stochastic ones draw
from the CPU generator, deterministic ones ignore it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior, sample_meanfield_eps
from robustbnns_tpu_torch.parallel.mesh import gather_axis, reduce_sum, resolve_mesh, shard_axis
from robustbnns_tpu_torch.utils.prng import draw_seed, key_from_seed, keys_from_seeds
from robustbnns_tpu_torch.utils.pytree import Params, index_tree, map_params, normal_like_tree, slice_tree


def nn_predict(arch, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Deterministic forward: raw logits (reference ``model_nn.py:126-141``)."""
    return arch.apply(params, x)


def ensemble_predict(arch, stacked_params: Params, x: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Mean raw logits over the first ``n_samples`` members, through the
    stacked ``apply`` (reference ``model_ensemble.py:63-67``)."""
    return arch.apply(slice_tree(stacked_params, n_samples), x).mean(dim=0)


def sample_eps(
    like: Params,
    n_samples: int,
    *,
    generator: Optional[torch.Generator] = None,
    seeds: Optional[Sequence[int]] = None,
    device="cpu",
) -> Params:
    """Standard-normal noise of S draws, a leading ``(S,)`` axis on every leaf
    shaped like ``like`` — the reference's seeds-vs-fresh-draws rule
    (``model_bnn.py:198-232``).

    With ``seeds``: one generator per seed on ``device``, so seed ``i`` always
    gives the same draw. Otherwise fresh draws: one generator on ``device``,
    seeded from the CPU ``generator`` (no device synchronisation), draws each
    leaf's S samples in one call.
    """
    if seeds is not None:
        seeds = list(seeds)
        if len(seeds) != n_samples:
            raise ValueError("Number of seeds should match number of samples.")
        per_seed = [normal_like_tree(k, like) for k in keys_from_seeds(seeds, device)]
        return map_params(lambda *e: torch.stack(e), *per_seed)
    if generator is None:
        raise ValueError("pass either `generator` (fresh draws) or `seeds`")
    fresh = key_from_seed(draw_seed(generator), device)
    return map_params(
        lambda p: torch.randn((n_samples,) + tuple(p.shape), generator=fresh, device=device, dtype=p.dtype),
        like,
    )


def svi_predict(arch, posterior: MeanFieldPosterior, x: torch.Tensor, eps: Params) -> torch.Tensor:
    """Mean softmax over the draws ``loc + softplus(rho)·eps`` — ``(batch, classes)``.

    ``eps`` is a stacked ``(S, ...)`` noise tree: :func:`sample_eps`'s, or
    another package's draws injected by a test.
    """
    weights = sample_meanfield_eps(posterior, eps)
    return torch.softmax(arch.apply(weights, x), dim=-1).mean(dim=0)


def svi_avg_posterior_predict(arch, posterior: MeanFieldPosterior, x: torch.Tensor) -> torch.Tensor:
    """Raw logits at the variational mean (reference ``model_bnn.py:206-216``)."""
    return arch.apply(posterior.loc, x)


def hmc_sample_index(stacked_params: Params, seeds: Sequence[int], device="cpu") -> torch.Tensor:
    """``seeds`` as an index of the stacked draws, on ``device``; raises
    ``IndexError`` for a seed outside ``[-S, S)``, before anything is indexed."""
    n_draws = stacked_params[0]["w"].shape[0]
    seeds = [int(s) for s in seeds]
    bad = [s for s in seeds if not -n_draws <= s < n_draws]
    if bad:
        raise IndexError(f"posterior draws {bad} out of range for a posterior of {n_draws} samples")
    return torch.tensor(seeds, dtype=torch.long, device=device)


def hmc_predict(arch, stacked_params: Params, x: torch.Tensor, sample_idx: torch.Tensor) -> torch.Tensor:
    """Mean softmax over the indexed posterior draws, through the stacked
    ``apply`` (reference ``model_bnn.py:243-257``) — ``(batch, classes)``."""
    params = index_tree(stacked_params, sample_idx)
    return torch.softmax(arch.apply(params, x), dim=-1).mean(dim=0)


@torch.no_grad()
def batched_eval(forward_fn, x, y, *, batch_size: int = 128, generator=None, mesh=None):
    """Evaluate a predictive closure over a whole set, batch by batch.

    Returns ``(outputs, correct_count)`` with ``outputs`` cut to the real rows;
    the last batch is padded and masked (``data.loaders.batch_arrays``).
    With ``mesh`` (or a process default) each batch's rows split over
    ``data`` (JAX ``predict.py:206-215``): every rank draws in lockstep, runs
    its rows, and gets the gathered outputs and the summed count.
    """
    from robustbnns_tpu_torch.data.loaders import batch_arrays
    mesh = resolve_mesh(mesh)
    xb, yb, mb = batch_arrays(x, y, batch_size)
    if mesh is not None:
        mesh.check(x.device)
        xb, yb, mb = (shard_axis(a, mesh, 1, "data") for a in (xb, yb, mb))
    outs, correct = [], x.new_zeros(())
    for bx, by, mask in zip(xb, yb, mb):
        out = forward_fn(bx, generator)
        correct = correct + ((out.argmax(-1) == by.argmax(-1)) * mask).sum()
        outs.append(out)
    if mesh is not None and batch_size % mesh.shape["data"] == 0:  # sharded: every rank's rows
        outs = list(gather_axis(torch.stack(outs), mesh, batch_size, 1))
        (correct,) = reduce_sum([correct], mesh)
    return torch.cat(outs)[: x.shape[0]], correct
