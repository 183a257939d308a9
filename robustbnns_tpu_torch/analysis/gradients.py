"""Expected loss gradients over the posterior (port of
``robustbnns_tpu/analysis/gradients.py``; reference ``lossGradients.py``).

The paper's second result: ``⟨∂L/∂x⟩_{p(w|D)}`` estimated with S posterior
draws. Reference semantics (``lossGradients.py:20-68``):

* draw ``i`` of ``0..S-1`` is ``forward(n_samples=1, seeds=[i])``, so the SAME
  fixed draws serve every image;
* the loss is the cross-entropy of each draw's softmax *probabilities* (the
  CE-on-outputs quirk of :mod:`.attacks.gradient_attacks`);
* results are saved per sample count as ``<name>_samp=<n>_lossGrads.npz``.

The mean over S of the per-draw input gradients is the input gradient of the
mean over S of each draw's summed loss, so :func:`expected_loss_gradients`
runs one forward through the stacked ``apply`` and one backward per batch.

Vanishing-gradient detection (``lossGradients.py:78-127``): an image's
expected-gradient norms over increasing sample counts "vanish" iff they are
monotone non-increasing and the first is nonzero; zero-first-norm images are
"null", the rest "increasing".

The draws are an SVI posterior's seeded reparameterized samples, an HMC
posterior's stacked samples or an ensemble's members, the last two indexed by
the seeds (JAX ``gradients.py:115-121``); everything after is shared. The
deterministic branch (``n_samples=None``, JAX ``gradients.py:86-103``) takes
the input gradient of the CE of the model's own output, an NN's raw logits;
the reference's version is dead code (``lossGradients.py:42-48``).

With ``mesh=`` (or a process default) the S draws split over ``sample`` and
each batch's rows over ``data`` (JAX ``gradients.py:79-140``): a rank takes
the gradient of its draws' summed loss over S on its rows, one all-reduce
sums the draws, and the rows are gathered on every rank.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from robustbnns_tpu_torch.attacks.gradient_attacks import ce_on_outputs
from robustbnns_tpu_torch.config import DATA
from robustbnns_tpu_torch.parallel.mesh import reduce_sum, resolve_mesh, run_on_rows, split_rows, write_on_rank_zero
from robustbnns_tpu_torch.utils.pytree import index_tree, map_params


def _summed_loss(apply_fn, stacked_params, x, labels) -> torch.Tensor:
    """Σ_s Σ_i CE(softmax(f_{w_s}(x_i)), y_i) over the stacked draws."""
    probs = torch.softmax(apply_fn(stacked_params, x), dim=-1)  # (S, B, classes)
    return ce_on_outputs(probs.reshape(-1, probs.shape[-1]), labels.repeat(probs.shape[0])).sum()


def _per_sample_input_grads(apply_fn, stacked_params, x, labels) -> torch.Tensor:
    """∇ₓ Σ_i CE(softmax(f_{w_s}(x_i)), y_i) for every draw s — ``(S, B, ...)``,
    one draw at a time under ``torch.func.vmap``."""

    def one_draw(params):
        return torch.func.grad(
            lambda xx: _summed_loss(apply_fn, map_params(lambda v: v[None], params), xx, labels)
        )(x)

    return torch.func.vmap(one_draw)(stacked_params)


def _mean_input_grads(apply_fn, stacked_params, x, labels, n_draws=None) -> torch.Tensor:
    """The mean over draws of :func:`_per_sample_input_grads`, in one backward:
    the sum over the stacked draws divided by ``n_draws`` (default: their count)."""
    n_draws = stacked_params[0]["w"].shape[0] if n_draws is None else n_draws
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        (grad,) = torch.autograd.grad(_summed_loss(apply_fn, stacked_params, x, labels) / n_draws, x)
    return grad


def expected_loss_gradients(
    model,
    x,
    y,
    *,
    n_samples: Optional[int],
    seeds: Optional[Sequence[int]] = None,
    batch_size: int = 128,
    mesh=None,
    eps=None,
) -> torch.Tensor:
    """Mean input gradient over S fixed posterior draws — shaped like ``x``, on
    ``model.device``.

    ``model`` is a :class:`.models.bnn.BNN` or a
    :class:`.models.ensemble.EnsembleNN`. The draws are ``seeds``, by default
    ``range(n_samples)`` (the reference's fixed draws,
    ``lossGradients.py:29-33``): an SVI posterior's seeded draws, or an HMC
    posterior's samples or an ensemble's members of those indices (checked on
    the host). For SVI, ``eps``, a stacked ``(S, ...)`` noise tree, can
    replace the seeded noise, so a test can inject another package's draws.

    ``n_samples=None`` is the deterministic branch: the input gradient of the
    CE of ``model.predictive_fn()``'s output, one per image (an NN's).
    """
    from robustbnns_tpu_torch.attacks.gradient_attacks import _input_gradients
    from robustbnns_tpu_torch.inference.svi import sample_meanfield_eps
    from robustbnns_tpu_torch.predict import hmc_sample_index, sample_eps

    mesh = resolve_mesh(mesh)
    if mesh is not None:
        mesh.check(model.device)
    x = torch.as_tensor(x, device=model.device)
    y = torch.as_tensor(y, device=model.device)
    labels = y.argmax(dim=-1) if y.dim() > 1 else y

    def batches(grads_of):
        """``grads_of(x, labels)`` over the batches, each batch's rows split over ``data``."""
        out = []
        for i in range(0, x.shape[0], batch_size):
            bx, bl = x[i : i + batch_size], labels[i : i + batch_size]
            out.append(grads_of(bx, bl) if mesh is None else run_on_rows(grads_of, mesh, bx, bl))
        return torch.cat(out)

    if n_samples is None:
        forward = model.predictive_fn()
        return batches(lambda bx, bl: _input_gradients(forward, bx, bl, None))
    seeds = list(range(n_samples)) if seeds is None else list(seeds)
    if getattr(model, "posterior", None) is not None:  # SVI
        posterior = model.posterior
        if eps is None:
            eps = sample_eps(posterior.loc, n_samples, seeds=seeds, device=model.device)
        if eps[0]["w"].shape[0] != n_samples:
            raise ValueError("Number of draws in `eps` should match number of samples.")
        weights = sample_meanfield_eps(posterior, eps)
    elif getattr(model, "samples", None) is not None:  # HMC
        if eps is not None:
            raise ValueError("`eps` is SVI noise: an HMC posterior's draws are its samples")
        if len(seeds) != n_samples:
            raise ValueError("Number of seeds should match number of samples.")
        weights = model.sample_draws(seeds)
    elif getattr(model, "stacked_params", None) is not None:  # ensemble: the seeds index members
        if eps is not None:
            raise ValueError("`eps` is SVI noise: an ensemble's draws are its members")
        if len(seeds) != n_samples:
            raise ValueError("Number of seeds should match number of samples.")
        weights = index_tree(model.stacked_params, hmc_sample_index(model.stacked_params, seeds, model.device))
    else:
        raise ValueError("model has no posterior — train() or load() first")

    if mesh is None:
        return batches(lambda bx, bl: _mean_input_grads(model.arch.apply, weights, bx, bl))
    draws = split_rows(n_samples, mesh, "sample")  # this rank's draws; the sum over S crosses ranks
    local = map_params(lambda v: v[draws], weights)

    def grads_of(bx, bl):
        if draws.stop > draws.start:
            g = _mean_input_grads(model.arch.apply, local, bx, bl, n_samples)
        else:
            g = torch.zeros_like(bx)
        return reduce_sum([g], mesh, "sample")[0]

    return batches(grads_of)


def loss_gradients(
    model,
    x,
    y,
    *,
    n_samples: Optional[int],
    filename: str,
    savedir: str,
    rel_path: str = DATA,
    batch_size: int = 128,
    mesh=None,
    verbose: bool = True,
) -> np.ndarray:
    """Compute and save expected gradients (reference ``lossGradients.py:52-68``).

    Returns the squeezed numpy array the plotting layer consumes.
    """
    if verbose:
        print(f"\n === Loss gradients on {len(x)} input images:")
    grads = expected_loss_gradients(model, x, y, n_samples=n_samples, batch_size=batch_size, mesh=mesh)
    if verbose:
        print(f"\nmin = {float(grads.min()):.4f} \t max = {float(grads.max()):.4f}")
    out = grads.detach().cpu().numpy().squeeze()
    save_loss_gradients(out, n_samples, filename, savedir, rel_path, mesh)
    return out


def _grads_path(n_samples, filename, savedir, rel_path) -> str:
    """Reference naming scheme (``lossGradients.py:70-76``)."""
    return os.path.join(rel_path, savedir, f"{filename}_samp={n_samples}_lossGrads.npz")


def save_loss_gradients(grads, n_samples, filename, savedir, rel_path=DATA, mesh=None) -> str:
    """Write the gradients; under a mesh (``mesh`` or the default) on rank 0 only."""
    path = _grads_path(n_samples, filename, savedir, rel_path)

    def write():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.savez_compressed(path, loss_gradients=np.asarray(grads))

    write_on_rank_zero(write, mesh)
    return path


def load_loss_gradients(n_samples, filename, savedir, rel_path=DATA) -> np.ndarray:
    with np.load(_grads_path(n_samples, filename, savedir, rel_path)) as data:
        return data["loss_gradients"]


def compute_vanishing_norms_idxs(
    loss_gradients: np.ndarray,
    n_samples_list: Sequence[int],
    norm: str = "linfty",
    verbose: bool = True,
) -> list[int]:
    """Indices of images whose gradient norms vanish with more samples.

    ``loss_gradients`` has shape ``(n_images, len(n_samples_list), ...)``
    (reference ``lossGradients.py:78-127``; see the module docstring for the
    monotonicity rule).
    """
    grads = np.asarray(loss_gradients)
    if grads.shape[1] != len(n_samples_list):
        raise ValueError("Second dimension should equal the length of `n_samples_list`")

    flat = grads.reshape(grads.shape[0], grads.shape[1], -1)
    if norm == "linfty":
        norms = np.max(np.abs(flat), axis=-1)
    elif norm == "l2":
        norms = np.linalg.norm(flat, axis=-1)
    else:
        raise ValueError(f"unknown norm {norm!r}")

    first_nonzero = norms[:, 0] != 0.0
    monotone = np.all(np.diff(norms, axis=1) <= 0.0, axis=1)

    vanishing = first_nonzero & monotone
    increasing = first_nonzero & ~monotone
    null = ~first_nonzero

    idxs = [int(i) for i in np.nonzero(vanishing)[0]]
    if verbose:
        n = len(grads)
        print(f"vanishing gradients = {vanishing.sum() / n} %")
        print(f"increasing gradients = {increasing.sum() / n} %")
        print(f"null gradients = {null.sum() / n} %")
        print("\nvanishing_gradients_idxs = ", idxs)
    return idxs
