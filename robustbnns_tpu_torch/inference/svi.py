"""Stochastic variational inference with a mean-field Gaussian posterior (port of
``robustbnns_tpu/inference/svi.py``).

* The variational posterior is two parameter trees ``{loc, rho}`` with
  ``q(w) = N(loc, softplus(rho)^2)`` per scalar (reference guide
  ``model_bnn.py:127``).
* The loss is the negative ELBO: the analytic Normal‖Normal KL against the iid
  N(0, 1) prior plus a one-draw reparameterized estimate of the categorical
  log-likelihood, **summed** over the batch, with the KL counted once per step
  and not scaled (the reference's quirk, kept: ``model_bnn.py:116-119,309``).
* ``loc, rho ~ N(0, 1)`` at init (reference ``model_bnn.py:125-126``).
* An epoch is a Python loop over the padded batches: draw → forward → ELBO
  backward → Adam, then the reference's 10-draw train-accuracy predictive
  (``model_bnn.py:327``) under ``torch.no_grad``. The draws are materialised and
  their products go to ``torch.matmul`` (and ``F.conv2d`` for the conv
  architectures: the ELBO draw through the one-draw ``apply``, the accuracy
  draws through the stacked one), as the JAX package leaves them to XLA;
  the fused sampled-dense kernels' parameter backward computes the same
  gradient from in-kernel noise (``tests/test_torch_svi.py`` holds the two to
  each other).

Every draw can be injected (:class:`EpochDraws`), so a test can replay the JAX
package's threefry draws; otherwise they come from a seeded ``torch.Generator``
on the training device. Losses and correct counts stay on the device, and the
host reads them once per epoch.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Iterable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from robustbnns_tpu_torch.data.loaders import batch_arrays
from robustbnns_tpu_torch.parallel.mesh import reduce_sum, replicate, resolve_mesh, split_rows, sum_gradients
from robustbnns_tpu_torch.utils.device import exact_f32, resolve_device
from robustbnns_tpu_torch.utils.pytree import Params, map_params, normal_like_tree, tree_leaves
from robustbnns_tpu_torch.utils.timing import count, execution_time, span


class MeanFieldPosterior(NamedTuple):
    """Variational parameters: two trees shaped like the network's parameters."""

    loc: Params
    rho: Params


def init_meanfield(generator: torch.Generator, params_template: Params) -> MeanFieldPosterior:
    """``loc, rho ~ N(0, 1)`` — the reference's ``randn_like`` init (``model_bnn.py:125-126``)."""
    return MeanFieldPosterior(
        loc=normal_like_tree(generator, params_template),
        rho=normal_like_tree(generator, params_template),
    )


def svi_init(arch, generator: torch.Generator) -> MeanFieldPosterior:
    """The default start of :func:`svi_train`: :func:`init_meanfield` from
    ``generator`` on the shapes of ``arch.init`` from generator 0 (JAX
    ``svi.py:229-230``), on the generator's device."""
    template = arch.init(torch.Generator(device=generator.device).manual_seed(0))
    return init_meanfield(generator, template)


def meanfield_scale(posterior: MeanFieldPosterior) -> Params:
    return map_params(F.softplus, posterior.rho)


def sample_meanfield_eps(posterior: MeanFieldPosterior, eps: Params) -> Params:
    """The reparameterized draw ``w = loc + softplus(rho)·eps`` for a given ``eps``.

    ``eps`` leaves may carry a leading sample axis; the draw then does too.
    """
    return map_params(
        lambda m, r, e: m + F.softplus(r) * e, posterior.loc, posterior.rho, eps
    )


def sample_meanfield(posterior: MeanFieldPosterior, generator: torch.Generator) -> Params:
    """One reparameterized weight draw with ``eps`` from ``generator``."""
    return sample_meanfield_eps(posterior, normal_like_tree(generator, posterior.loc))


def gaussian_kl_to_std_normal(posterior: MeanFieldPosterior) -> torch.Tensor:
    """Analytic ``KL(N(loc, σ) ‖ N(0, 1))`` summed over all parameters (reference
    ``model_bnn.py:309``)."""
    total = 0.0
    for m, r in zip(tree_leaves(posterior.loc), tree_leaves(posterior.rho)):
        s = F.softplus(r)
        total = total + torch.sum(0.5 * (s * s + m * m - 1.0) - torch.log(s))
    return total


def categorical_loglik_sum(logits, labels, mask=None) -> torch.Tensor:
    """Σ_i log p(y_i | logits_i), padded rows masked out (``model_bnn.py:116-119``)."""
    ll = torch.log_softmax(logits, dim=-1).gather(-1, labels[:, None])[:, 0]
    if mask is not None:
        ll = ll * mask
    return ll.sum()


def elbo_loss(apply_fn, posterior: MeanFieldPosterior, eps: Params, x, labels, mask=None, kl: bool = True):
    """Negative ELBO for one batch: ``KL − Σ log p(y|x,w)`` with the one draw
    ``w = loc + softplus(rho)·eps`` (the JAX function draws ``eps`` from a key).
    ``kl=False`` leaves the KL out: the part of the sum that one rank of a
    data-parallel step adds besides the rank that adds the KL."""
    loglik = categorical_loglik_sum(apply_fn(sample_meanfield_eps(posterior, eps), x), labels, mask)
    return gaussian_kl_to_std_normal(posterior) - loglik if kl else -loglik


def elbo_step(apply_fn, optimizer: torch.optim.Optimizer, posterior: MeanFieldPosterior, eps: Params, x,
              labels, mask=None, mesh=None) -> torch.Tensor:
    """One ELBO step of ``optimizer``, whose parameters are the leaves of
    ``posterior`` (updated in place); returns the loss, detached.

    With ``mesh`` (:mod:`.parallel.mesh`) the batch's rows split over
    ``data`` (:func:`.parallel.mesh.split_rows`), the KL is added on ``data``
    index 0 only, and the loss and every gradient are summed over ``data`` in
    one flat all-reduce before the step, so every rank steps alike.
    """
    optimizer.zero_grad(set_to_none=True)
    if mesh is None:
        with span("svi.elbo.forward"):
            loss = elbo_loss(apply_fn, posterior, eps, x, labels, mask)
        with span("svi.elbo.backward"):
            loss.backward()
        optimizer.step()
        return loss.detach()

    leaves = tree_leaves(posterior.loc) + tree_leaves(posterior.rho)
    rows, kl = split_rows(x.shape[0], mesh), mesh.index("data") == 0
    with span("svi.elbo.forward"):
        if rows.stop > rows.start:
            loss = elbo_loss(apply_fn, posterior, eps, x[rows], labels[rows], None if mask is None else mask[rows],
                             kl)
        else:  # this rank holds no row of the batch
            loss = gaussian_kl_to_std_normal(posterior) if kl else x.new_zeros((), requires_grad=True)
    with span("svi.elbo.backward"):
        loss.backward()
    loss = sum_gradients(loss, leaves, mesh)
    optimizer.step()
    return loss


class EpochDraws(NamedTuple):
    """The random draws of one epoch.

    ``perm`` (n,) shuffles the rows. ``elbo_eps`` yields, per step, a noise tree
    shaped like the posterior; ``acc_eps`` one with a leading
    ``(train_acc_samples,)`` axis (or ``None`` when there is no accuracy
    predictive). Both are consumed step by step, in order.
    """

    perm: torch.Tensor
    elbo_eps: Iterable[Params]
    acc_eps: Iterable[Optional[Params]]


def generator_draws(
    generator: torch.Generator, like: Params, n: int, num_batches: int, train_acc_samples: int
) -> EpochDraws:
    """An epoch's draws from ``generator``, made on its device as the loop asks for them."""

    def noise(*lead):
        return map_params(
            lambda p: torch.randn(lead + tuple(p.shape), generator=generator,
                                  device=generator.device, dtype=p.dtype),
            like,
        )

    return EpochDraws(
        perm=torch.randperm(n, generator=generator, device=generator.device),
        elbo_eps=(noise() for _ in range(num_batches)),
        acc_eps=(noise(train_acc_samples) if train_acc_samples else None for _ in range(num_batches)),
    )


def _train_correct(apply_fn, posterior, eps, bx, labels, mask, bf16: bool) -> torch.Tensor:
    """Correct rows of one batch under the averaged softmax of the stacked draws ``eps``."""
    with span("svi.accuracy"):
        w = sample_meanfield_eps(posterior, eps)
        if bf16:  # metric only: the ELBO step above stays f32
            w = map_params(lambda a: a.to(torch.bfloat16), w)
            bx = bx.to(torch.bfloat16)
        probs = torch.softmax(apply_fn(w, bx).float(), dim=-1).mean(dim=0)
        return ((probs.argmax(-1) == labels) * mask).sum()


def svi_epoch(
    apply_fn,
    optimizer: torch.optim.Optimizer,
    batch_size: int,
    train_acc_samples: int,
    posterior: MeanFieldPosterior,
    x: torch.Tensor,
    y: torch.Tensor,
    draws: EpochDraws,
    train_acc_bf16: bool = False,
    mesh=None,
):
    """One SVI epoch (reference hot loop ``model_bnn.py:316-341``, JAX ``_svi_epoch``).

    Per batch: one ELBO step on ``optimizer`` (:func:`elbo_step`, with
    ``mesh`` data-parallel); then, when ``train_acc_samples > 0``, the
    ``train_acc_samples``-draw predictive for the epoch accuracy on this
    rank's rows, with bf16 products under ``train_acc_bf16``. Returns the
    summed loss and the correct count (summed over ``data`` once, at the end)
    as device scalars, without synchronising.

    The products are exact f32 (:func:`.utils.device.exact_f32`) whoever
    calls it, as in :func:`svi_train`: cuDNN's convolutions otherwise take
    TF32 by default.
    """
    exact_f32()
    xb, yb, mb = batch_arrays(x, y, batch_size, perm=draws.perm)
    loss_sum, correct = x.new_zeros(()), x.new_zeros(())
    rows = slice(None)
    if mesh is not None:
        rows = split_rows(batch_size, mesh)
    steps = zip(xb, yb, mb, draws.elbo_eps, draws.acc_eps, strict=True)
    for _ in range(xb.shape[0]):
        with span("svi.step", count("svi.steps")):
            with span("svi.draws"):
                bx, by, mask, eps, acc_eps = next(steps)
            labels = by.argmax(-1)
            loss_sum += elbo_step(apply_fn, optimizer, posterior, eps, bx, labels, mask, mesh)
            if train_acc_samples > 0 and bx[rows].shape[0]:
                with torch.no_grad():
                    correct += _train_correct(apply_fn, posterior, acc_eps, bx[rows], labels[rows], mask[rows],
                                              train_acc_bf16)
    next(steps, None)  # the strict zip raises here if draws are left over
    if mesh is not None:
        (correct,) = reduce_sum([correct], mesh)
    return loss_sum, correct


def svi_train(
    arch,
    x_train,
    y_train,
    *,
    epochs: int,
    lr: float,
    batch_size: int = 128,
    seed: int = 0,
    train_acc_samples: int = 10,
    train_acc_bf16: Optional[bool] = None,
    mesh=None,
    verbose: bool = True,
    device="cuda",
    init: Optional[MeanFieldPosterior] = None,
    draws: Optional[Callable[[int], EpochDraws]] = None,
):
    """Train a mean-field BNN posterior (reference ``_train_svi``).

    Returns ``(posterior, history)``: the posterior's leaves are detached
    (``requires_grad=False``), so a later attack's backward asks for no
    parameter gradient; ``history`` holds the per-epoch summed loss and train
    accuracy in percent (reference ``model_bnn.py:335-339``), and each epoch's
    wall seconds up to its one synchronisation.

    Adam with b1 0.9, b2 0.999, eps 1e-8 (JAX ``svi.py:232``). The start is
    ``init``, else :func:`svi_init` from the generator seeded with ``seed``,
    which also makes every epoch's draws unless ``draws(epoch)`` gives them.
    ``train_acc_bf16`` (default: the ``ROBUSTBNNS_BF16_TRAINACC=1`` opt-in)
    runs the accuracy predictive in bf16; the optimisation is untouched.

    With ``mesh`` (or a process default, :func:`.parallel.mesh.set_default_mesh`)
    the start is broadcast from rank 0, each batch's rows split over ``data``
    (:func:`elbo_step`), Adam runs replicated, and every rank returns the same
    posterior and history: bit-equal to the unmeshed run at one rank, within
    f32 rounding of it at several.
    """
    if train_acc_bf16 is None:
        train_acc_bf16 = os.environ.get("ROBUSTBNNS_BF16_TRAINACC") == "1"
    device = resolve_device(device)
    mesh = resolve_mesh(mesh)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    if init is None:
        init = svi_init(arch, generator)
    init = MeanFieldPosterior(*(map_params(lambda v: v.detach().to(device, torch.float32), tree) for tree in init))
    if mesh is not None:
        mesh.check(device)
        init = replicate(init, mesh)
    posterior = MeanFieldPosterior(*(map_params(lambda v: v.clone().requires_grad_(True), tree) for tree in init))
    optimizer = torch.optim.Adam(
        tree_leaves(posterior.loc) + tree_leaves(posterior.rho), lr=lr, betas=(0.9, 0.999), eps=1e-8
    )
    x = torch.as_tensor(x_train, device=device)
    y = torch.as_tensor(y_train, device=device)
    n = x.shape[0]
    num_batches = -(-n // batch_size)

    start = time.time()
    history = {"loss": [], "accuracy": [], "seconds": []}
    for epoch in range(epochs):
        epoch_start = time.perf_counter()
        epoch_draws = (
            draws(epoch) if draws is not None
            else generator_draws(generator, posterior.loc, n, num_batches, train_acc_samples)
        )
        loss_sum, correct = svi_epoch(
            arch.apply, optimizer, batch_size, train_acc_samples, posterior, x, y,
            epoch_draws, train_acc_bf16=bool(train_acc_bf16), mesh=mesh,
        )
        loss_sum, correct = float(loss_sum), float(correct)  # the epoch's one synchronisation
        history["loss"].append(loss_sum)
        history["accuracy"].append(100.0 * correct / n)
        history["seconds"].append(time.perf_counter() - epoch_start)
        if verbose:
            print(
                f"\n[Epoch {epoch + 1}]\t loss: {loss_sum / n:.2f} \t "
                f"accuracy: {100.0 * correct / n:.2f}",
                end="\t",
                flush=True,
            )
    if verbose:
        execution_time(start=start, end=time.time())
    return MeanFieldPosterior(*(map_params(torch.Tensor.detach, tree) for tree in posterior)), history
