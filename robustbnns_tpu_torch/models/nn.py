"""Deterministic NN training and evaluation (port of
``robustbnns_tpu/models/nn.py``; reference ``model_nn.py:175-239``).

Semantics kept from the reference and the JAX package:

* Adam with betas 0.9/0.999 and eps 1e-8 at the config's ``lr`` (reference
  ``model_nn.py:190``);
* cross-entropy on raw logits against integer labels, the mean over a
  batch's real rows (reference ``model_nn.py:44,203``);
* a fresh shuffle every epoch (``DataLoader(shuffle=True)``), the last batch
  padded and masked (:func:`.data.loaders.batch_arrays`);
* the epoch log line of ``total_loss / N`` and the accuracy (reference
  ``model_nn.py:211-213``).

An epoch is a Python loop over the batches (JAX runs one ``lax.scan``); the
losses and correct counts stay on the device, and the host reads them once,
after the last epoch. The initial parameters and each epoch's permutation can
be injected, so a test can replay the JAX package's.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import torch

from robustbnns_tpu_torch.data.loaders import batch_arrays
from robustbnns_tpu_torch.models.architectures import Architecture
from robustbnns_tpu_torch.parallel.mesh import reduce_sum, replicate, resolve_mesh, split_rows, sum_gradients
from robustbnns_tpu_torch.utils.device import resolve_device
from robustbnns_tpu_torch.utils.pytree import Params, map_params, tree_leaves
from robustbnns_tpu_torch.utils.timing import execution_time


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None, count=None) -> torch.Tensor:
    """Mean cross-entropy over the valid rows; ``labels`` are integer classes.
    Leading axes before the batch (an ensemble's members) give one mean each.
    ``count`` (default ``mask``'s) is the number of valid rows to divide by:
    a data-parallel rank divides its rows' sum by the whole batch's count."""
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels.unsqueeze(-1)).squeeze(-1)
    if mask is None:
        return nll.mean(-1)
    return (nll * mask).sum(-1) / torch.clamp(mask.sum() if count is None else count, min=1.0)


def trainable(params: Params, device) -> Params:
    """Float32 copies of ``params`` on ``device`` that require gradients."""
    return map_params(lambda v: v.detach().to(device, torch.float32).clone().requires_grad_(True), params)


@dataclasses.dataclass
class DeterministicNN:
    """A trained deterministic network: architecture, parameter tree and device."""

    arch: Architecture
    params: Optional[Params]
    name: Optional[str] = None  # checkpoint identity (reference model_nn.py:56)
    device: Optional[torch.device] = None  # default: the parameters', else the card
    history: Optional[dict] = None  # per-epoch loss per image and accuracy of train_nn
    _fn: object = dataclasses.field(default=None, repr=False)  # memoized closure

    def __post_init__(self):
        if self.device is None:
            self.device = tree_leaves(self.params)[0].device if self.params is not None else resolve_device()

    def _path(self, rel_path: str, savedir: Optional[str], seed) -> str:
        if self.name is None:
            raise ValueError("set model.name before saving or loading")
        fname = f"{self.name}_weights" + (f"_{seed}" if seed is not None else "")
        return os.path.join(rel_path, savedir if savedir is not None else self.name, fname)

    def save(self, rel_path: str, savedir: Optional[str] = None, seed=None) -> str:
        """Write the weights under the reference's naming scheme
        (``model_nn.py:143-151``): ``<dir>/<name>_weights[_<seed>].npz``."""
        from robustbnns_tpu_torch.utils.checkpoint import save_pytree

        path = save_pytree(self.params, self._path(rel_path, savedir, seed))
        print("\nSaving: ", path)
        return path

    def load(self, rel_path: str, savedir: Optional[str] = None, seed=None) -> "DeterministicNN":
        """Read weights saved by :meth:`save` in either package (``model_nn.py:158-168``)."""
        from robustbnns_tpu_torch.utils.checkpoint import load_pytree

        path = self._path(rel_path, savedir, seed)
        template = self.params if self.params is not None else self.arch.init(torch.Generator().manual_seed(0))
        self.params = load_pytree(template, path, device=self.device)
        self._fn = None  # drop the closure over the old params
        print("\nLoading: ", path)
        return self

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.arch.apply(self.params, x)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, n_samples=None, **_ignored) -> torch.Tensor:
        """Raw logits. Extra keyword arguments (``n_samples``,
        ``avg_posterior``, ...) are accepted and ignored, as the reference's
        ``NN.forward(*args, **kwargs)`` does (``model_nn.py:126``), so one
        attack serves every model type."""
        return self.arch.apply(self.params, x)

    def predictive_fn(self, n_samples=None, **_ignored):
        """A memoized ``f(x, generator=None) -> logits`` closure for attacks
        and analysis; the generator is ignored."""
        if self._fn is None:
            apply, params = self.arch.apply, self.params
            self._fn = lambda x, generator=None: apply(params, x)
        return self._fn


def train_nn(
    arch: Architecture,
    x_train,
    y_train,
    *,
    epochs: int,
    lr: float,
    batch_size: int = 64,
    seed: int = 0,
    name: Optional[str] = None,
    mesh=None,
    verbose: bool = True,
    device="cuda",
    init: Optional[Params] = None,
    perms: Optional[Callable[[int], torch.Tensor]] = None,
) -> DeterministicNN:
    """Train a deterministic NN (reference ``model_nn.py:175-219``, JAX
    ``nn.py:146-215``) on ``device``.

    ``seed`` seeds one generator on the device that makes the initial
    parameters (``arch.init``) and each epoch's permutation, unless ``init``
    (a parameter tree) or ``perms(epoch)`` (a permutation of the rows) gives
    them. The returned model's ``history`` holds each epoch's loss per image
    (the sum of the batches' mean losses over N, as the reference prints it),
    its accuracy in percent and the seconds of the whole run.

    With ``mesh`` (or a process default) the start is broadcast from rank 0,
    each batch's rows split over ``data`` (each rank's share of the batch mean
    summed, with the loss, in one flat all-reduce a step), Adam runs
    replicated and the correct count is summed once an epoch: every rank
    returns the unmeshed model, bit-equal at one rank.
    """
    device = resolve_device(device)
    mesh = resolve_mesh(mesh)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    start_params = init if init is not None else arch.init(generator)
    if mesh is not None:
        mesh.check(device)
        start_params = replicate(map_params(lambda v: v.to(device, torch.float32), start_params), mesh)
    params = trainable(start_params, device)
    leaves = tree_leaves(params)
    optimizer = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    x = torch.as_tensor(x_train, device=device)
    y = torch.as_tensor(y_train, device=device)
    n = x.shape[0]
    rows = slice(None) if mesh is None else split_rows(batch_size, mesh)

    start = time.time()
    stats = []
    for epoch in range(epochs):
        perm = perms(epoch) if perms is not None else torch.randperm(n, generator=generator, device=device)
        xb, yb, mb = batch_arrays(x, y, batch_size, perm=torch.as_tensor(perm, device=device))
        loss_sum, correct = x.new_zeros(()), x.new_zeros(())
        for bx, by, mask in zip(xb, yb, mb):
            labels = by.argmax(-1)[rows]
            optimizer.zero_grad(set_to_none=True)
            if labels.shape[0]:
                logits = arch.apply(params, bx[rows])
                loss = cross_entropy(logits, labels, mask[rows], count=mask.sum())
                loss.backward()
                correct += ((logits.detach().argmax(-1) == labels) * mask[rows]).sum()
            else:  # this rank holds no row of the batch
                loss = x.new_zeros(())
            if mesh is not None:
                loss = sum_gradients(loss, leaves, mesh)
            optimizer.step()
            loss_sum += loss.detach()
        if mesh is not None:
            (correct,) = reduce_sum([correct], mesh)
        stats += [loss_sum, correct]
    # One synchronisation, after the last epoch: the device stays pipelined.
    values = torch.stack(stats).tolist() if stats else []
    history = {"loss": [v / n for v in values[0::2]], "accuracy": [100.0 * v / n for v in values[1::2]],
               "seconds": time.time() - start}
    if verbose:
        for epoch, (loss, accuracy) in enumerate(zip(history["loss"], history["accuracy"])):
            print(f"\n[Epoch {epoch + 1}]\t loss: {loss:.8f} \t accuracy: {accuracy:.2f}", end="\t")
        execution_time(start=start, end=time.time())
    return DeterministicNN(arch=arch, params=map_params(torch.Tensor.detach, params), name=name, device=device,
                           history=history)


def evaluate_nn(model: DeterministicNN, x_test, y_test, *, batch_size: int = 128, verbose: bool = True) -> float:
    """Accuracy in percent (reference ``model_nn.py:221-239``)."""
    from robustbnns_tpu_torch.predict import batched_eval

    x = torch.as_tensor(x_test, device=model.device)
    y = torch.as_tensor(y_test, device=model.device)
    _, correct = batched_eval(model.predictive_fn(), x, y, batch_size=batch_size)
    accuracy = 100.0 * float(correct) / x.shape[0]
    if verbose:
        print("\nAccuracy: %.2f%%" % accuracy)
    return accuracy
