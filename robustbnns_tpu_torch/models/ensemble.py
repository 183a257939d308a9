"""NN ensembles with their members as a stacked axis (port of
``robustbnns_tpu/models/ensemble.py``; reference ``model_ensemble.py``).

The reference trains ``ensemble_size`` NNs one after another with seeds
``0..E-1`` and stores one weight file per member (``model_ensemble.py:69-83``);
its forward averages **raw logits** over the first ``n_samples`` members
(``model_ensemble.py:57-67``), where the BNN averages softmax probabilities.
The asymmetry is kept: attack gradients differ.

The members are one parameter tree with a leading ``(E, ...)`` axis, run
through the stacked ``apply`` (:mod:`.architectures`: for the conv models one
convolution of E·32 channels and grouped convolutions). Training takes all
members' steps as one batched forward, backward and Adam step: member i
starts from its own initialisation and sees its own shuffles, each batch
gathered per member, so an input batch is ``(E, B, h, w, c)``.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import torch

from robustbnns_tpu_torch.models.architectures import Architecture
from robustbnns_tpu_torch.models.nn import cross_entropy, trainable
from robustbnns_tpu_torch.parallel.mesh import gather_axis, resolve_mesh, shard_axis
from robustbnns_tpu_torch.predict import ensemble_predict
from robustbnns_tpu_torch.utils.device import resolve_device
from robustbnns_tpu_torch.utils.pytree import Params, map_params, slice_tree, stack_trees, tree_leaves
from robustbnns_tpu_torch.utils.timing import execution_time


@dataclasses.dataclass
class EnsembleNN:
    """An ensemble: architecture, stacked ``(E, ...)`` parameter tree and device."""

    arch: Architecture
    stacked_params: Optional[Params]
    ensemble_size: int
    name: Optional[str] = None  # checkpoint identity (reference model_ensemble.py:26)
    device: Optional[torch.device] = None  # default: the parameters', else the card
    history: Optional[dict] = None  # per-epoch mean member loss per image of train_ensemble
    _fn_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.device is None:
            self.device = (tree_leaves(self.stacked_params)[0].device if self.stacked_params is not None
                           else resolve_device())

    def _path(self, rel_path: str) -> str:
        if self.name is None:
            raise ValueError("set model.name before saving or loading")
        return os.path.join(rel_path, self.name, "weights", f"{self.name}_stacked")

    def save(self, rel_path: str) -> str:
        """All members in ONE stacked checkpoint under ``<name>/weights/`` with
        meta ``ensemble_size`` (the reference writes one file per seed,
        ``model_ensemble.py:33-55``)."""
        from robustbnns_tpu_torch.utils.checkpoint import save_pytree

        path = save_pytree(self.stacked_params, self._path(rel_path), meta={"ensemble_size": self.ensemble_size})
        print("\nSaving: ", path)
        return path

    def load(self, rel_path: str) -> "EnsembleNN":
        """Read a stacked checkpoint written by either package."""
        from robustbnns_tpu_torch.utils.checkpoint import load_pytree

        template = self.stacked_params
        if template is None:
            one = self.arch.init(torch.Generator().manual_seed(0))
            template = map_params(lambda v: v.expand((self.ensemble_size,) + tuple(v.shape)), one)
        path = self._path(rel_path)
        self.stacked_params = load_pytree(template, path, device=self.device)
        self._fn_cache.clear()  # cached closures hold the previous params
        print("\nLoading: ", path)
        return self

    def _members(self, n_samples: Optional[int]) -> Params:
        n = self.ensemble_size if n_samples is None else n_samples
        if n > self.ensemble_size:
            raise ValueError(f"Maximum number of samples allowed is {self.ensemble_size}")
        return slice_tree(self.stacked_params, n)

    def member_logits(self, x: torch.Tensor, n_samples: Optional[int] = None) -> torch.Tensor:
        """Per-member logits ``(n, batch, classes)`` of the first n members."""
        return self.arch.apply(self._members(n_samples), x)

    def logits(self, x: torch.Tensor, n_samples: Optional[int] = None) -> torch.Tensor:
        """Mean of the raw member logits (reference ``model_ensemble.py:64-67``)."""
        return self.member_logits(x, n_samples).mean(dim=0)

    @torch.no_grad()
    def forward(self, x: torch.Tensor, n_samples: Optional[int] = None, **_ignored) -> torch.Tensor:
        """Mean raw logits over the first n members; other keyword arguments
        are ignored, as for the NN."""
        return self.logits(x, n_samples)

    def predictive_fn(self, n_samples: Optional[int] = None, **_ignored):
        """A ``f(x, generator=None) -> mean logits`` closure, memoized per
        member count; the generator is ignored."""
        members = self._members(n_samples)
        n = members[0]["w"].shape[0]
        if n not in self._fn_cache:
            arch = self.arch
            self._fn_cache[n] = lambda x, generator=None: ensemble_predict(arch, members, x, n)
        return self._fn_cache[n]

    def evaluate(self, x_test, y_test, *, n_samples: Optional[int] = None, batch_size: int = 64,
                 verbose: bool = True) -> float:
        """Accuracy in percent (reference ``model_ensemble.py:85-106``)."""
        from robustbnns_tpu_torch.predict import batched_eval

        x = torch.as_tensor(x_test, device=self.device)
        y = torch.as_tensor(y_test, device=self.device)
        _, correct = batched_eval(self.predictive_fn(n_samples), x, y, batch_size=batch_size)
        accuracy = 100.0 * float(correct) / x.shape[0]
        if verbose:
            print("\nAccuracy: %.2f%%" % accuracy)
        return accuracy


def _train_members(arch, x, y, lo: int, hi: int, *, epochs, lr, batch_size, label, verbose, device, init, perms,
                   all_losses=lambda loss_sum: loss_sum):
    """Members ``lo..hi-1`` trained together; returns their stacked
    parameters and each epoch's mean member loss per image, the mean taken
    over ``all_losses(loss_sum)`` (under a mesh: every rank's members)."""
    gens = [torch.Generator(device=device).manual_seed(i) for i in range(lo, hi)]
    start = stack_trees([arch.init(g) for g in gens]) if init is None else map_params(lambda v: v[lo:hi], init)
    params = trainable(start, device)
    optimizer = torch.optim.Adam(tree_leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    n = x.shape[0]
    num_batches = -(-n // batch_size)
    pad = num_batches * batch_size - n
    mask = torch.cat([x.new_ones(n), x.new_zeros(pad)]).reshape(num_batches, batch_size)
    losses = []
    for epoch in range(epochs):
        order = torch.stack([
            torch.as_tensor(perms(i, epoch), device=device) if perms is not None
            else torch.randperm(n, generator=g, device=device)
            for i, g in zip(range(lo, hi), gens)
        ])
        # Padded rows gather row 0; the mask zeroes their loss and gradient.
        order = torch.cat([order, order.new_zeros((hi - lo, pad))], 1).reshape(hi - lo, num_batches, batch_size)
        loss_sum = x.new_zeros(hi - lo)
        for k in range(num_batches):
            idx = order[:, k]
            loss = cross_entropy(arch.apply(params, x[idx]), y[idx].argmax(-1), mask[k])
            optimizer.zero_grad(set_to_none=True)
            loss.sum().backward()
            optimizer.step()
            loss_sum += loss.detach()
        losses.append(float(all_losses(loss_sum).mean()) / n)  # the epoch's one synchronisation
        if verbose:
            print(f"\n{label(epoch)} mean member loss: {losses[-1]:.6f}", end="\t", flush=True)
    return map_params(torch.Tensor.detach, params), losses


def _train_members_sharded(arch, x, y, lo: int, hi: int, mesh, **kwargs):
    """:func:`_train_members` for this rank's contiguous part of members
    ``lo..hi-1`` (:func:`.parallel.mesh.shard_axis` over ``sample``), the
    stacked leaves and each epoch's member losses gathered over ``sample``."""
    members = shard_axis(torch.arange(lo, hi), mesh, 0, "sample")
    own_lo, own_hi = int(members[0]), int(members[-1]) + 1
    params, losses = _train_members(arch, x, y, own_lo, own_hi,
                                    all_losses=lambda v: gather_axis(v, mesh, hi - lo, 0, "sample"), **kwargs)
    return map_params(lambda v: gather_axis(v, mesh, hi - lo, 0, "sample"), params), losses


def train_ensemble(
    arch: Architecture,
    x_train,
    y_train,
    *,
    ensemble_size: int,
    epochs: int,
    lr: float,
    batch_size: int = 100,
    name: Optional[str] = None,
    mesh=None,
    member_chunk: Optional[int] = None,
    verbose: bool = True,
    device="cuda",
    init: Optional[Params] = None,
    perms: Optional[Callable[[int, int], torch.Tensor]] = None,
) -> EnsembleNN:
    """Train all members at once (JAX ``ensemble.py:173-281``; the reference
    trains them one after another, ``model_ensemble.py:69-83``).

    Member i draws its initial parameters and its per-epoch shuffles from a
    generator on ``device`` seeded with i (the reference's seeds), unless
    ``init`` (a stacked ``(E, ...)`` tree) or ``perms(i, epoch)`` gives them.
    Adam (b1 0.9, b2 0.999, eps 1e-8) steps the stacked leaves, elementwise,
    so each member's step is its own. ``member_chunk`` trains the members in
    chunks of that size, bounding the optimiser state on the card to a
    chunk's; members share nothing, so chunking changes no member's numbers.
    The model's ``history`` holds, per chunk, each epoch's mean member loss
    per image (printed as the JAX package prints it).

    With ``mesh`` (or a process default) each chunk's members split over
    ``sample`` as contiguous ranges (all of them on every rank where the
    count does not divide), the dataset whole on every rank; member i keeps
    its own seed and shuffles, so the layout changes no member's numbers; the
    stacked leaves are gathered on every rank at the end of each chunk.
    """
    mesh = resolve_mesh(mesh)
    device = resolve_device(device)
    if mesh is not None:
        mesh.check(device)
    x = torch.as_tensor(x_train, device=device)
    y = torch.as_tensor(y_train, device=device)
    start = time.time()
    chunk = member_chunk or ensemble_size
    chunks, history = [], {"loss": []}
    for lo in range(0, ensemble_size, chunk):
        hi = min(lo + chunk, ensemble_size)

        def label(epoch, lo=lo, hi=hi):
            if lo == 0 and hi == ensemble_size:
                return f"[Ensemble epoch {epoch + 1}]"
            return f"[Ensemble members {lo}-{hi - 1} epoch {epoch + 1}]"

        kwargs = dict(epochs=epochs, lr=lr, batch_size=batch_size, label=label, verbose=verbose, device=device,
                      init=init, perms=perms)
        if mesh is None:
            params, losses = _train_members(arch, x, y, lo, hi, **kwargs)
        else:
            params, losses = _train_members_sharded(arch, x, y, lo, hi, mesh, **kwargs)
        # A finished chunk leaves the card, so chunking bounds device memory.
        chunks.append(map_params(torch.Tensor.cpu, params) if member_chunk is not None else params)
        history["loss"].append(losses)
    stacked = chunks[0] if member_chunk is None else map_params(lambda *v: torch.cat(v).to(device), *chunks)
    history["seconds"] = time.time() - start
    if verbose:
        execution_time(start=start, end=time.time())
    return EnsembleNN(arch=arch, stacked_params=stacked, ensemble_size=int(ensemble_size), name=name,
                      device=device, history=history)
