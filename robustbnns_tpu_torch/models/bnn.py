"""The BNN model, SVI branch (port of ``robustbnns_tpu/models/bnn.py``).

A dataclass holding the configuration, the architecture, the device and the
mean-field posterior, with ``train`` / ``forward`` / ``evaluate`` /
``predictive_fn`` / ``save`` / ``load`` mirroring the reference surface
(``model_bnn.py:69``), for every SVI model of the zoo: ``fc``/``fc2`` and the
``conv`` models (``model_0``, ``2``, ``4``, ``6``, ``8``). ``train`` runs SVI
(:func:`.inference.svi.svi_train`); the HMC/NUTS branch waits for its slice.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import torch

from robustbnns_tpu_torch.config import BNNConfig, TESTS, bnn_batch_size
from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior, svi_train
from robustbnns_tpu_torch.models.architectures import Architecture, build_architecture
from robustbnns_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from robustbnns_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class BNN:
    """A Bayesian neural network with an SVI posterior over an architecture."""

    config: BNNConfig
    arch: Architecture
    device: torch.device
    n_inputs: Optional[int] = None
    posterior: Optional[MeanFieldPosterior] = None
    history: Optional[dict] = None  # per-epoch loss and accuracy of the last train()
    # Memoized predictive closures, one per (n_samples, seeds, avg_posterior).
    _fn_cache: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_config(
        cls,
        config: BNNConfig,
        input_shape,
        output_size: int,
        n_inputs: Optional[int] = None,
        device="cuda",
    ) -> "BNN":
        if config.inference != "svi":
            raise NotImplementedError(
                f"inference {config.inference!r} is not ported yet: it comes with "
                "the HMC/NUTS slice (ROADMAP.md)"
            )
        arch = build_architecture(
            config.architecture, config.activation, input_shape, output_size,
            config.hidden_size, dataset_name=config.dataset,
        )
        return cls(config=config, arch=arch, device=resolve_device(device), n_inputs=n_inputs)

    @property
    def name(self) -> str:
        """Checkpoint identity string (reference ``model_bnn.py:90-103``)."""
        return self.config.name(self.n_inputs)

    def train(
        self,
        x_train,
        y_train,
        *,
        batch_size: Optional[int] = None,
        seed: int = 0,
        train_acc_samples: int = 10,
        mesh=None,
        verbose: bool = True,
    ) -> "BNN":
        """Train the SVI posterior on ``self.device`` (reference ``model_bnn.py:350-365``).

        The posterior comes back with detached leaves, so attacks on it launch
        no parameter-gradient kernel.
        """
        self._fn_cache.clear()  # cached closures hold the previous posterior
        self.posterior, self.history = svi_train(
            self.arch,
            x_train,
            y_train,
            epochs=self.config.epochs,
            lr=self.config.lr,
            batch_size=batch_size or bnn_batch_size(self.config),
            seed=seed,
            train_acc_samples=train_acc_samples,
            mesh=mesh,
            verbose=verbose,
            device=self.device,
        )
        return self

    # ------------------------------------------------------------------ #
    # posterior predictive (reference model_bnn.py:198-258)
    # ------------------------------------------------------------------ #

    def _require_posterior(self) -> MeanFieldPosterior:
        if self.posterior is None:
            raise ValueError("load() the BNN first")
        return self.posterior

    @torch.no_grad()
    def forward(
        self,
        x: torch.Tensor,
        n_samples: Optional[int] = 10,
        *,
        generator: Optional[torch.Generator] = None,
        seeds: Optional[Sequence[int]] = None,
        avg_posterior: bool = False,
    ) -> torch.Tensor:
        """Averaged softmax probabilities, or raw logits for ``avg_posterior``.

        ``n_samples=None`` means the reference's default of 10. Draws are seeded
        by ``seeds`` or fresh from the CPU ``generator``.
        """
        from robustbnns_tpu_torch.predict import sample_eps, svi_avg_posterior_predict, svi_predict

        posterior = self._require_posterior()
        if avg_posterior:
            return svi_avg_posterior_predict(self.arch, posterior, x)
        eps = sample_eps(posterior.loc, n_samples or 10, generator=generator, seeds=seeds, device=self.device)
        return svi_predict(self.arch, posterior, x, eps)

    def evaluate(
        self,
        x_test,
        y_test,
        *,
        n_samples: int = 10,
        seeds: Optional[Sequence[int]] = None,
        batch_size: int = 128,
        verbose: bool = True,
    ) -> float:
        """Posterior-predictive accuracy in percent, seeded with ``range(n_samples)``
        by default (reference ``model_bnn.py:367-391``)."""
        from robustbnns_tpu_torch.predict import batched_eval

        if seeds is None:
            seeds = list(range(n_samples))
        forward = self.predictive_fn(n_samples=n_samples, seeds=seeds)
        x = torch.as_tensor(x_test, device=self.device)
        y = torch.as_tensor(y_test, device=self.device)
        _, correct = batched_eval(forward, x, y, batch_size=batch_size)
        accuracy = 100.0 * float(correct) / len(x)
        if verbose:
            print("Accuracy: %.2f%%" % accuracy)
        return accuracy

    def predictive_fn(
        self,
        n_samples: Optional[int] = 10,
        *,
        seeds: Optional[Sequence[int]] = None,
        avg_posterior: bool = False,
        fused: bool = False,
    ):
        """A memoized ``f(x, generator=None) -> outputs`` closure for attacks and evaluation.

        With ``seeds`` (or ``avg_posterior``) the closure is deterministic: the
        seeded weight draws are made once, when the closure is built. Without,
        it draws fresh weights from the generator on every call, as the
        reference does at attack time (``adversarialAttacks.py:97``).
        ``fused=True`` (fresh-draw mode, fc/fc2) routes through the CUDA
        sampled-dense kernels; the conv architectures have no fused path and
        raise, as in the JAX package.
        """
        from robustbnns_tpu_torch.inference.svi import sample_meanfield_eps
        from robustbnns_tpu_torch.predict import sample_eps, svi_predict

        n_samples = n_samples or 10
        posterior = self._require_posterior()
        if fused:
            if avg_posterior or seeds is not None:
                raise ValueError("fused predictive supports SVI fresh-draw mode only")
            from robustbnns_tpu_torch.ops.fused_predict import fused_predictive_fn, supports_fused

            if not supports_fused(self.arch):
                raise NotImplementedError("fused predictive supports fc/fc2 architectures")
            cache_key = ("fused", n_samples)
            if cache_key not in self._fn_cache:
                self._fn_cache[cache_key] = fused_predictive_fn(self.arch, posterior, n_samples)
            return self._fn_cache[cache_key]

        cache_key = (n_samples, tuple(seeds) if seeds is not None else None, bool(avg_posterior))
        if cache_key in self._fn_cache:
            return self._fn_cache[cache_key]
        apply = self.arch.apply
        if avg_posterior:
            def fn(x, generator=None):
                return apply(posterior.loc, x)
        elif seeds is not None:
            weights = sample_meanfield_eps(
                posterior, sample_eps(posterior.loc, n_samples, seeds=seeds, device=self.device)
            )

            def fn(x, generator=None):
                return torch.softmax(apply(weights, x), dim=-1).mean(dim=0)
        else:
            def fn(x, generator=None):
                if generator is None:
                    raise ValueError("the fresh-draw predictive needs a CPU generator")
                eps = sample_eps(posterior.loc, n_samples, generator=generator, device=self.device)
                return svi_predict(self.arch, posterior, x, eps)
        self._fn_cache[cache_key] = fn
        return fn

    # ------------------------------------------------------------------ #
    # persistence (reference model_bnn.py:138-196)
    # ------------------------------------------------------------------ #

    def _ckpt_path(self, rel_path: str, filename: Optional[str]) -> str:
        filename = filename or (self.name + "_weights")
        return os.path.join(rel_path, self.name, filename)

    def save(self, rel_path: str = TESTS, filename: Optional[str] = None) -> str:
        posterior = self._require_posterior()
        path = save_pytree(
            posterior,
            self._ckpt_path(rel_path, filename),
            meta={"name": self.name, "inference": self.config.inference},
        )
        print(f"\nSaving {path}")
        return path

    def load(self, rel_path: str = TESTS, filename: Optional[str] = None) -> "BNN":
        self._fn_cache.clear()  # cached closures hold the previous posterior
        path = self._ckpt_path(rel_path, filename)
        template = self.arch.init(torch.Generator().manual_seed(0))
        self.posterior = load_pytree(
            MeanFieldPosterior(loc=template, rho=template), path, device=self.device
        )
        print(f"\nLoading {path}")
        return self
