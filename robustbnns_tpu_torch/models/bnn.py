"""The BNN model: configuration, inference engines and posterior predictive
(port of ``robustbnns_tpu/models/bnn.py``).

A dataclass holding the configuration, the architecture, the device and the
trained posterior state — a :class:`MeanFieldPosterior` for SVI or a stacked
``(S, ...)`` parameter tree for HMC — with ``train`` / ``forward`` /
``evaluate`` / ``predictive_fn`` / ``save`` / ``load`` mirroring the reference
surface (``model_bnn.py:69``), for every model of the zoo: the SVI ``fc``/``fc2``
and ``conv`` models and the HMC models (``model_1``, ``3``, ``9``), sampled by
HMC or, with ``hmc_sampler='nuts'``, by NUTS (:mod:`.inference.nuts`), and,
outside the zoo, a Bayesian ResNet-20 (``BNNConfig("cifar", 16, "relu",
"resnet20", "svi", ...)``) and a Bayesian CCT-7/3×1 (``BNNConfig("cifar",
256, "relu", "cct7", "svi", ...)``).

The probabilistic model is the reference's (``model_bnn.py:105-119``): iid
``N(0, 1)`` priors on every parameter and a categorical likelihood on the
logits. Its HMC potential, on a flat parameter vector, is

    U(w) = 0.5·‖w‖² − Σ_i log softmax(f_w(x_i))[y_i]     (+ const)
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Union

import torch

from robustbnns_tpu_torch.config import BNNConfig, TESTS, bnn_batch_size
from robustbnns_tpu_torch.inference.hmc import HMCInfo, check_sampler, hmc_train_batched, map_warm_start
from robustbnns_tpu_torch.inference.nuts import NUTSInfo
from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior, svi_train
from robustbnns_tpu_torch.models.architectures import Architecture, build_architecture
from robustbnns_tpu_torch.parallel.mesh import replicate, resolve_mesh, split_rows
from robustbnns_tpu_torch.utils.checkpoint import load_pytree, save_pytree
from robustbnns_tpu_torch.utils.device import resolve_device
from robustbnns_tpu_torch.utils.pytree import Params, flatten_tree_to_vector, index_tree, map_params


def bnn_potential(arch: Architecture, unravel, prior: bool = True):
    """The HMC potential ``U(q, x, labels)`` of the reference's model
    (JAX ``bnn.py:129-137``) on flat vectors ``q`` of shape ``(..., D)``:
    one value per leading index (chain), through the stacked ``apply``.

    ``prior=False`` leaves the Gaussian prior out: the part of the potential
    that a data-parallel rank other than ``data`` index 0 adds. A batch of no
    rows adds no likelihood term."""

    def potential_fn(q, x, labels):
        log_prior = -0.5 * (q * q).sum(-1)
        if x.shape[0] == 0:
            return -log_prior if prior else 0.0 * log_prior
        logp = torch.log_softmax(arch.apply(unravel(q), x), dim=-1)
        loglik = logp.gather(-1, labels.expand(logp.shape[:-1]).unsqueeze(-1)).squeeze(-1).sum(-1)
        return -(log_prior + loglik) if prior else -loglik

    return potential_fn


@dataclasses.dataclass
class BNN:
    """A Bayesian neural network (SVI or HMC posterior over an architecture)."""

    config: BNNConfig
    arch: Architecture
    device: torch.device
    n_inputs: Optional[int] = None
    # Exactly one of these is set after training or loading:
    posterior: Optional[MeanFieldPosterior] = None  # SVI
    samples: Optional[Params] = None  # HMC: stacked (S, ...) parameter tree
    # SVI: per-epoch loss, accuracy and seconds of the last train(); HMC: per
    # batch run, the mean accept probability, step size, seconds and
    # evaluations (NUTS: also the mean leaves per draw and the divergences)
    history: Optional[dict] = None
    hmc_info: Optional[Union[HMCInfo, NUTSInfo]] = None  # the last HMC or NUTS run's
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
        if config.inference not in ("svi", "hmc"):
            raise ValueError(f"unknown inference {config.inference!r}")
        arch = build_architecture(
            config.architecture, config.activation, input_shape, output_size,
            config.hidden_size, dataset_name=config.dataset,
        )
        return cls(config=config, arch=arch, device=resolve_device(device), n_inputs=n_inputs)

    @property
    def name(self) -> str:
        """Checkpoint identity string (reference ``model_bnn.py:90-103``)."""
        return self.config.name(self.n_inputs)

    @property
    def is_hmc(self) -> bool:
        return self.config.inference == "hmc"

    def train(
        self,
        x_train,
        y_train,
        *,
        batch_size: Optional[int] = None,
        seed: int = 0,
        hmc_mode: str = "faithful",
        hmc_init: str = "random",
        hmc_sampler: str = "hmc",
        num_chains: int = 1,
        train_acc_samples: int = 10,
        mesh=None,
        verbose: bool = True,
        init=None,
        draws=None,
    ) -> "BNN":
        """Train on ``self.device`` with the configured engine (reference
        ``model_bnn.py:350-365``). SVI ignores the HMC flags, as the JAX
        package's ``train`` does.

        SVI: ``svi_train``; the posterior comes back with detached leaves, so
        attacks on it launch no parameter-gradient kernel. ``init`` and
        ``draws`` go to ``svi_train``.

        HMC: :func:`.inference.hmc.hmc_train_batched` on the potential
        :func:`bnn_potential` over the reference's sequential batches (the
        ragged tail included), from ``arch.init`` seeded with ``seed``, or
        ``init`` (a parameter tree or flat vector), or the MAP point from there
        (``hmc_init='map'``); chains merge into one sample axis. ``draws``
        replaces the sampler's generator. ``hmc_sampler='nuts'`` samples by
        NUTS instead (``num_steps`` unused); the draws are saved under the
        same leaf names.

        ``mesh`` (or a process default) runs the engine data-parallel: SVI
        through ``svi_train(mesh=)``; HMC and NUTS with each batch's rows
        split over ``data``, U and ∇U summed over ``data`` at every evaluation
        (the prior added on index 0 only), so every rank takes the same
        decisions and returns the same draws, bit-equal to the unmeshed run at
        one rank.
        """
        mesh = resolve_mesh(mesh)
        if mesh is not None:
            mesh.check(self.device)
        self._fn_cache.clear()  # cached closures hold the previous state
        batch_size = batch_size or bnn_batch_size(self.config)
        if not self.is_hmc:
            self.posterior, self.history = svi_train(
                self.arch,
                x_train,
                y_train,
                epochs=self.config.epochs,
                lr=self.config.lr,
                batch_size=batch_size,
                seed=seed,
                train_acc_samples=train_acc_samples,
                mesh=mesh,
                verbose=verbose,
                device=self.device,
                init=init,
                draws=draws,
            )
            return self

        check_sampler(hmc_sampler)
        template = self.arch.init(torch.Generator(device=self.device).manual_seed(int(seed)))
        flat0, unravel = flatten_tree_to_vector(template)
        if init is not None:
            flat0 = init if torch.is_tensor(init) else flatten_tree_to_vector(init)[0]
            flat0 = flat0.to(self.device, torch.float32)
        if mesh is not None:
            flat0 = replicate(flat0, mesh)
        x = torch.as_tensor(x_train, device=self.device)
        labels = torch.as_tensor(y_train, device=self.device).argmax(-1)
        if hmc_init == "map":
            # Opt-in: the reference starts from the module's random init. Every
            # rank descends the same full-data potential.
            flat0, _ = map_warm_start(bnn_potential(self.arch, unravel), flat0, data=(x, labels))
        elif hmc_init != "random":
            raise ValueError(f"unknown hmc_init {hmc_init!r}")

        # Reference batching: sequential batches of `batch_size`, the ragged
        # tail included (model_bnn.py:274-277).
        batches = [(x[i : i + batch_size], labels[i : i + batch_size]) for i in range(0, x.shape[0], batch_size)]
        potential_fn = bnn_potential(self.arch, unravel)
        if mesh is not None:  # this rank's rows of each batch; the prior on data index 0
            batches = [(bx[split_rows(len(bx), mesh)], bl[split_rows(len(bx), mesh)]) for bx, bl in batches]
            potential_fn = bnn_potential(self.arch, unravel, prior=mesh.index("data") == 0)
        self.history = {}
        flat_samples, self.hmc_info = hmc_train_batched(
            potential_fn,
            batches,
            flat0,
            seed,
            n_samples=self.config.n_samples,
            warmup=self.config.warmup,
            step_size=self.config.step_size,
            num_steps=self.config.num_steps,
            mode=hmc_mode,
            num_chains=num_chains,
            sampler=hmc_sampler,
            verbose=verbose,
            draws=draws,
            history=self.history,
            mesh=mesh,
        )
        self.samples = map_params(torch.Tensor.contiguous, unravel(flat_samples.reshape(-1, flat0.shape[-1])))
        return self

    # ------------------------------------------------------------------ #
    # posterior predictive (reference model_bnn.py:198-258)
    # ------------------------------------------------------------------ #

    def _require_posterior(self) -> MeanFieldPosterior:
        if self.posterior is None:
            raise ValueError("load() the BNN first")
        return self.posterior

    def _require_samples(self) -> Params:
        if self.samples is None:
            raise ValueError("train() or load() the BNN first")
        return self.samples

    def _hmc_seeds(self, n_samples: int, seeds: Optional[Sequence[int]]) -> list:
        """``seeds``, by default ``range(n_samples)`` (reference ``model_bnn.py:248-249``)."""
        if seeds is None:
            return list(range(n_samples))
        seeds = list(seeds)
        if len(seeds) != n_samples:
            raise ValueError("Number of seeds should match number of samples.")
        return seeds

    def sample_draws(self, seeds: Sequence[int]) -> Params:
        """The HMC draws ``seeds`` of the stacked posterior, checked on the host."""
        from robustbnns_tpu_torch.predict import hmc_sample_index

        samples = self._require_samples()
        return index_tree(samples, hmc_sample_index(samples, seeds, self.device))

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

        ``n_samples=None`` means the reference's default of 10. SVI draws are
        seeded by ``seeds`` or fresh from the CPU ``generator``. HMC indexes
        its draws by ``seeds``, by default ``range(n_samples)``, and ignores
        ``avg_posterior`` and ``generator``, as the reference's HMC branch
        does (``model_bnn.py:243-255``).
        """
        from robustbnns_tpu_torch.predict import (
            hmc_predict,
            hmc_sample_index,
            sample_eps,
            svi_avg_posterior_predict,
            svi_predict,
        )

        n_samples = n_samples or 10
        if self.is_hmc:
            samples = self._require_samples()
            idx = hmc_sample_index(samples, self._hmc_seeds(n_samples, seeds), self.device)
            return hmc_predict(self.arch, samples, x, idx)
        posterior = self._require_posterior()
        if avg_posterior:
            return svi_avg_posterior_predict(self.arch, posterior, x)
        eps = sample_eps(posterior.loc, n_samples, generator=generator, seeds=seeds, device=self.device)
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
        an SVI closure draws fresh weights from the generator on every call,
        as the reference does at attack time (``adversarialAttacks.py:97``);
        an HMC closure takes the draws ``range(n_samples)``, indexed once.
        ``fused=True`` (SVI fresh-draw mode, fc/fc2) routes through the CUDA
        sampled-dense kernels; ``conv``, ``conv2``, ``resnet20`` and ``cct7``
        have no fused path and raise, as in the JAX package, and HMC refuses it.
        """
        from robustbnns_tpu_torch.inference.svi import sample_meanfield_eps
        from robustbnns_tpu_torch.predict import sample_eps, svi_predict

        n_samples = n_samples or 10
        if self.is_hmc:
            if fused:
                raise ValueError("fused predictive supports SVI fresh-draw mode only")
            seeds = self._hmc_seeds(n_samples, seeds)
            avg_posterior = False  # ignored for HMC, as in the reference
        posterior = None if self.is_hmc else self._require_posterior()
        if fused:
            if avg_posterior or seeds is not None:
                raise ValueError("fused predictive supports SVI fresh-draw mode only")
            from robustbnns_tpu_torch.ops.fused_predict import fused_predictive_fn, supports_fused

            if not supports_fused(self.arch):
                raise NotImplementedError(
                    f"fused predictive supports fc/fc2 architectures, not {self.arch.name} "
                    "(conv, conv2, resnet20 and cct7 have no fused path)")
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
            weights = (
                self.sample_draws(seeds) if self.is_hmc
                else sample_meanfield_eps(posterior, sample_eps(posterior.loc, n_samples, seeds=seeds,
                                                                device=self.device))
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
        """Write the posterior under the JAX package's leaf names: ``loc/0/b``,
        ... for SVI, the stacked draws ``0/b``, ``0/w``, ... for HMC."""
        state = self.samples if self.is_hmc else self.posterior
        if state is None:
            raise ValueError("nothing to save — train() first")
        path = save_pytree(
            state,
            self._ckpt_path(rel_path, filename),
            meta={"name": self.name, "inference": self.config.inference},
        )
        print(f"\nSaving {path}")
        return path

    def load(self, rel_path: str = TESTS, filename: Optional[str] = None) -> "BNN":
        """Read a posterior saved by either package; HMC expects
        ``config.n_samples`` stacked draws."""
        self._fn_cache.clear()  # cached closures hold the previous state
        path = self._ckpt_path(rel_path, filename)
        template = self.arch.init(torch.Generator().manual_seed(0))
        if self.is_hmc:
            stacked = map_params(lambda v: v.expand((self.config.n_samples,) + tuple(v.shape)), template)
            self.samples = load_pytree(stacked, path, device=self.device)
        else:
            self.posterior = load_pytree(MeanFieldPosterior(loc=template, rho=template), path, device=self.device)
        print(f"\nLoading {path}")
        return self
