"""Bayesian PGD through the program's attack entry.

Set-up: the BNN at the configuration's widths with a seeded posterior, a
pool of ``pool_batches`` batches of images and labels, and a short PGD of
``warmup_iterations`` through the same predictive. The window calls
``attacks.gradient_attacks.attack`` (``method="pgd"``, the CLI's epsilon and
alpha, ``n_samples`` fresh draws at every iteration, the configuration's
``fused`` path) on one batch at a time, the pool cycled, one CPU generator
threaded through every batch as the CLI threads it, and waits for each.

What the window produces is recorded where it is produced: the program's
predictive closure is wrapped (:class:`RecordingModel`), and at the
``check.iterations`` iterations drawn from the seed (the last always among
them) it keeps the generator's state, the iterate, the probabilities, the
input gradient (a hook on the iterate) and the next iterate. Of the window's
batches, ``check.batches`` drawn from the seed are kept (reservoir sampling).
After the window the reference works each kept iteration out again from
the program's iterate (:mod:`benchmark.reference.pgd`), and the step from
the program's iterate and gradient: the check follows the attack step by
step from the program's own state, and checks its start apart.
"""
from __future__ import annotations

import importlib
import math
import random
import time

import torch

from benchmark import inputs
from benchmark.kinds import sync
from benchmark.reference import compare, draws
from benchmark.reference import pgd as ref_pgd
from benchmark.reference.precision import PRECISIONS

CHECKS = ("start_gap", "probs_gap", "grad_gap", "step_mismatch")


class RecordingModel:
    """Stands in for the BNN in ``attack``: hands out the BNN's predictive
    closures, wrapped so that the watched calls of a batch are recorded."""

    def __init__(self, bnn):
        self.bnn, self.device = bnn, bnn.device
        self.watched, self.calls, self.records, self.first = frozenset(), 0, {}, None
        self._fns = {}

    def watch(self, iterations) -> None:
        """Record these calls of the next batch (counted from 0)."""
        self.watched, self.calls, self.records, self.first = frozenset(iterations), 0, {}, None

    def predictive_fn(self, n_samples=None, **kwargs):
        key = (n_samples, tuple(sorted(kwargs.items())))
        if key not in self._fns:
            self._fns[key] = self._wrap(self.bnn.predictive_fn(n_samples, **kwargs))
        return self._fns[key]

    def _wrap(self, fn):
        def forward(x, generator=None):
            t, self.calls = self.calls, self.calls + 1
            if t == 0:
                self.first = x.detach().clone()
            if t - 1 in self.watched:
                self.records[t - 1]["x_next"] = x.detach().clone()
            if t not in self.watched:
                return fn(x, generator)
            rec = self.records[t] = {"gen_state": generator.get_state(), "x": x.detach().clone()}
            if x.requires_grad:
                x.register_hook(lambda g: rec.__setitem__("grad", g.detach().clone()))
            out = fn(x, generator)
            rec["probs"] = out.detach().clone()
            return out

        return forward


class Cell:
    def __init__(self, spec: dict, seed: int, device):
        from robustbnns_tpu_torch.attacks import gradient_attacks
        from robustbnns_tpu_torch.config import BNNConfig
        from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior
        from robustbnns_tpu_torch.models.bnn import BNN

        self.config, self.traffic, self.device = spec["config"], spec["traffic"], device
        c, t = self.config, self.traffic
        self.gradient_attacks = gradient_attacks
        bnn_config = BNNConfig(c["dataset"], c["hidden_size"], c["activation"], c["architecture"], c["inference"],
                               epochs=c["epochs"], lr=c["lr"])
        bnn = BNN.from_config(bnn_config, tuple(c["input_shape"]), c["output_size"], device=device)
        self.loc, self.rho = inputs.seeded_posterior(c, inputs.generator(device, seed, "posterior"))
        bnn.posterior = MeanFieldPosterior(loc=tuple(self.loc), rho=tuple(self.rho))
        data = inputs.generator(device, seed, "images")
        lead = (t["pool_batches"], t["batch_size"])
        self.x, self.y = inputs.images(c, data, lead), inputs.labels(c, data, lead)
        self.model = RecordingModel(bnn)
        rng = random.Random(inputs.sub_seed(seed, "check"))
        last = t["iterations"] - 1
        self.watched = {last, *rng.sample(range(last), t["check"]["iterations"] - 1)}
        self.sample_rng, self.kept, self.batches = rng, [], 0
        self.attack_generator = torch.Generator().manual_seed(inputs.sub_seed(seed, "attack"))
        self.kwargs = dict(method="pgd", epsilon=t["epsilon"], n_samples=t["n_samples"], fused=c["fused_attacks"],
                           batch_size=t["batch_size"], save=False, verbose=False)
        # every shape of the window: the predictive, its gradient and the step
        forward = self.model.predictive_fn(t["n_samples"], **({"fused": True} if c["fused_attacks"] else {}))
        gradient_attacks.pgd_attack(forward, self.x[0], self.y[0], epsilon=t["epsilon"],
                                    iters=t["warmup_iterations"], generator=torch.Generator().manual_seed(0))
        sync(device)

    def _batch(self, watched=()):
        b = self.batches % self.traffic["pool_batches"]
        self.model.watch(watched)
        x_adv = self.gradient_attacks.attack(self.model, self.x[b], self.y[b], generator=self.attack_generator,
                                             **self.kwargs)
        sync(self.device)
        return b, x_adv

    def window(self, seconds: float) -> dict:
        """Whole batches until the first that ends after ``seconds``."""
        t, done = self.traffic, 0
        start = time.perf_counter()
        self.window_start = time.time()
        while True:
            b, x_adv = self._batch(self.watched)
            elapsed = time.perf_counter() - start
            self._keep(b, x_adv)
            self.batches += 1
            done += 1
            if elapsed >= seconds:
                break
        images = done * t["batch_size"]
        return {"seconds": elapsed, "units": images, "attempted": images, "failed": 0,
                "iterations": done * t["iterations"]}

    def _keep(self, b: int, x_adv) -> None:
        """Reservoir sampling of ``check.batches`` of the window's batches."""
        records = self.model.records
        last = self.traffic["iterations"] - 1
        if last in records:
            records[last]["x_next"] = x_adv.detach()
        record = {"pool": b, "states": records, "calls": self.model.calls, "first": self.model.first}
        k = self.traffic["check"]["batches"]
        if len(self.kept) < k:
            self.kept.append(record)
        else:
            j = self.sample_rng.randrange(self.batches + 1)
            if j < k:
                self.kept[j] = record

    def stretch(self) -> int:
        """Whole batches for the profiler: at least ``trace.min_batches`` and
        ``trace.min_seconds``. Returns the PGD iterations run."""
        t, done, start = self.traffic, 0, time.perf_counter()
        while done < t["trace"]["min_batches"] or time.perf_counter() - start < t["trace"]["min_seconds"]:
            self._batch()
            self.batches += 1
            done += 1
        return done * t["iterations"]

    def release(self) -> None:
        self.model = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, state, labels, prec_name: str):
        c, t = self.config, self.traffic
        prec = PRECISIONS[prec_name]
        arch = importlib.import_module(f"benchmark.reference.arch_{c['architecture']}")
        weights = ref_pgd.sampled_weights(self.loc, self.rho, draws.draw_seed(state["gen_state"]), t["n_samples"],
                                          c["fused_attacks"], prec.dtype)
        return ref_pgd.predictive_and_gradient(arch, weights, state["x"], labels, c["activation"], prec)

    def check(self, candidate: str = "program") -> dict:
        """The numbers over the kept batches, each the worst of them.

        ``start_gap``: how far the attack's first iterate lies from the clean
        batch (PGD has no random start: 0). Over the kept iterations, against
        the float64 reference at the program's iterate: ``probs_gap``, the
        worst image's probability gap, and ``grad_gap``, the images' mean
        input-gradient gap (a leaky unit or a max-pool window within rounding
        of its kink moves one image's float32 gradient by up to ~1e-2 of its
        norm, so the worst image's gap reads the kinks, not the arithmetic).
        ``step_mismatch``: the share of pixels where the next iterate is not,
        bit for bit, the step (sign, projection, clamp) from the iterate and
        the gradient that produced it.

        ``candidate`` ``program`` judges what the window recorded; ``tf32``
        judges the reference in TF32 put in the program's place at the same
        iterates (the control)."""
        t = self.traffic
        gaps = {name: 0.0 for name in CHECKS}
        for record in self.kept:
            x0, labels = self.x[record["pool"]], self.y[record["pool"]]
            states = record["states"]
            complete = record["calls"] == t["iterations"] and len(states) == len(self.watched) and all(
                {"x", "probs", "grad", "x_next"} <= set(s) for s in states.values())
            if not complete or record["first"] is None:
                return {name: math.inf for name in CHECKS}
            gaps["start_gap"] = max(gaps["start_gap"], float((record["first"] - x0).abs().max()))
            for state in states.values():
                probs_ref, grad_ref = self._reference(state, labels, "float64")
                if candidate == "program":
                    probs, grad, x_next = state["probs"], state["grad"], state["x_next"]
                else:
                    probs, grad = self._reference(state, labels, candidate)
                    x_next = ref_pgd.pgd_step(state["x"], x0, grad, t["epsilon"])
                step = ref_pgd.pgd_step(state["x"], x0, grad, t["epsilon"])
                for name, value in (("probs_gap", compare.image_gap(probs, probs_ref)),
                                    ("grad_gap", compare.mean_image_gap(grad, grad_ref)),
                                    ("step_mismatch", compare.mismatch(x_next, step))):
                    gaps[name] = max(gaps[name], value)
        return gaps
