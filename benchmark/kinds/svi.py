"""SVI training through the program's epoch loop.

Set-up: the reference's N(0, 1) mean-field init at the configuration's
widths, Adam as ``svi_train`` builds it (b1 0.9, b2 0.999, eps 1e-8, the
configuration's lr) over the leaves ``loc`` then ``rho``, ``train_images``
images and one-hot labels, and one generator on the device for the
trainer's draws. Set-up then runs the first epoch, and the window whole
epochs after it, each one call of ``inference.svi.svi_epoch`` over all the
images with its ``svi.generator_draws`` from that generator, as
``svi_train`` runs them, reading each epoch's loss once: one posterior and
one Adam from the seed on, every shape warmed up by the first epoch.

What the steps produce is recorded where it is produced: the trainer's
``elbo_step`` is wrapped (:class:`StepRecorder`), which keeps the loss, the
gradients Adam reads, and the leaves and Adam's moments around the first
``check.steps`` steps and around the last step of every epoch (the one the
check keeps is the window's last). After the window the reference
(:mod:`benchmark.reference.svi`) repeats the first steps from the seed, with
the rows and draws of its own copy of the trainer's order, and works out
each later recorded step, the kept last one with its padded and masked
rows too, from the program's leaves and moments before it.
"""
from __future__ import annotations

import importlib
import math
import time

import torch

from benchmark import inputs
from benchmark.kinds import sync
from benchmark.reference import compare
from benchmark.reference import svi as ref_svi
from benchmark.reference.precision import PRECISIONS

CHECKS = ("loss_gap", "later_loss_gap", "grad1_gap", "change_gap", "adam_step_gap", "last_loss_gap",
          "last_grad_gap")
FAULTS = ("unchanged", "half_batch", "label", "ascent")


class StepRecorder:
    """Stands in for the trainer's ``elbo_step`` while a cell runs: calls it
    unchanged, and around the watched steps (counted from 0 over the cell's
    life) keeps the program's loss, gradients, leaves and Adam's moments."""

    def __init__(self, module, params: list, optimizer, first: int, per_epoch: int):
        self.module, self.step_fn = module, module.elbo_step
        self.params, self.optimizer = params, optimizer
        self.first, self.per_epoch = first, per_epoch
        self.calls, self.on, self.records, self.last = 0, True, [], None
        module.elbo_step = self

    def restore(self) -> None:
        if self.module.elbo_step is self:
            self.module.elbo_step = self.step_fn

    def _moment(self, key: str) -> list:
        """Adam's moment ``key`` of every leaf, zeros before the leaf's first step."""
        state = [self.optimizer.state.get(p, {}) for p in self.params]
        return [s[key].clone() if key in s else torch.zeros_like(p) for s, p in zip(state, self.params)]

    def __call__(self, *args, **kwargs):
        t, self.calls = self.calls, self.calls + 1
        watched = self.on and (t < self.first or t % self.per_epoch == self.per_epoch - 1)
        if not watched:
            return self.step_fn(*args, **kwargs)
        m, v = self._moment("exp_avg"), self._moment("exp_avg_sq")
        before = [p.detach().clone() for p in self.params]
        loss = self.step_fn(*args, **kwargs)
        record = {"step": t + 1, "loss": loss.detach().clone(), "before": before, "m": m, "v": v,
                  "grad": [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone() for p in self.params],
                  "after": [p.detach().clone() for p in self.params], "m_after": self._moment("exp_avg")}
        if t < self.first:
            self.records.append(record)
        if t % self.per_epoch == self.per_epoch - 1:
            self.last = record
        return loss


class Cell:
    def __init__(self, spec: dict, seed: int, device):
        from robustbnns_tpu_torch.inference import svi
        from robustbnns_tpu_torch.models.architectures import build_architecture
        from robustbnns_tpu_torch.utils.pytree import tree_leaves

        self.config, self.traffic, self.device = spec["config"], spec["traffic"], device
        c, t = self.config, self.traffic
        self.svi = svi
        self.apply = build_architecture(c["architecture"], c["activation"], tuple(c["input_shape"]),
                                        c["output_size"], c["hidden_size"], dataset_name=c["dataset"]).apply
        self.loc, self.rho = inputs.normal_posterior(c, inputs.generator(device, seed, "init"))
        self.posterior = svi.MeanFieldPosterior(*(tuple({k: v.clone().requires_grad_(True) for k, v in layer.items()}
                                                        for layer in tree) for tree in (self.loc, self.rho)))
        params = tree_leaves(self.posterior.loc) + tree_leaves(self.posterior.rho)
        self.optimizer = torch.optim.Adam(params, lr=c["lr"], betas=(0.9, 0.999), eps=1e-8)
        data = inputs.generator(device, seed, "images")
        n = t["train_images"]
        self.x = inputs.images(c, data, (n,))
        self.y = torch.nn.functional.one_hot(inputs.labels(c, data, (n,)), c["output_size"]).float()
        self.draw_seed = inputs.sub_seed(seed, "train")
        self.generator = torch.Generator(device=device).manual_seed(self.draw_seed)
        self.per_epoch = -(-n // t["batch_size"])
        self.recorder = StepRecorder(svi, params, self.optimizer, t["check"]["steps"], self.per_epoch)
        self._draws = {}
        float(self._epoch(self.x.shape[0])[0])
        sync(device)

    def _epoch(self, n: int):
        """One call of the trainer's epoch on the first ``n`` rows."""
        t = self.traffic
        draws = self.svi.generator_draws(self.generator, self.posterior.loc, n, -(-n // t["batch_size"]),
                                         t["accuracy_samples"])
        return self.svi.svi_epoch(self.apply, self.optimizer, t["batch_size"], t["accuracy_samples"], self.posterior,
                                  self.x[:n], self.y[:n], draws)

    def window(self, seconds: float) -> dict:
        """Whole epochs until the first that ends after ``seconds``."""
        t = self.traffic
        epochs, start = 0, time.perf_counter()
        self.window_start = time.time()
        while True:
            loss, _ = self._epoch(t["train_images"])
            float(loss)  # the epoch's one synchronisation, as svi_train reads it
            epochs += 1
            elapsed = time.perf_counter() - start
            if elapsed >= seconds:
                break
        images = epochs * t["train_images"]
        return {"seconds": elapsed, "units": images, "attempted": images, "failed": 0,
                "steps": epochs * self.per_epoch}

    def stretch(self) -> int:
        """``trace.steps`` steps for the profiler, as one epoch call on that many
        batches of rows, unrecorded. Returns the steps run."""
        steps = self.traffic["trace"]["steps"]
        self.recorder.on = False
        float(self._epoch(steps * self.traffic["batch_size"])[0])
        return steps

    def release(self) -> None:
        self.recorder.restore()
        self.recorder.params = self.recorder.optimizer = None
        self.posterior = self.optimizer = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def _arch(self):
        return importlib.import_module(f"benchmark.reference.arch_{self.config['architecture']}")

    def _first_steps(self, prec_name: str, fault=None) -> list:
        c, t = self.config, self.traffic
        return ref_svi.first_steps(self._arch(), c["activation"], self.loc, self.rho, self.x, self.y,
                                   t["batch_size"], self.draw_seed, c["lr"], t["accuracy_samples"],
                                   t["check"]["steps"], PRECISIONS[prec_name], fault)

    def _from_state(self, record: dict, prec_name: str, fault=None) -> dict:
        """A recorded step worked out again from the program's leaves and
        moments before it, with the rows and draws of its place in the
        trainer's order."""
        c, t = self.config, self.traffic
        if record["step"] not in self._draws:
            epoch, step = divmod(record["step"] - 1, self.per_epoch)
            self._draws[record["step"]] = ref_svi.step_draws(self.draw_seed, self.loc, t["train_images"],
                                                             t["batch_size"], t["accuracy_samples"], epoch, step)
        rows, eps = self._draws[record["step"]]
        return ref_svi.one_step(self._arch(), c["activation"], record["before"], record["m"], record["v"],
                                record["step"], self.loc, eps, self.x[rows], self.y[rows].argmax(-1), c["lr"],
                                PRECISIONS[prec_name], fault)

    def check(self, candidate: str = "program") -> dict:
        """From the seed, against the reference's first steps: ``loss_gap``,
        the first step's loss; ``grad1_gap`` and ``change_gap``, the median
        leaf's gap of the first gradient's norm (as Adam holds it after one
        step: ``exp_avg / (1 - b1)``) and of the first step's change's norm,
        the change among the leaves the reference's gradient moves.

        From the program's state before each later recorded step, against
        the reference's step from there: ``later_loss_gap``, the worst of the
        other first steps' losses; ``last_loss_gap`` and ``last_grad_gap``,
        the kept last step's loss and the median leaf's gradient norm. A leaky
        unit within rounding of its kink, or an entry whose gradient cancels
        to rounding (Adam moves it by about ``lr`` either way), moves a few
        leaves and every later loss of a run followed from the seed: the
        median leaf, and each step taken from the program's own state, read
        the arithmetic.

        ``adam_step_gap``: over every recorded step, the worst leaf's
        ``||after - want|| / ||want - before||`` (floored at the median
        leaf's), where ``want`` is Adam's update in float64 from the step's
        own leaves, moments and gradients.

        ``candidate`` ``program`` judges the recorded steps; ``tf32`` the
        reference in TF32 in the program's place (the control); a name of
        :data:`FAULTS` the reference in float32 with that fault."""
        recorder = self.recorder
        if len(recorder.records) < self.traffic["check"]["steps"] or recorder.last is None:
            return {name: math.inf for name in CHECKS}
        later = recorder.records[1:] + [recorder.last]
        ref_first, ref_later = self._first_steps("float64"), [self._from_state(r, "float64") for r in later]
        if candidate == "program":
            first = [dict(r, loss=float(r["loss"])) for r in recorder.records]
            got_later = [dict(r, loss=float(r["loss"])) for r in later]
        else:
            prec, fault = ("tf32", None) if candidate == "tf32" else ("float32", candidate)
            first, got_later = self._first_steps(prec, fault), [self._from_state(r, prec, fault) for r in later]
        moved = compare.moved_leaves(ref_first[0]["grad"])
        start = ref_svi.leaves(self.loc, self.rho)
        grad1 = compare.norm_gaps(*([m / (1 - ref_svi.BETA1) for m in r["m_after"]] for r in (first[0], ref_first[0])))
        change = compare.norm_gaps([a - s for a, s in zip(first[0]["after"], start)],
                                   [a - s for a, s in zip(ref_first[0]["after"], start)])
        losses = [compare.relative_gap(a["loss"], r["loss"]) for a, r in zip(got_later, ref_later)]
        return {
            "loss_gap": compare.relative_gap(first[0]["loss"], ref_first[0]["loss"]),
            "later_loss_gap": max(losses[:-1], default=0.0),
            "grad1_gap": _median(grad1),
            "change_gap": _median([gap for gap, m in zip(change, moved) if m]),
            "adam_step_gap": max(_adam_gap(r, self.config["lr"]) for r in first[:1] + got_later),
            "last_loss_gap": losses[-1],
            "last_grad_gap": _median(compare.norm_gaps(got_later[-1]["grad"], ref_later[-1]["grad"])),
        }


def _median(values: list) -> float:
    return float(torch.tensor(values, dtype=torch.float64).median())


def _adam_gap(record: dict, lr: float) -> float:
    """How far a step's leaves after it lie from Adam's update of its own
    leaves, moments and gradients, in float64 (:func:`compare.step_gaps`)."""
    f64 = [[t.double() for t in record[k]] for k in ("before", "grad", "m", "v")]
    want, _, _ = ref_svi.adam(*f64, record["step"], lr)
    return max(compare.step_gaps(record["after"], want, f64[0]))
