"""A run with the timed path broken underneath comes out not correct, once for
each fault a cell can have; a sound run comes out correct. The runs skip the
harness's look for a card and drive the rest at a CPU's size. (No cell here
spans chips, so none can leave the exchange between chips out.)"""
from __future__ import annotations

import itertools

import pytest
import torch
from conftest import run_tiny, tiny_spec


def test_a_sound_run_is_correct(workload):
    result = run_tiny(tiny_spec(workload))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"


def _pgd_faults(monkeypatch, fault):
    from robustbnns_tpu_torch.attacks import gradient_attacks as ga

    if fault == "unchanged":  # the step returns its state unchanged
        monkeypatch.setattr(ga, "_gradient_sign", lambda g: torch.zeros_like(g))
    elif fault == "half_batch":  # half of the batch left out, the rest's loss doubled
        ce = ga.ce_on_outputs

        def half(out, labels):
            h = out.shape[0] // 2
            return torch.cat([2.0 * ce(out[:h], labels[:h]), 0.0 * ce(out[h:], labels[h:])])

        monkeypatch.setattr(ga, "ce_on_outputs", half)
    else:  # an answer altered where it is produced
        pgd = ga.pgd_attack

        def altered(*args, **kwargs):
            x = pgd(*args, **kwargs).clone()
            x[0, 14, 14, 0] = 1.0 - x[0, 14, 14, 0]
            return x

        monkeypatch.setattr(ga, "pgd_attack", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ["model_7.pgd.s100", "model_0.pgd.s100"])
def test_a_broken_attack_is_not_correct(monkeypatch, cell, fault):
    _pgd_faults(monkeypatch, fault)
    result = run_tiny(tiny_spec(cell))
    assert not result["correct"], result["checks"]


def _svi_faults(monkeypatch, fault, per_epoch):
    from robustbnns_tpu_torch.inference import svi

    if fault in ("unchanged", "ascent"):
        step = svi.elbo_step

        def broken(apply_fn, optimizer, posterior, eps, x, labels, mask=None, mesh=None):
            if fault == "unchanged":  # the step returns its state unchanged
                optimizer.zero_grad(set_to_none=True)
                loss = svi.elbo_loss(apply_fn, posterior, eps, x, labels, mask)
                loss.backward()
                return loss.detach()
            params = [p for group in optimizer.param_groups for p in group["params"]]
            before = [p.detach().clone() for p in params]
            loss = step(apply_fn, optimizer, posterior, eps, x, labels, mask, mesh)
            with torch.no_grad():  # the optimizer's update taken the other way
                for p, b in zip(params, before):
                    p.copy_(2 * b - p)
            return loss

        monkeypatch.setattr(svi, "elbo_step", broken)
        return
    loglik = svi.categorical_loglik_sum
    if fault == "half_batch":  # half of the batch left out, the rest's sum doubled
        def half(logits, labels, mask=None):
            h = logits.shape[0] // 2
            return 2.0 * loglik(logits[:h], labels[:h], None if mask is None else mask[:h])

        monkeypatch.setattr(svi, "categorical_loglik_sum", half)
    elif fault == "last_batch_dropped":  # the rows of an epoch's last, partial batch left out
        def dropped(logits, labels, mask=None):
            if mask is not None and bool((mask == 0).any()):
                mask = torch.zeros_like(mask)
            return loglik(logits, labels, mask)

        monkeypatch.setattr(svi, "categorical_loglik_sum", dropped)
    else:  # an answer altered where it is produced: one row's label, from the first step or the window's
        calls = itertools.count()
        first = 0 if fault == "label" else per_epoch

        def altered(logits, labels, mask=None):
            if next(calls) >= first:
                labels = labels.clone()
                labels[0] = (labels[0] + 1) % logits.shape[-1]
            return loglik(logits, labels, mask)

        monkeypatch.setattr(svi, "categorical_loglik_sum", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "label", "ascent", "last_batch_dropped",
                                   "window_label"])
def test_a_broken_training_step_is_not_correct(monkeypatch, fault):
    spec = tiny_spec("model_7.svi.b128")
    t = spec["traffic"]
    _svi_faults(monkeypatch, fault, -(-t["train_images"] // t["batch_size"]))
    result = run_tiny(spec)
    assert not result["correct"], result["checks"]
