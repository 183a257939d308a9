"""The port's spans and counters (``utils/timing.py``) on the CPU: spans off
call nothing of the profiler; on, they land in the profiler's event list,
nested layer in layer, one request number a batch or a step; the counters
count batches, iterations, steps and kernel launches; results are
bit-identical with spans on and off. No timing is asserted."""
from __future__ import annotations

import importlib
import json
import os

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from robustbnns_tpu_torch.attacks import attack
from robustbnns_tpu_torch.config import BNNConfig
from robustbnns_tpu_torch.inference import svi
from robustbnns_tpu_torch.models.architectures import build_architecture
from robustbnns_tpu_torch.models.bnn import BNN
from robustbnns_tpu_torch.utils import timing
from robustbnns_tpu_torch.utils.pytree import tree_leaves

sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")

SHAPE = (28, 28, 1)
PGD_SPANS = ("attack.batch", "attack.iteration", "predictive.forward", "predictive.backward")
SVI_SPANS = ("svi.step", "svi.draws", "svi.elbo.forward", "svi.elbo.backward", "svi.accuracy")
ADAM = ("Optimizer.zero_grad#Adam.zero_grad", "Optimizer.step#Adam.step")


def tiny_bnn(architecture: str) -> BNN:
    """A BNN of hidden size 16 with a posterior drawn from a fixed seed."""
    bnn = BNN.from_config(BNNConfig("mnist", 16, "leaky", architecture, "svi", epochs=1, lr=0.01), SHAPE, 10,
                          device="cpu")
    bnn.posterior = svi.svi_init(bnn.arch, torch.Generator().manual_seed(3))
    return bnn


def images(n: int, seed: int = 5):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n,) + SHAPE, generator=g), torch.randint(0, 10, (n,), generator=g)


def run_pgd(bnn, n=6, batch_size=4, method="pgd"):
    """``attack`` on ``n`` images in batches of ``batch_size``: 2 batches at the defaults."""
    x, y = images(n)
    return attack(bnn, x, y, method=method, n_samples=2, batch_size=batch_size, save=False, verbose=False,
                  generator=torch.Generator().manual_seed(7))


def run_svi(steps=3):
    """One SVI epoch of ``steps`` batches of 4 (the last masked) on fc2-16;
    returns the loss, the correct count, the leaves and Adam's moments."""
    arch = build_architecture("fc2", "leaky", SHAPE, 10, 16)
    init = svi.svi_init(arch, torch.Generator().manual_seed(11))
    post = svi.MeanFieldPosterior(*(tuple({k: v.clone().requires_grad_(True) for k, v in layer.items()}
                                          for layer in tree) for tree in init))
    leaves = tree_leaves(post.loc) + tree_leaves(post.rho)
    opt = torch.optim.Adam(leaves, lr=0.02, betas=(0.9, 0.999), eps=1e-8)
    x, y = images(4 * steps - 1, seed=13)
    y = torch.nn.functional.one_hot(y, 10).float()
    gen = torch.Generator().manual_seed(17)
    draws = svi.generator_draws(gen, post.loc, x.shape[0], steps, 2)
    loss, correct = svi.svi_epoch(arch.apply, opt, 4, 2, post, x, y, draws)
    moments = [opt.state[p][k] for p in leaves for k in ("exp_avg", "exp_avg_sq")]
    return [loss, correct] + [p.detach() for p in leaves] + moments


def traced(fn):
    """``fn()`` with spans on under the CPU profiler (shapes recorded, which
    keeps the request numbers); returns its result, the program's spans as
    ``(name, start, end, request)`` and the counters' deltas."""
    before = timing.counters()
    with timing.spans_on(), profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    after = timing.counters()
    names = set(PGD_SPANS + SVI_SPANS + ADAM + ("conv_trunk",))
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), (e.concrete_inputs() or [None])[0])
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CPU and e.name() in names]
    return out, spans, {k: v - before.get(k, 0) for k, v in after.items()}


def within(child, parents) -> bool:
    return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)


def of(spans, name):
    return [s for s in spans if s[0] == name]


def test_spans_off_call_nothing_of_the_profiler(monkeypatch):
    """With spans off, a PGD of a tiny fc2 and a 3-step SVI epoch enter no
    profiler range: the entries a span would call raise."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span entered a profiler range while spans were off")

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert run_pgd(tiny_bnn("fc2")).shape == (6,) + SHAPE
    assert torch.isfinite(run_svi()[0])
    with pytest.raises(AssertionError), timing.spans_on(), timing.span("attack.batch"):
        pass


def test_span_is_one_shared_no_op_while_off():
    off = timing.span("attack.batch", 3)
    assert off is timing.span("svi.step") and off.__enter__() is None and off.__exit__(None, None, None) is False
    with timing.spans_on():
        with timing.spans_on():
            assert timing.span("svi.step") is not off
        assert timing.span("svi.step") is not off
    assert timing.span("svi.step") is off


def test_pgd_spans_nest_and_carry_the_batch():
    """``attack.batch`` ⊃ ``attack.iteration`` ⊃ ``predictive.forward`` and
    ``.backward``; every span of a batch carries the batch's number."""
    _, spans, delta = traced(lambda: run_pgd(tiny_bnn("fc2")))
    batches, iterations = of(spans, "attack.batch"), of(spans, "attack.iteration")
    assert len(batches) == 2 and len(iterations) == 80
    assert all(within(s, batches) for s in iterations)
    for name in ("predictive.forward", "predictive.backward"):
        assert len(of(spans, name)) == 80 and all(within(s, iterations) for s in of(spans, name))
    assert not of(spans, "conv_trunk")
    for batch in batches:
        inner = [s for s in spans if s is not batch and within(s, [batch])]
        assert len(inner) == 40 * 3 and {s[3] for s in inner} == {batch[3]}
    assert len({b[3] for b in batches}) == 2
    assert delta["attack.batches"] == 2 and delta["attack.iterations"] == 2 * 40


def test_fgsm_has_one_iteration_a_batch():
    _, spans, delta = traced(lambda: run_pgd(tiny_bnn("fc2"), method="fgsm"))
    assert len(of(spans, "attack.batch")) == len(of(spans, "attack.iteration")) == 2
    assert delta["attack.batches"] == delta["attack.iterations"] == 2


def test_conv_trunk_nests_in_the_predictive_forward():
    _, spans, delta = traced(lambda: run_pgd(tiny_bnn("conv"), n=4))
    forward, trunk = of(spans, "predictive.forward"), of(spans, "conv_trunk")
    assert len(forward) == len(trunk) == 40 == delta["attack.iterations"]
    assert all(within(s, forward) for s in trunk)
    assert not any(within(s, of(spans, "predictive.backward")) for s in trunk)


def test_svi_spans_nest_and_carry_the_step():
    """``svi.step`` ⊃ draws, ELBO forward and backward, Adam's ranges and the
    accuracy, in that order; one request number a step, the counter's."""
    _, spans, delta = traced(run_svi)
    steps = of(spans, "svi.step")
    assert len(steps) == 3 and delta["svi.steps"] == 3
    assert len({s[3] for s in steps}) == 3
    for step in steps:
        inner = sorted((s for s in spans if s is not step and within(s, [step])), key=lambda s: s[1])
        assert [s[0] for s in inner] == ["svi.draws", ADAM[0], "svi.elbo.forward", "svi.elbo.backward", ADAM[1],
                                         "svi.accuracy"]
        assert {s[3] for s in inner if s[0].startswith("svi.")} == {step[3]}


def test_results_are_bit_identical_with_spans_on_and_off():
    """PGD's adversarial images; SVI's loss, correct count, leaves and Adam's moments."""
    off = run_pgd(tiny_bnn("conv"), n=4), run_svi()
    on, _, _ = traced(lambda: (run_pgd(tiny_bnn("conv"), n=4), run_svi()))
    assert torch.equal(off[0], on[0])
    assert len(off[1]) == len(on[1]) and all(torch.equal(a, b) for a, b in zip(off[1], on[1]))


def test_launch_counts_read_the_counters():
    """``launch_counts`` keeps its keys, one a kernel wrapper, and reads the
    ``sampled_dense.<wrapper>`` counters; the reset zeroes those alone."""
    names = [w.__name__ for w in sd.KERNEL_WRAPPERS]
    sd.reset_launch_counts()
    assert sd.launch_counts() == dict.fromkeys(names, 0) and len(names) == 12
    timing.count("sampled_dense.sampled_dense_xs_dx", 3)
    iterations = timing.count("attack.iterations")
    assert sd.launch_counts() == dict(dict.fromkeys(names, 0), sampled_dense_xs_dx=3)
    sd.reset_launch_counts()
    assert not any(sd.launch_counts().values()) and timing.counters()["attack.iterations"] == iterations


def test_maybe_profile_records_the_programs_spans(tmp_path):
    with timing.maybe_profile(str(tmp_path)):
        run_pgd(tiny_bnn("fc2"), n=2)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"attack.batch", "attack.iteration", "predictive.forward", "predictive.backward"} <= names
    assert timing.span("attack.batch") is timing.span("svi.step")  # spans off again after the block
