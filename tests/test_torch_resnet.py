"""The port's ``resnet20`` (He et al.'s CIFAR-10 ResNet-20, on stacked draws)
against the plain reference ``tests/resnet20_reference.py``, on the CPU at the
published widths (base width 16, 32×32×3 inputs), batches of at most 4 and
at most 3 draws, with seeded random weights.

Tolerances: 1e-5 of the largest entry, in f32 against the reference in f32
and in float64. The convs sum at most 576 products of weights of
O(1/sqrt(fan_in)) in another order than the reference's, and 19 of them
with 9 residual adds compound that rounding to about 1.2e-7 of the largest
logit (seed 1), where the weights and the image rounded to TF32 alone move
it by 3.7e-4 of it and to bf16 by 2.1e-3. The ELBO's loss sums 269,034 KL
terms, and is compared at 1e-6 of itself.
"""
from __future__ import annotations

import math

import pytest
import resnet20_reference as ref
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from robustbnns_tpu_torch.attacks import attack
from robustbnns_tpu_torch.attacks.gradient_attacks import ce_on_outputs
from robustbnns_tpu_torch.config import BNNConfig
from robustbnns_tpu_torch.inference import svi
from robustbnns_tpu_torch.models.architectures import _grouped_conv2d, _option_a, build_architecture
from robustbnns_tpu_torch.models.bnn import BNN
from robustbnns_tpu_torch.utils import timing
from robustbnns_tpu_torch.utils.device import bf16_scope
from robustbnns_tpu_torch.utils.pytree import map_params, tree_leaves

SHAPE, CLASSES, WIDTH = (32, 32, 3), 10, 16
CONFIG = BNNConfig("cifar", WIDTH, "relu", "resnet20", "svi", epochs=1, lr=0.01)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's convs: beside other test workers
    on the same cores, 8 OpenMP threads a process slowed a 40-iteration
    ResNet-20 PGD at S 3, batch 4 from 0.7 s to 262 s (one thread: 1.8 s)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def arch(activation: str = "relu"):
    return build_architecture("resnet20", activation, SHAPE, CLASSES, WIDTH, "cifar")


def draws(params, n: int, seed: int):
    """``n`` draws around ``params``, each leaf moved by half its mean magnitude times N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    return map_params(lambda v: v + 0.5 * v.abs().mean() * torch.randn((n,) + v.shape, generator=gen), params)


def images(n: int, seed: int = 3, lead: tuple = ()):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(lead + (n,) + SHAPE, generator=gen), torch.randint(0, CLASSES, (n,), generator=gen)


def close(got, want, of_max=1e-5):
    want = want.double()
    assert float((got.double() - want).abs().max()) <= of_max * float(want.abs().max())


def as_list(tree) -> list:
    return [dict(layer) for layer in tree]


@pytest.mark.parametrize("activation", ["relu", "leaky"])
def test_logits_and_input_gradients_match_the_reference(activation):
    """One draw: the port's f32 logits and attack-loss input gradient against
    the reference in f32 and in float64."""
    a = arch(activation)
    params = a.init(torch.Generator().manual_seed(1))
    x, labels = images(4)
    xt = x.clone().requires_grad_(True)
    logits = a.apply(params, xt)
    (grad,) = torch.autograd.grad(ce_on_outputs(torch.softmax(logits, -1), labels).sum(), xt)
    stacked = map_params(lambda v: v[None], params)
    for dtype in (torch.float32, torch.float64):
        close(logits.detach(), ref.logits(as_list(params), x, activation, dtype))
        _, want = ref.predictive_and_input_gradient(as_list(stacked), x, labels, activation, dtype)
        close(grad, want)


@pytest.mark.parametrize("per_draw", [False, True], ids=["shared_input", "input_per_draw"])
def test_stacked_apply_matches_a_loop_over_draws(per_draw):
    """``apply`` on S = 3 stacked draws (the first conv of S·16 channels, or
    grouped by draw for inputs per draw; every later one grouped) equals the
    one-draw ``apply`` on each draw and the reference's loop, and so does
    the input gradient of the attack's loss."""
    a = arch()
    stacked = draws(a.init(torch.Generator().manual_seed(2)), 3, seed=4)
    x, labels = images(2, lead=(3,) if per_draw else ())
    xt = x.clone().requires_grad_(True)
    out = a.apply(stacked, xt)
    looped = torch.stack([a.apply(map_params(lambda v: v[s], stacked), xt[s] if per_draw else xt)
                          for s in range(3)])
    assert out.shape == (3, 2, CLASSES)
    close(out.detach(), looped.detach())
    close(out.detach(), ref.stacked_logits(as_list(stacked), x))

    def loss(o):
        return ce_on_outputs(torch.softmax(o, -1).mean(0), labels).sum()

    (g_stacked,) = torch.autograd.grad(loss(out), xt)
    (g_looped,) = torch.autograd.grad(loss(looped), xt)
    close(g_stacked, g_looped)
    if not per_draw:
        close(g_stacked, ref.predictive_and_input_gradient(as_list(stacked), x, labels)[1])


def test_option_a_shortcut_subsamples_and_pads_each_draws_channels():
    """Every other pixel, from the first; each draw's C channels between C/2
    zeros on each side (8 + 16 + 8 for 16 -> 32), draw by draw."""
    h = torch.arange(2 * 2 * 4 * 4 * 4, dtype=torch.float32).reshape(2, 2 * 4, 4, 4)  # B 2, S 2, C 4, 4×4
    out = _option_a(h, 2, 8)
    assert out.shape == (2, 2 * 8, 2, 2)
    per_draw = out.reshape(2, 2, 8, 2, 2)
    assert torch.equal(per_draw[:, :, :2], torch.zeros(2, 2, 2, 2, 2))
    assert torch.equal(per_draw[:, :, 6:], torch.zeros(2, 2, 2, 2, 2))
    assert torch.equal(per_draw[:, :, 2:6], h.reshape(2, 2, 4, 4, 4)[:, :, :, ::2, ::2])
    assert torch.equal(ref.option_a(h[:, :4], 8), out[:, :8])
    wide = _option_a(torch.ones(1, 16, 32, 32), 1, 32)
    assert wide[0, :, 0, 0].tolist() == [0.0] * 8 + [1.0] * 16 + [0.0] * 8


def test_init_shapes_parameter_count_and_rejections():
    """20 HWIO ``{b, w}`` layers, 269,034 parameters at width 16 (He et al.'s
    0.27 M), torch's U(±1/sqrt(fan_in)) init, ``dims`` as (9·C_in, C_out);
    sides that do not divide by 4 and a fused predictive are refused."""
    a = build_architecture("resnet20", "relu", (3, 32, 32), CLASSES, WIDTH, "cifar")  # CHW accepted
    assert a.input_shape == SHAPE
    params = a.init(torch.Generator().manual_seed(0))
    widths = [16] * 7 + [32] * 6 + [64] * 6
    shapes = [(3, 3, 3, 16)] + [(3, 3, c_in, c) for c_in, c in zip(widths[:-1], widths[1:])] + [(64, CLASSES)]
    assert [tuple(p["w"].shape) for p in params] == shapes
    assert [tuple(p["b"].shape) for p in params] == [(s[-1],) for s in shapes]
    assert a.dims == tuple((math.prod(s[:-1]), s[-1]) for s in shapes)
    assert sum(v.numel() for v in tree_leaves(params)) == 269_034
    for p, (fan_in, _) in zip(params, a.dims):
        for v in p.values():
            assert float(v.abs().max()) <= 1 / math.sqrt(fan_in)
    with pytest.raises(ValueError, match="divide by 4"):
        build_architecture("resnet20", "relu", (30, 30, 3), CLASSES, WIDTH)
    with pytest.raises(ValueError, match="power of 2"):
        build_architecture("resnet20", "relu", SHAPE, CLASSES, 24)
    bnn = BNN.from_config(CONFIG, SHAPE, CLASSES, device="cpu")
    bnn.posterior = svi.svi_init(bnn.arch, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="fc/fc2"):
        bnn.predictive_fn(2, fused=True)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_the_grouped_conv_pads_and_strides_as_a_loop_over_draws(stride, layout):
    """A residual conv, ``_grouped_conv2d`` with padding 1 and stride 1 or 2,
    equals ``F.conv2d`` draw by draw on each draw's own channels, in float64
    to its rounding, from an NCHW or a channels-last input; under bf16
    products, to bf16's rounding, upcast to f32."""
    gen = torch.Generator().manual_seed(13)
    p = {"w": torch.randn((3, 3, 3, 5, 7), generator=gen, dtype=torch.float64),
         "b": torch.randn((3, 7), generator=gen, dtype=torch.float64)}
    h = torch.randn((2, 3 * 5, 8, 8), generator=gen, dtype=torch.float64)
    if layout == "channels_last":
        h = h.contiguous(memory_format=torch.channels_last)
    got = _grouped_conv2d(h, p["w"], p["b"], stride, 1)
    want = torch.cat([torch.nn.functional.conv2d(h[:, 5 * s:5 * s + 5], p["w"][s].permute(3, 2, 0, 1), p["b"][s],
                                                 stride, 1) for s in range(3)], dim=1)
    assert got.shape == want.shape == (2, 21, 8 // stride, 8 // stride)
    close(got, want, of_max=1e-13)
    with bf16_scope():
        low = _grouped_conv2d(h.float(), p["w"].float(), p["b"].float(), stride, 1)
    assert low.dtype == torch.float32
    close(low, want, of_max=2e-2)


def test_one_forward_counts_its_convs_and_nests_its_stages(monkeypatch):
    """A forward counts ``resnet.forwards`` once and ``resnet.cudnn_convs``
    19 times on the CPU (the grouped 3×3 kernel runs only on the card, where
    the count is 1), under bf16 products too; its three stage spans nest, in
    order, inside ``conv_trunk``."""
    a = arch()
    stacked = draws(a.init(torch.Generator().manual_seed(5)), 2, seed=6)
    x, _ = images(2)
    before = timing.counters()
    with timing.spans_on(), profile(activities=[ProfilerActivity.CPU]) as prof:
        a.apply(stacked, x)
    delta = {k: v - before.get(k, 0) for k, v in timing.counters().items()}
    assert delta["resnet.forwards"] == 1 and delta["resnet.cudnn_convs"] == 19
    monkeypatch.setenv("ROBUSTBNNS_BF16", "1")
    before = timing.counters()["resnet.cudnn_convs"]
    a.apply(stacked, x)
    assert timing.counters()["resnet.cudnn_convs"] - before == 19
    names = ("conv_trunk", "resnet.stage1", "resnet.stage2", "resnet.stage3")
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CPU and e.name() in names)
    assert [s[2] for s in spans] == list(names)
    assert all(spans[0][0] <= s[0] and s[1] <= spans[0][1] for s in spans[1:])


def test_one_elbo_step_matches_the_reference_elbo():
    """``svi.elbo_step`` on the 40 leaves of ``loc`` and of ``rho``: its loss and every leaf's gradient
    against the reference's negative ELBO in float64 (the leaves left in
    place by a zero-rate SGD so that the gradients can be read)."""
    a = arch()
    loc = a.init(torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    rho = map_params(lambda v: -4.0 + 0.5 * torch.randn(v.shape, generator=gen), loc)
    eps = map_params(lambda v: torch.randn(v.shape, generator=gen), loc)
    post = svi.MeanFieldPosterior(*(map_params(lambda v: v.clone().requires_grad_(True), t) for t in (loc, rho)))
    leaves = tree_leaves(post.loc) + tree_leaves(post.rho)
    assert len(leaves) == 2 * 40
    x, labels = images(4, seed=9)
    loss = svi.elbo_step(a.apply, torch.optim.SGD(leaves, lr=0.0), post, eps, x, labels)
    want, loc_grads, rho_grads = ref.neg_elbo_and_gradients(as_list(loc), as_list(rho), as_list(eps), x, labels)
    assert abs(float(loss) - float(want)) <= 1e-6 * abs(float(want))
    for got, w in zip(leaves, tree_leaves(tuple(loc_grads)) + tree_leaves(tuple(rho_grads)), strict=True):
        close(got.grad, w)


def test_bnn_from_config_trains_an_epoch_and_is_attacked():
    """The configuration through the port's normal path: ``BNN.from_config``,
    one SVI epoch of ``svi_train`` (two batches, the last masked) from the
    reference's N(0, 1) start, then one batch of 40-iteration PGD at
    ε 8/255 with fresh draws, which stays in the ε-ball and [0, 1] and moves
    pixels."""
    bnn = BNN.from_config(CONFIG, SHAPE, CLASSES, device="cpu")
    x, labels = images(6, seed=10)
    bnn.train(x, torch.nn.functional.one_hot(labels, CLASSES).float(), batch_size=4, train_acc_samples=2,
              verbose=False)
    assert len(bnn.history["loss"]) == 1 and math.isfinite(bnn.history["loss"][0])
    bnn.posterior = svi.MeanFieldPosterior(
        loc=bnn.arch.init(torch.Generator().manual_seed(11)),
        rho=map_params(lambda v: torch.full_like(v, -5.0), bnn.arch.init(torch.Generator().manual_seed(11))))
    eps = 8 / 255
    x_adv = attack(bnn, x[:2], labels[:2], method="pgd", epsilon=eps, n_samples=2, batch_size=2, save=False,
                   verbose=False, generator=torch.Generator().manual_seed(12))
    assert x_adv.shape == (2,) + SHAPE
    assert float((x_adv - x[:2]).abs().max()) <= eps + 1e-6
    assert float(x_adv.min()) >= 0.0 and float(x_adv.max()) <= 1.0
    assert bool((x_adv != x[:2]).any())
