"""The port's ``cct7`` (CCT-7/3×1 on stacked draws) against the plain reference
``tests/cct7_reference.py``, on the CPU at a tiny size: width 16 (4 heads of
4, an MLP of 32), 8×8×3 inputs (16 tokens), S 3 draws, batches of 2, with
seeded random weights; and the parameter count at the published widths.

Tolerances, of the largest entry, against the reference in float64: logits
and probabilities 1e-5, the input gradient 1e-4. The port computes in f32:
each product sums at most 144 terms in another order than the reference,
and 7 layers of LayerNorms and softmaxes carry that to 1.0e-7 of the
largest logit and 3.9e-8 of the largest probability (seed 1, shared
input). The input gradient reads 1.6e-7 there, but it passes back through
the tokenizer's ReLU and max-pool, where a pixel within rounding of a kink
or of a tie in its 3×3 window moves its gradient by a whole term: the
looser 1e-4 leaves room for that. The weights and the image rounded to TF32
alone move the logits by 8.9e-4 of their largest.
"""
from __future__ import annotations

import math

import cct7_reference as ref
import pytest
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from robustbnns_tpu_torch.attacks import attack
from robustbnns_tpu_torch.config import BNNConfig
from robustbnns_tpu_torch.inference import svi
from robustbnns_tpu_torch.models import architectures
from robustbnns_tpu_torch.models.architectures import build_architecture
from robustbnns_tpu_torch.models.bnn import BNN
from robustbnns_tpu_torch.ops import attention as attention_op
from robustbnns_tpu_torch.predict import sample_eps
from robustbnns_tpu_torch.utils import timing
from robustbnns_tpu_torch.utils.device import bf16_scope
from robustbnns_tpu_torch.utils.pytree import map_params, tree_leaves

SHAPE, CLASSES, WIDTH = (8, 8, 3), 10, 16
CONFIG = BNNConfig("cifar", WIDTH, "relu", "cct7", "svi", epochs=1, lr=0.01)


def arch(shape=SHAPE, width=WIDTH):
    return build_architecture("cct7", "relu", shape, CLASSES, width, "cifar")


def random_params(seed: int):
    """Every leaf N(0, 0.5²) around the port's init: LayerNorm scales near 1 but
    not 1, shifts, P and biases away from 0."""
    gen = torch.Generator().manual_seed(seed)
    return map_params(lambda v: v + 0.5 * torch.randn(v.shape, generator=gen) / math.sqrt(max(v.shape[0], 1)),
                      arch().init(torch.Generator().manual_seed(seed)))


def draws(params, n: int, seed: int):
    """``n`` draws around ``params``, each leaf moved by 0.1 of its mean magnitude times N(0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    return map_params(lambda v: v + 0.1 * v.abs().mean() * torch.randn((n,) + v.shape, generator=gen), params)


def images(n: int, seed: int = 3, lead: tuple = ()):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(lead + (n,) + SHAPE, generator=gen), torch.randint(0, CLASSES, (n,), generator=gen)


def close(got, want, of_max):
    want = want.double()
    assert float((got.double() - want).abs().max()) <= of_max * float(want.abs().max())


def as_list(tree) -> list:
    return [dict(layer) for layer in tree]


def attack_loss(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The attack's loss on stacked logits: CE of the mean softmax, summed over the batch."""
    return -F.log_softmax(torch.softmax(out, -1).mean(0), -1).gather(-1, labels[:, None]).sum()


@pytest.mark.parametrize("per_draw", [False, True], ids=["shared_input", "input_per_draw"])
def test_stacked_logits_probabilities_and_input_gradient_match_the_reference(per_draw):
    """S 3 stacked draws through ``apply`` (one tokenizer conv of S·16
    channels, or grouped by draw for inputs per draw; every product batched
    over the draws): logits, the predictive and the attack loss's input
    gradient against the reference's loop over draws in float64."""
    a = arch()
    stacked = draws(random_params(1), 3, seed=2)
    x, labels = images(2, lead=(3,) if per_draw else ())
    xt = x.clone().requires_grad_(True)
    out = a.apply(stacked, xt)
    assert out.shape == (3, 2, CLASSES)
    want = ref.stacked_logits(as_list(stacked), x)
    close(out.detach(), want, 1e-5)
    (grad,) = torch.autograd.grad(attack_loss(out, labels), xt)
    xr = x.double().requires_grad_(True)
    (want_grad,) = torch.autograd.grad(attack_loss(ref.stacked_logits(as_list(stacked), xr), labels), xr)
    close(grad, want_grad, 1e-4)
    if not per_draw:
        probs, ref_grad = ref.predictive_and_input_gradient(as_list(stacked), x, labels)
        close(torch.softmax(out.detach(), -1).mean(0), probs, 1e-5)
        close(grad, ref_grad, 1e-4)
        one = a.apply(map_params(lambda v: v[1], stacked), x)  # an unstacked tree: one draw
        close(one.detach(), want[1], 1e-5)


def test_the_reference_attention_is_torch_multihead_attention():
    """The reference's ``self_attention`` against ``torch.nn.MultiheadAttention``
    given the same weights (``in_proj_weight`` ``[W_q|W_k|W_v]ᵀ`` with a zero
    bias, ``out_proj`` ``W_oᵀ`` and ``b_o``), in float64: the reference is not
    held only to itself."""
    gen = torch.Generator().manual_seed(5)
    layer = {"w": torch.randn((WIDTH, 4 * WIDTH), generator=gen, dtype=torch.float64) / 4,
             "b": torch.randn((WIDTH,), generator=gen, dtype=torch.float64)}
    z = torch.randn((2, 16, WIDTH), generator=gen, dtype=torch.float64)
    mha = torch.nn.MultiheadAttention(WIDTH, ref.HEADS, batch_first=True, dtype=torch.float64)
    with torch.no_grad():
        mha.in_proj_weight.copy_(layer["w"][:, :3 * WIDTH].T)
        mha.in_proj_bias.zero_()
        mha.out_proj.weight.copy_(layer["w"][:, 3 * WIDTH:].T)
        mha.out_proj.bias.copy_(layer["b"])
        want, _ = mha(z, z, z, need_weights=False)
    close(ref.self_attention(z, layer), want, 1e-12)


def test_the_plain_attention_route_is_the_attention_function():
    """``ops.attention`` on the CPU: the plain route (counted in
    ``cct.plain_attention``, inside a ``cct.attention`` span), equal to
    ``softmax(q·kᵀ·scale)·v`` in float64; the fused route takes only f32
    CUDA tensors outside bf16 products."""
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn((3, 4, 16, 4), generator=gen, dtype=torch.float64) for _ in range(3))
    before = timing.counters()
    got = attention_op.attention(q, k, v, 0.5)
    after = timing.counters()
    assert after["cct.plain_attention"] - before.get("cct.plain_attention", 0) == 1
    assert after.get("cct.attention", 0) == before.get("cct.attention", 0)
    want = torch.softmax(torch.einsum("nhtd,nhsd->nhts", q, k) * 0.5, -1) @ v
    close(got, want, 1e-14)
    assert not attention_op.takes(q.float(), k.float(), v.float())


def test_published_widths_init_and_refusals():
    """At the published widths (d 256, 32×32×3 inputs, 256 tokens): 39
    ``{w, b}`` dicts and 3,760,139 parameters (Hassani et al.'s 3.76 M), in
    CCT's leaf layout; LayerNorms at scale 1 and shift 0, every other leaf
    within torch's U(±1/sqrt(fan_in)); a power-of-two width is required and
    the fused predictive is refused by name."""
    a = arch((32, 32, 3), 256)
    params = a.init(torch.Generator().manual_seed(0))
    assert len(params) == 39 and all(set(p) == {"w", "b"} for p in params)
    assert sum(v.numel() for v in tree_leaves(params)) == 3_760_139
    layer = [(3, 3, 3, 256), (256,), (256, 1024), (256,), (256, 512), (512, 256)]
    shapes = layer[:1] + layer[1:] * 7 + [(256,), (256, 1), (256, 10)]
    assert [tuple(p["w"].shape) for p in params] == shapes
    assert tuple(params[0]["b"].shape) == (256, 256)  # the positional table P
    norms = [1 + 5 * i for i in range(7)] + [3 + 5 * i for i in range(7)] + [36]
    for i, (p, (fan_in, out)) in enumerate(zip(params, a.dims)):
        assert p["w"].shape[-1] == out
        if i in norms:
            assert fan_in == 1 and torch.equal(p["w"], torch.ones(256)) and torch.equal(p["b"], torch.zeros(256))
        else:
            assert all(float(t.abs().max()) <= 1 / math.sqrt(fan_in) for t in p.values())
    assert a.dims[0] == (27, 256) and a.dims[2] == (256, 1024)
    with pytest.raises(ValueError, match="power of 2"):
        build_architecture("cct7", "relu", SHAPE, CLASSES, 24)
    bnn = BNN.from_config(CONFIG, SHAPE, CLASSES, device="cpu")
    bnn.posterior = svi.svi_init(bnn.arch, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="fc/fc2 architectures, not cct7"):
        bnn.predictive_fn(2, fused=True)


def test_one_forward_counts_and_nests_its_spans():
    """A forward counts ``cct.forwards`` once and, on the CPU, 7 plain
    attention calls and no fused one; its 7 ``cct.attention`` spans nest
    inside ``conv_trunk``."""
    a = arch()
    stacked = draws(random_params(7), 2, seed=8)
    x, _ = images(2)
    before = timing.counters()
    with timing.spans_on(), profile(activities=[ProfilerActivity.CPU]) as prof:
        a.apply(stacked, x)
    delta = {k: v - before.get(k, 0) for k, v in timing.counters().items()}
    assert delta["cct.forwards"] == 1 and delta["cct.plain_attention"] == 7 and not delta.get("cct.attention")
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CPU and e.name() in ("conv_trunk", "cct.attention"))
    assert [s[2] for s in spans] == ["conv_trunk"] + ["cct.attention"] * 7
    assert all(spans[0][0] <= s[0] and s[1] <= spans[0][1] for s in spans[1:])


def test_bf16_products_take_every_product_through_bf16_matmul(monkeypatch):
    """Under bf16 products every matmul of a forward goes through
    ``bf16_matmul``: 6 an encoder layer (q|k|v, q·kᵀ, p·v, W_o, W_1, W_2) and 3
    in the head (the pooling's gate and sum, the head), 45 in all; the
    tokenizer's conv runs in bf16. The logits then lie within bf16's
    rounding of the reference, and off its f32 rounding."""
    calls = []
    bf16_matmul = architectures.bf16_matmul

    def counted(a, b):
        calls.append(1)
        return bf16_matmul(a, b)

    monkeypatch.setattr(architectures, "bf16_matmul", counted)
    a = arch()
    stacked = draws(random_params(9), 2, seed=10)
    x, _ = images(2)
    with bf16_scope():
        low = a.apply(stacked, x)
    assert len(calls) == 45 and low.dtype == torch.float32
    want = ref.stacked_logits(as_list(stacked), x)
    close(low, want, 3e-2)
    assert float((low.double() - want).abs().max()) > 1e-4 * float(want.abs().max())


def test_one_pgd_iteration_through_attack_is_the_reference_step():
    """``attack(..., method="pgd", n_samples=3)`` on the BNN: its second
    iterate is the step from the first (the clean batch) with the
    reference's float64 input gradient under the same fresh draws, ``x1 =
    clamp(x0 + clamp(α·sign(g), -ε, ε), 0, 1)``, α = 2/max(x0), on every
    pixel whose gradient is clear of f32 rounding."""
    bnn = BNN.from_config(CONFIG, SHAPE, CLASSES, device="cpu")
    loc = random_params(11)
    rho = map_params(lambda v: torch.full_like(v, -3.0), loc)
    bnn.posterior = svi.MeanFieldPosterior(loc=loc, rho=rho)
    x0, labels = images(2, seed=12)
    seen = []

    class Recording:
        device = bnn.device

        def predictive_fn(self, n_samples=None, **kwargs):
            fn = bnn.predictive_fn(n_samples, **kwargs)

            def forward(x, generator=None):
                seen.append((x.detach().clone(), generator.get_state()))
                return fn(x, generator)

            return forward

    eps = 8 / 255
    attack(Recording(), x0, labels, method="pgd", epsilon=eps, n_samples=3, batch_size=2, save=False,
           verbose=False, generator=torch.Generator().manual_seed(13))
    assert len(seen) == 40 and torch.equal(seen[0][0], x0)
    gen = torch.Generator()
    gen.set_state(seen[0][1])
    noise = sample_eps(loc, 3, generator=gen)
    weights = [{k: m[k].double() + F.softplus(r[k].double()) * e[k].double() for k in m}
               for m, r, e in zip(loc, rho, noise)]
    _, grad = ref.predictive_and_input_gradient(weights, x0, labels)
    alpha = (2.0 / x0.reshape(2, -1).amax(-1)).reshape(2, 1, 1, 1)
    step = torch.clamp(x0 + torch.clamp(alpha * torch.sign(grad).float(), -eps, eps), 0.0, 1.0)
    clear = grad.abs() > 1e-5 * float(grad.abs().max())
    assert float(clear.double().mean()) > 0.9
    assert torch.equal(seen[1][0][clear], step[clear])


def test_one_elbo_step_matches_autograd_through_the_reference():
    """``svi.elbo_step`` on the 78 leaves of ``loc`` and of ``rho``: its loss
    and every leaf's gradient against the reference's negative ELBO and
    autograd through it in float64 (the leaves left in place by a zero-rate
    SGD so that the gradients can be read). The loss sums 16,139 KL terms
    and is compared at 1e-6 of itself; each gradient at 1e-4 of its
    largest entry, the input gradient's tolerance."""
    a = arch()
    loc = random_params(14)
    gen = torch.Generator().manual_seed(15)
    rho = map_params(lambda v: -3.0 + 0.5 * torch.randn(v.shape, generator=gen), loc)
    noise = map_params(lambda v: torch.randn(v.shape, generator=gen), loc)
    post = svi.MeanFieldPosterior(*(map_params(lambda v: v.clone().requires_grad_(True), t) for t in (loc, rho)))
    leaves = tree_leaves(post.loc) + tree_leaves(post.rho)
    assert len(leaves) == 2 * 78
    x, labels = images(4, seed=16)
    loss = svi.elbo_step(a.apply, torch.optim.SGD(leaves, lr=0.0), post, noise, x, labels)
    want, loc_grads, rho_grads = ref.neg_elbo_and_gradients(as_list(loc), as_list(rho), as_list(noise), x, labels)
    assert abs(float(loss) - float(want)) <= 1e-6 * abs(float(want))
    for got, w in zip(leaves, tree_leaves(tuple(loc_grads)) + tree_leaves(tuple(rho_grads)), strict=True):
        close(got.grad, w, 1e-4)


@pytest.mark.cuda
def test_the_fused_route_on_the_card_against_float64():
    """On the card, a CCT layer's attention shape (S·B 8, 4 heads, 256 tokens
    of 64): the fused route (counted in ``cct.attention``) and its input
    gradient within 1e-5 of their largest entries of float64, where the
    plain route with its operands rounded to TF32 lies farther than 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from robustbnns_tpu_torch.utils.device import exact_f32

    exact_f32()
    gen = torch.Generator(device="cuda").manual_seed(17)
    q, k, v = (torch.randn((8, 256, 4, 64), generator=gen, device="cuda").transpose(1, 2).requires_grad_(True)
               for _ in range(3))
    cot = torch.randn((8, 4, 256, 64), generator=gen, device="cuda")
    before = timing.counters().get("cct.attention", 0)
    out = attention_op.attention(q, k, v, 0.125)
    grads = torch.autograd.grad(out, (q, k, v), cot)
    assert timing.counters()["cct.attention"] == before + 1
    qd, kd, vd = (t.detach().double().requires_grad_(True) for t in (q, k, v))
    want = attention_op.attention_plain(qd, kd, vd, 0.125)
    want_grads = torch.autograd.grad(want, (qd, kd, vd), cot.double())
    for got, w in zip((out.detach(),) + grads, (want.detach(),) + want_grads):
        close(got, w, 1e-5)
