"""The plain reference against the program's CPU paths at tiny shapes. Only
this test imports the program beside the reference; the reference imports
nothing of it (``test_bench_imports.py``)."""
from __future__ import annotations

import torch

from benchmark.reference import arch_conv, arch_fc2, draws
from benchmark.reference import pgd as ref_pgd
from benchmark.reference import svi as ref_svi
from benchmark.reference.precision import PRECISIONS, round_tf32

F64, F32 = PRECISIONS["float64"], PRECISIONS["float32"]


def _arch(name: str, hidden: int = 16):
    from robustbnns_tpu_torch.models.architectures import build_architecture

    return build_architecture(name, "leaky", (28, 28, 1), 10, hidden, dataset_name="mnist")


def _posterior(arch, seed: int, scale: float = 0.1):
    params = arch.init(torch.Generator().manual_seed(seed))
    loc = [dict(layer) for layer in params]
    rho = [{k: torch.full_like(v, -3.0) for k, v in layer.items()} for layer in params]
    return loc, rho


def test_draw_seed_and_fused_noise_are_the_programs():
    from robustbnns_tpu_torch.ops.fused_predict import layer_seed
    from robustbnns_tpu_torch.ops.sampled_dense import sampled_noise
    from robustbnns_tpu_torch.utils.prng import draw_seed

    generator = torch.Generator().manual_seed(99)
    state = generator.get_state()
    assert draws.draw_seed(state) == draw_seed(generator)
    assert draws.layer_seed(2**31 + 5, 2) == layer_seed(2**31 + 5, 2)
    want = sampled_noise(12345, 5, 9, 7, "cpu")
    assert torch.equal(draws.fused_noise(12345, range(5), 9, 7, "cpu"), want)
    assert torch.equal(draws.fused_noise(12345, range(2, 5), 9, 7, "cpu"), want[2:])


def test_unfused_noise_is_the_programs():
    from robustbnns_tpu_torch.predict import sample_eps

    loc, _ = _posterior(_arch("conv"), 0)
    want = sample_eps(tuple(loc), 3, generator=torch.Generator().manual_seed(4))
    seed = draws.draw_seed(torch.Generator().manual_seed(4).get_state())
    got = draws.unfused_noise(seed, loc, 3, "cpu")
    assert all(torch.equal(got[li][k], want[li][k]) for li in range(3) for k in ("b", "w"))


def _stacked(loc, n):
    gen = torch.Generator().manual_seed(5)
    return [{k: v + 0.1 * torch.randn((n,) + v.shape, generator=gen) for k, v in layer.items()} for layer in loc]


def test_fc2_and_conv_logits_are_the_programs():
    x = torch.rand((4, 28, 28, 1), generator=torch.Generator().manual_seed(1))
    for name, ref in (("fc2", arch_fc2), ("conv", arch_conv)):
        arch = _arch(name)
        w = _stacked(_posterior(arch, 0)[0], 3)
        want = arch.apply(tuple(w), x).double()
        got = ref.logits([{k: v.double() for k, v in layer.items()} for layer in w], x, "leaky", F64)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_predictive_and_gradient_are_the_programs():
    from robustbnns_tpu_torch.attacks.gradient_attacks import _input_gradients
    from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior
    from robustbnns_tpu_torch.ops.fused_predict import fused_predictive_fn
    from robustbnns_tpu_torch.predict import sample_eps, svi_predict

    x = torch.rand((4, 28, 28, 1), generator=torch.Generator().manual_seed(2))
    labels = torch.tensor([0, 3, 9, 1])
    for name, fused in (("fc2", True), ("conv", False)):
        arch = _arch(name)
        loc, rho = _posterior(arch, 1)
        post = MeanFieldPosterior(tuple(loc), tuple(rho))
        if fused:
            forward = fused_predictive_fn(arch, post, 3)
        else:
            def forward(x, generator):
                return svi_predict(arch, post, x, sample_eps(post.loc, 3, generator=generator))
        state = torch.Generator().manual_seed(8).get_state()
        gen = torch.Generator()
        gen.set_state(state)
        want_grad = _input_gradients(forward, x, labels, gen)
        gen.set_state(state)
        want_probs = forward(x, gen)
        ref = arch_fc2 if fused else arch_conv
        w = ref_pgd.sampled_weights(loc, rho, draws.draw_seed(state), 3, fused, torch.float64)
        probs, grad = ref_pgd.predictive_and_gradient(ref, w, x, labels, "leaky", F64)
        assert torch.allclose(probs, want_probs.double(), atol=1e-6)
        assert torch.allclose(grad, want_grad.double(), atol=1e-5 * float(grad.abs().max()))


def test_pgd_step_is_the_programs():
    from robustbnns_tpu_torch.attacks.gradient_attacks import pgd_attack

    gen = torch.Generator().manual_seed(3)
    x0 = torch.rand((4, 28, 28, 1), generator=gen)
    w = torch.randn((784, 10), generator=gen)

    def forward(x, generator):
        return torch.softmax(x.reshape(4, -1) @ w, -1)

    labels = torch.tensor([1, 2, 3, 4])
    x1 = pgd_attack(forward, x0, labels, epsilon=0.3, iters=1)
    xr = x0.clone().requires_grad_(True)
    loss = -torch.log_softmax(forward(xr, None), -1).gather(-1, labels[:, None]).sum()
    (grad,) = torch.autograd.grad(loss, xr)
    assert torch.equal(ref_pgd.pgd_step(x0, x0, grad, 0.3), x1)


def test_svi_steps_are_the_programs():
    from benchmark.kinds.svi import StepRecorder
    from robustbnns_tpu_torch.inference import svi
    from robustbnns_tpu_torch.utils.pytree import tree_leaves

    arch = _arch("fc2")
    gen = torch.Generator().manual_seed(6)
    loc = [{k: torch.randn(v.shape, generator=gen) for k, v in layer.items()} for layer in arch.init(gen)]
    rho = [{k: torch.randn(v.shape, generator=gen) for k, v in layer.items()} for layer in loc]
    x = torch.rand((14, 28, 28, 1), generator=gen)  # 4 steps of 4 an epoch, the last of 2 rows
    y = torch.nn.functional.one_hot(torch.randint(0, 10, (14,), generator=gen), 10).float()
    post = svi.MeanFieldPosterior(*(tuple({k: v.clone().requires_grad_(True) for k, v in layer.items()}
                                          for layer in tree) for tree in (loc, rho)))
    params = tree_leaves(post.loc) + tree_leaves(post.rho)
    opt = torch.optim.Adam(params, lr=0.02, betas=(0.9, 0.999), eps=1e-8)
    recorder = StepRecorder(svi, params, opt, 3, 4)
    try:
        train = torch.Generator().manual_seed(7)
        for _ in range(2):
            svi.svi_epoch(arch.apply, opt, 4, 2, post, x, y, svi.generator_draws(train, post.loc, 14, 4, 2))
    finally:
        recorder.restore()
    assert svi.elbo_step is recorder.step_fn

    def close(got, want):
        return all(torch.allclose(a.double(), b, atol=1e-5 * float(b.abs().max())) for a, b in zip(got, want))

    ref = ref_svi.first_steps(arch_fc2, "leaky", loc, rho, x, y, 4, 7, 0.02, 2, 3, F64)
    assert [r["step"] for r in recorder.records] == [1, 2, 3]
    for got, want in zip(recorder.records, ref):
        assert abs(float(got["loss"]) - want["loss"]) <= 1e-5 * abs(want["loss"])
        assert close(got["grad"], want["grad"]) and close(got["after"], want["after"])
    last = recorder.last  # the second epoch's last step: 2 rows, padded and masked
    rows, eps = ref_svi.step_draws(7, loc, 14, 4, 2, 1, 3)
    assert last["step"] == 8 and rows.numel() == 2
    want = ref_svi.one_step(arch_fc2, "leaky", last["before"], last["m"], last["v"], 8, loc, eps, x[rows],
                            y[rows].argmax(-1), 0.02, F64)
    assert abs(float(last["loss"]) - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert close(last["grad"], want["grad"]) and close(last["after"], want["after"])


def test_tf32_rounding():
    t = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-12, -3.0], dtype=torch.float32)
    got = round_tf32(t)
    assert got.tolist() == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, -3.0]
    assert not torch.equal(F32.operand(t), PRECISIONS["tf32"].operand(t))
