"""The port's conv architectures and conv SVI models against the JAX package's.

``conv`` on (28, 28, 1) and ``conv2`` on (16, 16, 3) at hidden 16, inputs from
numpy: logits and input gradients for each activation, the stacked-draw
``apply`` against a loop over draws, init shapes and bounds (HWIO), the
rejections, a conv posterior saved by JAX giving JAX's seeded predictive in
the port, every conv SVI model of the zoo, and the training and attack CLIs on
``model_0`` at full width on the CPU.

Tolerance: f32 parity at 1e-5 of the largest entry (the convs sum <= 800-term
products of O(1/sqrt(fan_in)) weights in another order than XLA).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustbnns_tpu.attacks.gradient_attacks import ce_on_outputs as jax_ce_on_outputs
from robustbnns_tpu.config import BNNConfig as JaxBNNConfig
from robustbnns_tpu.config import saved_BNNs as jax_saved_BNNs
from robustbnns_tpu.inference.svi import MeanFieldPosterior as JaxPosterior
from robustbnns_tpu.models import BNN as JaxBNN
from robustbnns_tpu.models import build_architecture as jax_build
from robustbnns_tpu.predict import resolve_sample_keys as jax_resolve_sample_keys
from robustbnns_tpu.utils.pytree import normal_like_tree as jax_normal_like_tree
from robustbnns_tpu_torch import config
from robustbnns_tpu_torch.attacks import attack, attack_evaluation
from robustbnns_tpu_torch.attacks.gradient_attacks import ce_on_outputs
from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior, svi_init
from robustbnns_tpu_torch.models.architectures import build_architecture
from robustbnns_tpu_torch.models.bnn import BNN
from robustbnns_tpu_torch.ops.fused_predict import supports_fused
from robustbnns_tpu_torch.predict import svi_predict
from robustbnns_tpu_torch.utils.pytree import map_params, tree_leaves

HIDDEN, CLASSES = 16, 10
NETS = {"conv": ((28, 28, 1), "mnist"), "conv2": ((16, 16, 3), "")}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(tree):
    return tuple({k: torch.tensor(np.asarray(v)) for k, v in layer.items()} for layer in tree)


def close(got, want, of_max=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=of_max * np.abs(want).max())


def inputs(shape, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(size=(n,) + shape).astype(np.float32), rng.integers(0, CLASSES, n)


@pytest.mark.parametrize("activation", ["relu", "leaky", "sigm", "tanh"])
@pytest.mark.parametrize("name", ["conv", "conv2"])
def test_conv_logits_and_input_gradients_match_jax(name, activation):
    """The same HWIO parameters give JAX's logits and JAX's input gradient of
    the attack loss (CE of the softmax probabilities)."""
    shape, dataset = NETS[name]
    jarch = jax_build(name, activation, shape, CLASSES, HIDDEN, dataset)
    tarch = build_architecture(name, activation, shape, CLASSES, HIDDEN, dataset)
    params = to_np(jarch.init(jax.random.key(1)))
    x, labels = inputs(shape)
    ref_grad = jax.grad(lambda a: jnp.sum(jax_ce_on_outputs(jax.nn.softmax(jarch.apply(params, a), -1), labels)))(x)

    xt = torch.from_numpy(x).requires_grad_(True)
    logits = tarch.apply(to_torch(params), xt)
    (grad,) = torch.autograd.grad(ce_on_outputs(torch.softmax(logits, -1), torch.from_numpy(labels)).sum(), xt)
    close(logits.detach(), jarch.apply(params, x))
    close(grad, ref_grad)


@pytest.mark.parametrize("name", ["conv", "conv2"])
def test_stacked_apply_matches_a_loop_over_draws(name):
    """``apply`` on S = 3 stacked draws (one conv of S·32 channels, one grouped
    conv) equals the one-draw ``apply`` on each draw, and so does its input
    gradient."""
    shape, dataset = NETS[name]
    tarch = build_architecture(name, "leaky", shape, CLASSES, HIDDEN, dataset)
    gen = torch.Generator().manual_seed(2)
    loc = tarch.init(gen)
    draws = map_params(lambda v: v + 0.5 * v.abs().mean() * torch.randn((3,) + v.shape, generator=gen), loc)
    x, labels = inputs(shape, n=4, seed=3)
    xt = torch.from_numpy(x).requires_grad_(True)
    stacked = tarch.apply(draws, xt)
    looped = torch.stack([tarch.apply(map_params(lambda v: v[s], draws), xt) for s in range(3)])
    assert stacked.shape == (3, 4, CLASSES)
    close(stacked.detach(), looped.detach())
    loss = lambda out: ce_on_outputs(torch.softmax(out, -1).mean(0), torch.from_numpy(labels)).sum()  # noqa: E731
    (g_stacked,) = torch.autograd.grad(loss(stacked), xt)
    (g_looped,) = torch.autograd.grad(loss(looped), xt)
    close(g_stacked, g_looped)


def test_conv_init_shapes_bounds_and_rejections():
    """HWIO conv weights with torch's U(±1/sqrt(C_in·25)) init, the head's
    (h, w, c)-flattened width, ``dims`` as each layer's (fan_in, out), no fused
    path; conv refuses non-MNIST datasets and shapes, and sizes stay powers of 2."""
    arch = build_architecture("conv", "leaky", (1, 28, 28), CLASSES, HIDDEN, "mnist")  # CHW accepted
    assert arch.input_shape == (28, 28, 1)
    assert arch.dims == ((25, 32), (800, HIDDEN), (7 * 7 * HIDDEN, CLASSES))
    params = arch.init(torch.Generator().manual_seed(0))
    shapes = [(5, 5, 1, 32), (5, 5, 32, HIDDEN), (7 * 7 * HIDDEN, CLASSES)]
    jparams = jax_build("conv", "leaky", (28, 28, 1), CLASSES, HIDDEN, "mnist").init(jax.random.key(0))
    for p, jp, shape, (fan_in, out) in zip(params, jparams, shapes, arch.dims):
        assert tuple(p["w"].shape) == shape == jp["w"].shape and tuple(p["b"].shape) == (out,) == jp["b"].shape
        for v in p.values():
            assert float(v.abs().max()) <= 1 / np.sqrt(fan_in) and float(v.std()) > 0.4 / np.sqrt(fan_in)
    assert not supports_fused(arch)
    assert build_architecture("conv2", "leaky", (16, 16, 3), CLASSES, HIDDEN).dims[2] == (HIDDEN, CLASSES)
    with pytest.raises(NotImplementedError, match="mnist"):
        build_architecture("conv", "leaky", (32, 32, 3), CLASSES, HIDDEN, "cifar")
    with pytest.raises(ValueError, match="flatten"):
        build_architecture("conv", "leaky", (16, 16, 3), CLASSES, HIDDEN, "mnist")
    with pytest.raises(ValueError, match="power of 2"):
        build_architecture("conv", "leaky", (28, 28, 1), CLASSES, 24, "mnist")
    with pytest.raises(ValueError, match="too small"):
        build_architecture("conv2", "leaky", (12, 12, 3), CLASSES, HIDDEN)


def _jax_draws_as_eps(loc, seeds):
    """JAX's seeded draws (``resolve_sample_keys``) as a stacked noise tree."""
    draws = [jax_normal_like_tree(k, loc) for k in jax_resolve_sample_keys(len(seeds), None, seeds)]
    return to_torch(jax.tree_util.tree_map(lambda *e: np.stack([np.asarray(a) for a in e]), *draws))


@pytest.mark.parametrize("name", ["conv", "conv2"])
def test_jax_conv_checkpoint_gives_jax_seeded_predictive(tmp_path, name):
    """A conv posterior saved by the JAX package loads into the port's ``BNN``
    (4-D leaves under ``loc/0/w`` ...), and with JAX's seeded draws injected
    gives JAX's seeded predictive; the mean network gives JAX's logits."""
    shape, dataset = NETS[name]
    cfg = config.BNNConfig(dataset or "mnist", HIDDEN, "leaky", name, "svi", epochs=1, lr=0.01)
    ref = JaxBNN.from_config(JaxBNNConfig(**dataclasses.asdict(cfg)), shape, CLASSES)
    rng = np.random.default_rng(4)
    loc = to_np(ref.arch.init(jax.random.key(5)))
    rho = jax.tree_util.tree_map(lambda p: (rng.normal(size=p.shape) * 0.3 - 2.0).astype(np.float32), loc)
    ref.posterior = JaxPosterior(jax.tree_util.tree_map(jnp.asarray, loc), jax.tree_util.tree_map(jnp.asarray, rho))
    ref.save(rel_path=str(tmp_path))

    ours = BNN.from_config(cfg, shape, CLASSES, device="cpu").load(rel_path=str(tmp_path))
    for a, b in zip(tree_leaves(ours.posterior.loc) + tree_leaves(ours.posterior.rho),
                    jax.tree_util.tree_leaves((loc, rho)), strict=True):
        np.testing.assert_array_equal(a.numpy(), b)
    x, _ = inputs(shape, n=6, seed=6)
    seeds = [0, 1, 2]
    got = svi_predict(ours.arch, ours.posterior, torch.from_numpy(x), _jax_draws_as_eps(loc, seeds))
    close(got, ref.forward(x, n_samples=3, seeds=seeds))
    close(ours.forward(torch.from_numpy(x), avg_posterior=True), ref.forward(x, avg_posterior=True))
    with pytest.raises(NotImplementedError, match="fc/fc2"):
        ours.predictive_fn(3, fused=True)


@pytest.mark.parametrize("model", ["model_0", "model_2", "model_4", "model_6", "model_8"])
def test_every_conv_svi_model_builds(model):
    """``BNN.from_config`` builds every conv SVI model of the zoo at full width,
    with the JAX package's leaf shapes (model_0: 0.66 M parameters)."""
    cfg = config.saved_BNNs[model]
    bnn = BNN.from_config(cfg, (28, 28, 1), CLASSES, device="cpu")
    ref = jax_build(cfg.architecture, cfg.activation, (28, 28, 1), CLASSES, cfg.hidden_size, cfg.dataset)
    ours = tree_leaves(bnn.arch.init(torch.Generator().manual_seed(0)))
    theirs = jax.tree_util.tree_leaves(jax.eval_shape(ref.init, jax.random.key(0)))
    assert [tuple(v.shape) for v in ours] == [v.shape for v in theirs]
    if model == "model_0":
        assert sum(v.numel() for v in ours) == 661_834
    assert cfg.name() == jax_saved_BNNs[model].name()


def test_model_0_trains_saves_loads_and_is_attacked_on_the_cpu(monkeypatch, tmp_path):
    """``cli.train_bnn --model_idx=0`` trains the full-width conv-512 on 32
    surrogate images for its 5 epochs (one step each: the N(0, 1) init's
    single-draw ELBO is too noisy to fall in five steps, so the test asks for a
    finite loss and a moved posterior), saves, evaluates and loads; the attack
    CLI then loads the posterior and attacks it by FGSM through the unfused
    predictive (``model_0`` has no fused path)."""
    from robustbnns_tpu_torch.cli import attacks as attacks_cli
    from robustbnns_tpu_torch.cli import train_bnn
    from robustbnns_tpu_torch.data import datasets

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ROBUSTBNNS_SYNTH_CACHE", str(tmp_path / "synthetic"))
    monkeypatch.setattr(config, "DATA", str(tmp_path / "data") + "/")
    monkeypatch.setattr(datasets, "_surrogate_served", set())
    datasets._synthetic_image_dataset.cache_clear()
    monkeypatch.setattr(attacks_cli, "load_data", lambda ds, n, shuffle=True: train_bnn.load_data(ds, 32, shuffle))

    flags = ["--model_idx=0", "--n_inputs=32", "--savedir=DATA", "--device=cpu"]
    bnn = train_bnn.main(flags + ["--train=True", "--test=True"])
    loss = bnn.history["loss"]
    assert bnn.arch.name == "conv" and len(loss) == 5 and np.isfinite(loss).all()
    init = svi_init(bnn.arch, torch.Generator().manual_seed(0))
    assert not torch.equal(bnn.posterior.loc[1]["w"], init.loc[1]["w"])
    assert not any(v.requires_grad for v in tree_leaves(bnn.posterior.loc) + tree_leaves(bnn.posterior.rho))
    loaded = train_bnn.main(flags + ["--train=False", "--test=False"])
    for a, b in zip(tree_leaves(bnn.posterior.loc), tree_leaves(loaded.posterior.loc)):
        assert torch.equal(a, b)

    out = attacks_cli.main(["--model_type=bnn", "--model_idx=0", "--train=False", "--test=False",
                            "--n_inputs=4", "--device=cpu", "--attack_method=fgsm"])
    x, xa = torch.as_tensor(out["x_test"]), out["x_attack"]
    assert xa.shape == (4, 28, 28, 1) and bool(torch.isfinite(xa).all())
    assert float((xa - x).abs().max()) <= 0.3 + 1e-6 and 0 <= float(xa.min()) and float(xa.max()) <= 1
    with pytest.raises(NotImplementedError, match="fc/fc2"):
        attacks_cli.main(["--model_type=bnn", "--model_idx=0", "--train=False", "--test=False",
                          "--n_inputs=4", "--device=cpu", "--fused=True"])


def test_conv_attack_moves_pixels_and_is_evaluated():
    """Bayesian FGSM and 40-step PGD on a conv posterior with a real scale: inside
    the ε-ball and [0, 1], most pixels moved, the same generator state repeats
    FGSM; the defence evaluation scores PGD's images."""
    cfg = config.BNNConfig("mnist", HIDDEN, "leaky", "conv", "svi", epochs=1, lr=0.01)
    bnn = BNN.from_config(cfg, (28, 28, 1), CLASSES, device="cpu")
    loc = bnn.arch.init(torch.Generator().manual_seed(0))
    bnn.posterior = MeanFieldPosterior(loc, map_params(lambda v: torch.full_like(v, -4.0), loc))
    x, labels = inputs((28, 28, 1), n=6, seed=8)
    y = np.eye(CLASSES, dtype=np.float32)[labels]
    run = lambda method, seed: attack(  # noqa: E731
        bnn, x, y, method=method, n_samples=3, generator=torch.Generator().manual_seed(seed), save=False, verbose=False)
    for method in ("fgsm", "pgd"):
        xa = run(method, 0)
        assert float((xa - torch.from_numpy(x)).abs().max()) <= 0.3 + 1e-6
        assert 0 <= float(xa.min()) and float(xa.max()) <= 1
        assert float(((xa - torch.from_numpy(x)).abs() > 1e-6).float().mean()) > 0.5
        if method == "fgsm":
            assert torch.equal(xa, run(method, 0)) and not torch.equal(xa, run(method, 1))
    clean, adv, rob = attack_evaluation(bnn, x, xa, y, n_samples=3, verbose=False)
    assert 0 <= adv <= 100 and 0 <= clean <= 100 and rob.shape == (6,)
