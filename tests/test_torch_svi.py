"""The port's SVI trainer against the JAX package's, at small widths.

The ELBO and its gradient, full ``svi_train`` runs (fc2 and conv) with JAX's
own permutation and step noise replayed, the input gradients of posteriors
trained that way, the S = 1 identity between the fused
sampled-dense parameter gradient and the ELBO likelihood term's gradient on
the materialised draw, determinism, the metric-only bf16 accuracy, and
checkpoints that cross between the packages both ways. Inputs come from numpy;
JAX's threefry draws are injected where the port would draw from a
``torch.Generator``.

Tolerances: the KL and the log-likelihood are f32 sums of <= 1e3 O(1) terms,
held to 1e-5 relative; gradients chain the network's f32 products, 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustbnns_tpu.config import BNNConfig as JaxBNNConfig
from robustbnns_tpu.inference import svi as jax_svi
from robustbnns_tpu.models import BNN as JaxBNN
from robustbnns_tpu.models import build_architecture as jax_build
from robustbnns_tpu.predict import resolve_sample_keys as jax_resolve_sample_keys
from robustbnns_tpu.utils.prng import make_key
from robustbnns_tpu.utils.pytree import normal_like_tree as jax_normal_like_tree
from robustbnns_tpu_torch import config
from robustbnns_tpu_torch.inference.svi import (
    EpochDraws,
    categorical_loglik_sum,
    elbo_loss,
    gaussian_kl_to_std_normal,
    sample_meanfield_eps,
    svi_train,
)
from robustbnns_tpu_torch.models.architectures import build_architecture
from robustbnns_tpu_torch.models.bnn import BNN
from robustbnns_tpu_torch.ops.fused_predict import fused_logits, layer_seed
from robustbnns_tpu_torch.ops.sampled_dense import sampled_noise
from robustbnns_tpu_torch.predict import svi_predict
from robustbnns_tpu_torch.utils.checkpoint import meanfield_from_numpy
from robustbnns_tpu_torch.utils.pytree import tree_leaves
from torch_mesh_worker import one_rank_mesh

SHAPE, CLASSES, HIDDEN = (6, 6, 1), 10, 16
N_ROWS, BATCH = 300, 64  # five batches, the last padded from 44 rows


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(tree):
    return tuple({k: torch.tensor(np.asarray(v)) for k, v in layer.items()} for layer in tree)


def post_leaves(post):
    return tree_leaves(post.loc) + tree_leaves(post.rho)


def data(n=N_ROWS, seed=0, shape=SHAPE):
    """Uniform images whose label is the brightest of ten pixel groups, so SVI can learn it."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n,) + shape).astype(np.float32)
    labels = x.reshape(n, -1)[:, :30].reshape(n, CLASSES, 3).sum(-1).argmax(-1)
    return x, np.eye(CLASSES, dtype=np.float32)[labels]


@pytest.fixture(scope="module")
def nets():
    """Both packages' fc2-16 and a JAX ``init_meanfield`` posterior as numpy."""
    jarch = jax_build("fc2", "leaky", SHAPE, CLASSES, HIDDEN)
    tarch = build_architecture("fc2", "leaky", SHAPE, CLASSES, HIDDEN)
    jpost = to_np(jax_svi.init_meanfield(jax.random.key(0), jarch.init(jax.random.key(1))))
    return jarch, tarch, jpost


def test_kl_and_masked_loglik_match_jax(nets):
    _, _, jpost = nets
    ours = gaussian_kl_to_std_normal(meanfield_from_numpy(*jpost))
    ref = jax_svi.gaussian_kl_to_std_normal(jpost)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)

    rng = np.random.default_rng(1)
    logits = (3 * rng.normal(size=(7, CLASSES))).astype(np.float32)
    labels = rng.integers(0, CLASSES, 7)
    mask = np.array([1, 1, 1, 1, 1, 0, 0], np.float32)
    for m in (None, mask):
        ours = categorical_loglik_sum(torch.from_numpy(logits), torch.from_numpy(labels),
                                      None if m is None else torch.from_numpy(m))
        ref = jax_svi.categorical_loglik_sum(logits, labels, m)
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-5)


def test_elbo_loss_and_gradient_match_jax(nets):
    """Given the eps JAX's ``normal_like_tree(k_elbo, loc)`` draws, the port's
    negative ELBO and its gradient in all 12 leaves equal JAX's, padded rows masked."""
    jarch, tarch, jpost = nets
    x, y = data(9)
    labels = y.argmax(-1)
    mask = np.array([1] * 7 + [0] * 2, np.float32)
    key = jax.random.key(5)
    loss_ref, grads_ref = jax.value_and_grad(
        lambda p: jax_svi.elbo_loss(jarch.apply, p, key, x, labels, mask)
    )(jax_svi.MeanFieldPosterior(*jpost))
    eps = to_torch(jax_normal_like_tree(key, jpost.loc))

    post = meanfield_from_numpy(*jpost)
    for v in post_leaves(post):
        v.requires_grad_(True)
    loss = elbo_loss(tarch.apply, post, eps, torch.from_numpy(x), torch.from_numpy(labels),
                     torch.from_numpy(mask))
    grads = torch.autograd.grad(loss, post_leaves(post))
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), rtol=1e-5)
    for got, want in zip(grads, jax.tree_util.tree_leaves(grads_ref), strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def replayed_draws(epoch_key, loc, n, batch_size, train_acc_samples):
    """The permutation and the per-step noise that JAX's ``_svi_epoch`` draws
    from ``epoch_key`` (``svi.py:146-176``), as an :class:`EpochDraws`."""
    perm_key, scan_key = jax.random.split(epoch_key)
    perm = np.asarray(jax.random.permutation(perm_key, n))
    elbo_eps, acc_eps = [], []
    for k in jax.random.split(scan_key, -(-n // batch_size)):
        k_elbo, k_acc = jax.random.split(k)
        elbo_eps.append(to_torch(jax_normal_like_tree(k_elbo, loc)))
        draws = [jax_normal_like_tree(sk, loc) for sk in jax.random.split(k_acc, train_acc_samples)]
        acc_eps.append(to_torch(jax.tree_util.tree_map(lambda *e: np.stack(e), *draws)))
    return EpochDraws(torch.tensor(perm), elbo_eps, acc_eps)


def train_both(jarch, tarch, x, y, *, seed, epochs, lr, batch, acc_samples):
    """``svi_train`` in both packages from JAX's init for ``seed``, the port
    with JAX's permutation and step noise replayed; returns the port's and
    JAX's posteriors and histories, and the init, as numpy where JAX's."""
    post_ref, hist_ref = jax_svi.svi_train(
        jarch, x, y, epochs=epochs, lr=lr, batch_size=batch, seed=seed,
        train_acc_samples=acc_samples, verbose=False,
    )
    init_key, train_key = jax.random.split(make_key(seed))
    init = to_np(jax_svi.init_meanfield(init_key, jarch.init(jax.random.key(0))))
    post, hist = svi_train(
        tarch, x, y, epochs=epochs, lr=lr, batch_size=batch, train_acc_samples=acc_samples,
        verbose=False, device="cpu", init=meanfield_from_numpy(*init),
        draws=lambda e: replayed_draws(jax.random.fold_in(train_key, e), init.loc, len(x), batch, acc_samples),
    )
    return post, hist, post_ref, hist_ref, init


def test_svi_train_matches_jax_with_its_draws_replayed(nets):
    """``svi_train`` against JAX's, both from JAX's init for seed 3, two epochs
    of five steps (the last batch padded), with JAX's permutation and step noise
    replayed. ``torch.optim.Adam`` rounds m̂/(√v̂ + eps) in another order than
    optax, and each step's update is near ±lr whatever the gradient's scale, so
    an entry whose gradient is near 0 can move by about 1e-4·lr more or less per
    step: the posteriors agree to 1e-3 of lr = 1e-2 after ten steps, the summed
    loss to 1e-5 relative, and the 4-draw accuracy to at most one row of 300."""
    jarch, tarch, _ = nets
    x, y = data()
    lr = 1e-2
    post, hist, post_ref, hist_ref, init = train_both(jarch, tarch, x, y, seed=3, epochs=2, lr=lr,
                                                      batch=BATCH, acc_samples=4)
    for got, want, start in zip(post_leaves(post), jax.tree_util.tree_leaves(post_ref),
                                jax.tree_util.tree_leaves(init), strict=True):
        assert not np.array_equal(np.asarray(want), start)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-3 * lr)
    np.testing.assert_allclose(hist["loss"], hist_ref["loss"], rtol=1e-5)
    for acc, acc_ref in zip(hist["accuracy"], hist_ref["accuracy"], strict=True):
        assert abs(acc - acc_ref) <= 100.0 / N_ROWS + 1e-9


def test_svi_train_conv_matches_jax_with_its_draws_replayed():
    """The same on ``conv``-16 over 28x28 images: 80 rows in batches of 32 (the
    last padded), two epochs, 2-draw train accuracy. The ELBO draw runs the
    one-draw ``apply``, the accuracy draws the stacked one. The summed loss is
    held to 1e-5 relative as above and the accuracy to one row of 80; the
    posteriors to 2e-3·lr, since the 12,800 weights of the second conv hold
    more entries whose near-zero gradient lets Adam's rounding move them (one
    reached 1.0e-3·lr after six steps)."""
    shape = (28, 28, 1)
    jarch = jax_build("conv", "leaky", shape, CLASSES, HIDDEN, "mnist")
    tarch = build_architecture("conv", "leaky", shape, CLASSES, HIDDEN, "mnist")
    x, y = data(80, seed=1, shape=shape)
    lr = 1e-2
    post, hist, post_ref, hist_ref, init = train_both(jarch, tarch, x, y, seed=5, epochs=2, lr=lr,
                                                      batch=32, acc_samples=2)
    for got, want, start in zip(post_leaves(post), jax.tree_util.tree_leaves(post_ref),
                                jax.tree_util.tree_leaves(init), strict=True):
        assert got.shape == np.shape(want) and not np.array_equal(np.asarray(want), start)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-3 * lr)
    np.testing.assert_allclose(hist["loss"], hist_ref["loss"], rtol=1e-5)
    for acc, acc_ref in zip(hist["accuracy"], hist_ref["accuracy"], strict=True):
        assert abs(acc - acc_ref) <= 100.0 / 80 + 1e-9


def test_fused_s1_gradient_is_the_elbo_likelihood_gradient(nets):
    """At S = 1 the gradient of −Σ log p(y | x, w) through the fused
    sampled-dense ops (their dparams twins) equals autograd through the
    materialised network on the same eps, in the port and in JAX. rho near −1:
    the noise term is exercised."""
    jarch, tarch, jpost = nets
    rng = np.random.default_rng(4)
    loc = to_np(jarch.init(jax.random.key(2)))
    rho = jax.tree_util.tree_map(lambda p: (rng.normal(size=p.shape) * 0.3 - 1.0).astype(np.float32), loc)
    x, y = data(12, seed=4)
    labels = torch.from_numpy(y.argmax(-1))
    seed = 21
    eps = []
    for li, (i_dim, o_dim) in enumerate(tarch.dims):
        e = sampled_noise(layer_seed(seed, li), 1, i_dim + 1, o_dim, "cpu")[0]
        eps.append({"w": e[:i_dim], "b": e[i_dim]})
    eps = tuple(eps)

    def grads(loss_of):
        post = meanfield_from_numpy(loc, rho)
        for v in post_leaves(post):
            v.requires_grad_(True)
        return torch.autograd.grad(loss_of(post), post_leaves(post))

    xt = torch.from_numpy(x)
    fused = grads(lambda p: -categorical_loglik_sum(fused_logits(tarch, p, xt, 1, seed)[0], labels))
    dense = grads(lambda p: -categorical_loglik_sum(tarch.apply(sample_meanfield_eps(p, eps), xt), labels))
    eps_np = to_np(eps)
    ref = jax.grad(lambda p: -jax_svi.categorical_loglik_sum(
        jarch.apply(jax.tree_util.tree_map(lambda m, r, e: m + jax.nn.softplus(r) * e, p.loc, p.rho, eps_np), x),
        jnp.asarray(y.argmax(-1)),
    ))(jax_svi.MeanFieldPosterior(loc, rho))
    for got, mat, want in zip(fused, dense, jax.tree_util.tree_leaves(ref), strict=True):
        np.testing.assert_allclose(got.numpy(), mat.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert max(float(g.abs().max()) for g in fused[len(fused) // 2:]) > 1e-2  # drho is not ~0


def test_svi_train_is_deterministic_given_a_seed(nets):
    """The same seed gives the same posterior and history, another seed another,
    and so does a one-rank mesh; the leaves come back detached, so a later
    attack asks for no parameter gradient."""
    _, tarch, _ = nets
    x, y = data()
    run = lambda seed: svi_train(tarch, x, y, epochs=2, lr=1e-2, batch_size=BATCH, seed=seed,  # noqa: E731
                                 train_acc_samples=2, verbose=False, device="cpu")
    (p1, h1), (p2, h2), (p3, _) = run(0), run(0), run(1)
    assert all(torch.equal(a, b) for a, b in zip(post_leaves(p1), post_leaves(p2)))
    assert (h1["loss"], h1["accuracy"]) == (h2["loss"], h2["accuracy"])
    assert len(h1["seconds"]) == 2 and min(h1["seconds"]) > 0
    assert not all(torch.equal(a, b) for a, b in zip(post_leaves(p1), post_leaves(p3)))
    assert not any(v.requires_grad for v in post_leaves(p1))
    with one_rank_mesh() as mesh:  # a one-rank mesh runs its collectives and changes no bit
        pm, hm = svi_train(tarch, x, y, epochs=2, lr=1e-2, batch_size=BATCH, seed=0, train_acc_samples=2,
                           verbose=False, device="cpu", mesh=mesh)
    assert all(torch.equal(a, b) for a, b in zip(post_leaves(p1), post_leaves(pm)))
    assert (h1["loss"], h1["accuracy"]) == (hm["loss"], hm["accuracy"])


def test_train_acc_bf16_is_metric_only(nets):
    """As ``tests/test_svi.py``: the bf16 accuracy predictive leaves the
    optimisation untouched, and the metric moves by near-ties only."""
    _, tarch, _ = nets
    x, y = data()
    runs = [
        svi_train(tarch, x, y, epochs=2, lr=1e-2, batch_size=BATCH, train_acc_bf16=bf16,
                  verbose=False, device="cpu")
        for bf16 in (False, True)
    ]
    (post_a, hist_a), (post_b, hist_b) = runs
    assert all(torch.equal(a, b) for a, b in zip(post_leaves(post_a), post_leaves(post_b)))
    assert hist_a["loss"] == hist_b["loss"]
    for acc_a, acc_b in zip(hist_a["accuracy"], hist_b["accuracy"]):
        assert abs(acc_a - acc_b) <= 2.0


CFG = config.BNNConfig("mnist", HIDDEN, "leaky", "fc2", "svi", epochs=1, lr=1e-2)


def _jax_draws_as_eps(loc, seeds):
    """JAX's seeded draws (``resolve_sample_keys``) as a stacked noise tree."""
    keys = jax_resolve_sample_keys(len(seeds), None, seeds)
    draws = [jax_normal_like_tree(k, loc) for k in keys]
    return to_torch(jax.tree_util.tree_map(lambda *e: np.stack([np.asarray(a) for a in e]), *draws))


@pytest.mark.parametrize("trained_by", ["port", "jax"])
def test_trained_posterior_crosses_packages(tmp_path, trained_by):
    """A posterior trained by one package, saved with its ``save`` and loaded
    by the other's ``BNN.load``, gives the same seeded predictive (JAX's draws
    for seeds 0-2 injected into the port) and the same mean-network logits. The
    N(0, 1) init gives logits up to ~50, held to 1e-5 of their largest: f32
    sums of 36- and 16-term products, ordered differently."""
    x, y = data()
    rel = str(tmp_path)
    ours = BNN.from_config(CFG, SHAPE, CLASSES, device="cpu")
    ref = JaxBNN.from_config(JaxBNNConfig(**dataclasses.asdict(CFG)), SHAPE, CLASSES)
    trainer, loader = (ours, ref) if trained_by == "port" else (ref, ours)
    trainer.train(x, y, batch_size=BATCH, verbose=False)
    trainer.save(rel_path=rel)
    loader.load(rel_path=rel)
    assert not any(v.requires_grad for v in post_leaves(ours.posterior))
    for a, b in zip(post_leaves(ours.posterior), jax.tree_util.tree_leaves(ref.posterior), strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    seeds = [0, 1, 2]
    want = np.asarray(ref.forward(x, n_samples=3, seeds=seeds))
    got = svi_predict(ours.arch, ours.posterior, torch.from_numpy(x),
                      eps=_jax_draws_as_eps(to_np(ref.posterior.loc), seeds))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    logits = np.asarray(ref.forward(x, avg_posterior=True))
    np.testing.assert_allclose(ours.forward(torch.from_numpy(x), avg_posterior=True).numpy(), logits,
                               rtol=0, atol=1e-5 * np.abs(logits).max())


@pytest.fixture
def surrogate_mnist(monkeypatch, tmp_path):
    """300 training and 64 test images of the synthetic MNIST surrogate, with
    the process's surrogate records emptied and restored (see
    ``fresh_surrogate_state`` in ``tests/test_torch_predict.py``)."""
    from robustbnns_tpu_torch.data import datasets

    monkeypatch.setenv("ROBUSTBNNS_SYNTH_CACHE", str(tmp_path))
    monkeypatch.setattr(datasets, "_surrogate_served", set())
    datasets._synthetic_image_dataset.cache_clear()
    x_train, y_train, x_test, y_test, shape, _ = datasets.load_dataset("mnist", n_inputs=300, fallback="synthetic")
    datasets._synthetic_image_dataset.cache_clear()
    return x_train, y_train, x_test[:64], y_test[:64], tuple(shape)


def seeded_input_gradients(jarch, tarch, jpost, tpost, x, y, n_samples=10):
    """∇ₓ of the attack loss (CE of the seeded predictive's probabilities,
    seeds 0..S-1) in JAX on ``jpost`` and in the port on ``tpost`` with JAX's
    draws injected."""
    from robustbnns_tpu.attacks.gradient_attacks import ce_on_outputs as jax_ce_on_outputs
    from robustbnns_tpu.predict import svi_predict as jax_svi_predict
    from robustbnns_tpu_torch.attacks.gradient_attacks import ce_on_outputs

    seeds, labels = list(range(n_samples)), y.argmax(-1)
    keys = jax_resolve_sample_keys(n_samples, None, seeds)
    jpost = jax_svi.MeanFieldPosterior(*jax.tree_util.tree_map(jnp.asarray, tuple(jpost)))
    want = jax.grad(lambda a: jnp.sum(jax_ce_on_outputs(jax_svi_predict(jarch, jpost, a, keys), labels)))(x)
    xt = torch.from_numpy(x).requires_grad_(True)
    probs = svi_predict(tarch, tpost, xt, _jax_draws_as_eps(to_np(jpost.loc), seeds))
    (got,) = torch.autograd.grad(ce_on_outputs(probs, torch.from_numpy(labels)).sum(), xt)
    return got.numpy(), np.asarray(want)


def test_trained_posterior_input_gradients_match_jax(surrogate_mnist):
    """fc2-16 trained for 5 epochs (lr 0.02, as model_7) on 300 surrogate
    images in both packages, JAX's draws replayed: the seeded 10-draw
    predictive's input gradients on 64 test images agree within 2e-3 of their
    largest entry (each on its trainer's posterior, and the two differ by
    Adam's rounding: 4.8e-4 seen), their signs, which PGD steps by, agree on
    all but 1e-3 of the pixels (6e-5 seen), and both have the same share of
    exact zeros."""
    x_train, y_train, x, y, shape = surrogate_mnist
    jarch = jax_build("fc2", "leaky", shape, CLASSES, 16)
    tarch = build_architecture("fc2", "leaky", shape, CLASSES, 16)
    post, _, post_ref, _, _ = train_both(jarch, tarch, x_train, y_train, seed=0, epochs=5, lr=0.02,
                                         batch=BATCH, acc_samples=2)
    got, want = seeded_input_gradients(jarch, tarch, post_ref, post, x, y)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * np.abs(want).max())
    assert (np.sign(got) != np.sign(want)).mean() <= 1e-3
    assert (got == 0).mean() == (want == 0).mean()


def test_saturated_posterior_input_gradients_match_jax_up_to_denormals(surrogate_mnist):
    """fc2-64 trained by JAX as above: its softmax saturates on some images.
    On that posterior the port's input gradients equal JAX's within 1e-4 of
    their largest entry (f32 chains of 784-term sums; 1.8e-5 seen), and they
    are exactly zero on the same pixels once torch flushes denormals as XLA's
    CPU backend does: without the flush an image that JAX's gradient zeroes
    whole keeps gradients near 1e-42 in the port. A saturated softmax zeroes
    the reference's input gradient (the CE-on-probabilities quirk), the
    mechanism behind PGD moving no pixel of a trained model."""
    x_train, y_train, x, y, shape = surrogate_mnist
    jarch = jax_build("fc2", "leaky", shape, CLASSES, 64)
    tarch = build_architecture("fc2", "leaky", shape, CLASSES, 64)
    _, _, post_ref, _, _ = train_both(jarch, tarch, x_train, y_train, seed=0, epochs=5, lr=0.02,
                                      batch=BATCH, acc_samples=2)
    ref_post = meanfield_from_numpy(*to_np(tuple(post_ref)))
    got, want = seeded_input_gradients(jarch, tarch, post_ref, ref_post, x, y)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    zeroed = (want == 0).reshape(len(x), -1).all(-1)
    assert zeroed.any() and np.abs(got[zeroed]).max() < 1e-37
    flushing = torch.set_flush_denormal(True)
    try:
        flushed, _ = seeded_input_gradients(jarch, tarch, post_ref, ref_post, x, y)
    finally:
        torch.set_flush_denormal(False)
    if flushing:  # the CPU supports flushing (x86 with SSE3)
        np.testing.assert_array_equal(flushed == 0, want == 0)


def test_fgsm_moves_the_pixels_jax_moves_on_the_saturated_posterior(surrogate_mnist):
    """One FGSM step on the saturated fc2-64 posterior of the test above
    (JAX's, its seeded 10-draw predictive, JAX's draws injected), without
    ``torch.set_flush_denormal``: on the images whose gradient JAX zeroes
    whole, where the port's raw gradient keeps denormals, neither package
    moves a pixel (the attack counts denormals as zero before the sign, as
    XLA's flush does); elsewhere the port moves exactly the pixels JAX's
    moves, to the same values, wherever the gradient is above f32 noise
    (1e-6 of its largest entry: below it, about 3% of the pixels here, both
    packages' signs are rounding and differ on some)."""
    from robustbnns_tpu.attacks.gradient_attacks import fgsm_attack as jax_fgsm
    from robustbnns_tpu.predict import svi_predict as jax_svi_predict
    from robustbnns_tpu_torch.attacks.gradient_attacks import fgsm_attack

    x_train, y_train, x, y, shape = surrogate_mnist
    jarch = jax_build("fc2", "leaky", shape, CLASSES, 64)
    tarch = build_architecture("fc2", "leaky", shape, CLASSES, 64)
    post_ref, _ = jax_svi.svi_train(jarch, x_train, y_train, epochs=5, lr=0.02, batch_size=BATCH, seed=0,
                                    train_acc_samples=2, verbose=False)
    seeds = list(range(10))
    keys = jax_resolve_sample_keys(10, None, seeds)
    want = np.asarray(jax_fgsm(lambda a: jax_svi_predict(jarch, post_ref, a, keys), x, y, epsilon=0.3))
    ref_post = meanfield_from_numpy(*to_np(tuple(post_ref)))
    eps = _jax_draws_as_eps(to_np(post_ref.loc), seeds)
    got = fgsm_attack(lambda a, g: svi_predict(tarch, ref_post, a, eps), torch.from_numpy(x),
                      torch.from_numpy(y), epsilon=0.3).numpy()
    raw, ref_grads = seeded_input_gradients(jarch, tarch, post_ref, ref_post, x, y)
    zeroed = (ref_grads == 0).reshape(len(x), -1).all(-1)
    assert zeroed.any() and (raw[zeroed] != 0).any()  # denormals that sign() alone would move
    np.testing.assert_array_equal(want[zeroed], x[zeroed])
    np.testing.assert_array_equal(got[zeroed], x[zeroed])
    clear = np.abs(ref_grads) > 1e-6 * np.abs(ref_grads).max()
    np.testing.assert_array_equal((got != x)[clear], (want != x)[clear])
    np.testing.assert_array_equal(got[clear], want[clear])
