"""The port's FGSM/PGD and robustness measures against the JAX package's.

At zero posterior scale (rho = -30, softplus ~ 1e-13) every draw is the
variational mean, so both packages attack the same deterministic network and
must produce the same adversarial images, whatever their noise streams. The
only allowed differences are sign flips of input-gradient entries whose
magnitude is at f32 rounding level (below 1e-4 of the largest entry): those are
counted and bounded. The JAX fused path runs its Pallas kernels in interpret
mode, which costs seconds per PGD step, so the fused PGD comparison takes 3
steps and the 40-step comparison uses the unfused predictive.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustbnns_tpu.attacks import gradient_attacks as jax_attacks
from robustbnns_tpu.attacks import measures as jax_measures
from robustbnns_tpu.inference.svi import MeanFieldPosterior as JaxPosterior
from robustbnns_tpu.models import build_architecture as jax_build
from robustbnns_tpu.ops import fused_predictive_fn as jax_fused_fn
from robustbnns_tpu.predict import svi_predict as jax_svi_predict
from robustbnns_tpu_torch.attacks import gradient_attacks as attacks
from robustbnns_tpu_torch.attacks import measures
from robustbnns_tpu_torch.models.architectures import build_architecture
from robustbnns_tpu_torch.ops.fused_predict import fused_predictive_fn
from robustbnns_tpu_torch.predict import sample_eps, svi_predict
from robustbnns_tpu_torch.utils.checkpoint import meanfield_from_numpy

SHAPE, CLASSES, HIDDEN, N, S = (6, 6, 1), 10, 32, 12, 3


@pytest.fixture(scope="module")
def zero_scale():
    """An fc2 network with a zero-scale posterior in both packages, and a batch."""
    jarch = jax_build("fc2", "leaky", SHAPE, CLASSES, HIDDEN)
    tarch = build_architecture("fc2", "leaky", SHAPE, CLASSES, HIDDEN)
    loc = jax.tree_util.tree_map(np.asarray, jarch.init(jax.random.key(0)))
    neg = jax.tree_util.tree_map(lambda p: np.full_like(p, -30.0), loc)
    rng = np.random.default_rng(3)
    x = rng.uniform(size=(N,) + SHAPE).astype(np.float32)
    y = rng.integers(0, CLASSES, N)
    return jarch, tarch, JaxPosterior(loc, neg), meanfield_from_numpy(loc, neg), x, y


def forwards(zero_scale, fused):
    jarch, tarch, jpost, tpost, _, _ = zero_scale
    if fused:
        return jax_fused_fn(jarch, jpost, S), fused_predictive_fn(tarch, tpost, S)

    def jax_fn(x, key):
        return jax_svi_predict(jarch, jpost, x, jax.random.split(key, S))

    def torch_fn(x, generator):
        return svi_predict(tarch, tpost, x, sample_eps(tpost.loc, S, generator=generator))

    return jax_fn, torch_fn


def input_gradient(zero_scale, x):
    jarch, _, jpost, _, _, y = zero_scale
    f = lambda a: jnp.sum(jax_attacks.ce_on_outputs(jax.nn.softmax(jarch.apply(jpost.loc, a), -1), y))  # noqa: E731
    return np.asarray(jax.grad(f)(x))


def test_ce_on_outputs_matches_jax():
    rng = np.random.default_rng(0)
    out = rng.uniform(size=(7, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 7)
    ours = attacks.ce_on_outputs(torch.from_numpy(out), torch.from_numpy(labels))
    ref = jax_attacks.ce_on_outputs(jnp.asarray(out), jnp.asarray(labels))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("renormalize", [True, False])
def test_softmax_robustness_matches_jax(renormalize):
    rng = np.random.default_rng(1)
    a = rng.dirichlet(np.ones(10), 20).astype(np.float32)
    b = rng.dirichlet(np.ones(10), 20).astype(np.float32)
    ours = measures.softmax_robustness(torch.from_numpy(a), torch.from_numpy(b), renormalize=renormalize, verbose=False)
    ref = jax_measures.softmax_robustness(a, b, renormalize=renormalize, verbose=False)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-7)
    with pytest.raises(ValueError):
        measures.softmax_difference(torch.from_numpy(a), torch.from_numpy(b[:3]))
    with pytest.raises(ValueError):
        measures.check_softmax_difference_range(torch.tensor([1.5]))


@pytest.mark.parametrize("fused", [True, False])
def test_fgsm_matches_jax_at_zero_scale(zero_scale, fused):
    _, _, _, _, x, y = zero_scale
    jax_fn, torch_fn = forwards(zero_scale, fused)
    ref = np.asarray(jax_attacks.fgsm_attack(jax_fn, x, y, epsilon=0.3, key=jax.random.key(1)))
    ours = attacks.fgsm_attack(torch_fn, torch.from_numpy(x), torch.from_numpy(y), epsilon=0.3).numpy()
    differ = np.abs(ours - ref) > 1e-6
    grad = input_gradient(zero_scale, x)
    assert differ.mean() <= 0.01
    assert np.all(np.abs(grad[differ]) <= 1e-4 * np.abs(grad).max())
    assert np.abs(ours - x).max() <= 0.3 + 1e-6 and ours.min() >= 0 and ours.max() <= 1


@pytest.mark.parametrize("fused,iters", [(True, 3), (False, 40)])
def test_pgd_matches_jax_at_zero_scale(zero_scale, fused, iters):
    _, _, _, _, x, y = zero_scale
    jax_fn, torch_fn = forwards(zero_scale, fused)
    ref = np.asarray(jax_attacks.pgd_attack(jax_fn, x, y, epsilon=0.3, iters=iters, key=jax.random.key(1)))
    ours = attacks.pgd_attack(torch_fn, torch.from_numpy(x), torch.from_numpy(y), epsilon=0.3, iters=iters).numpy()
    assert (np.abs(ours - ref) > 1e-6).mean() <= 0.02
    assert np.abs(ours - x).max() <= 0.3 + 1e-6 and ours.min() >= 0 and ours.max() <= 1


def test_pgd_default_hyperparameters_match_jax(zero_scale):
    """``epsilon=None`` selects the reference's (0.5, 2/225) defaults in both."""
    _, _, _, _, x, y = zero_scale
    jax_fn, torch_fn = forwards(zero_scale, False)
    ref = np.asarray(jax_attacks.pgd_attack(jax_fn, x, y, epsilon=None, iters=5, key=jax.random.key(1)))
    ours = attacks.pgd_attack(torch_fn, torch.from_numpy(x), torch.from_numpy(y), epsilon=None, iters=5).numpy()
    assert (np.abs(ours - ref) > 1e-6).mean() <= 0.02


def test_fresh_draws_change_the_attack():
    """With a real posterior scale, the generator picks the draws: the same
    generator state repeats the attack, another seed does not."""
    tarch = build_architecture("fc", "leaky", SHAPE, CLASSES, HIDDEN)
    rng = np.random.default_rng(5)
    loc = tuple({k: (rng.normal(size=v.shape) * 0.3).astype(np.float32) for k, v in p.items()}
                for p in tarch.init(torch.Generator().manual_seed(0)))
    rho = tuple({k: np.zeros_like(v) for k, v in p.items()} for p in loc)
    fn = fused_predictive_fn(tarch, meanfield_from_numpy(loc, rho), S)
    x = torch.from_numpy(rng.uniform(size=(N,) + SHAPE).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, CLASSES, N))
    run = lambda seed: attacks.fgsm_attack(fn, x, y, generator=torch.Generator().manual_seed(seed))  # noqa: E731
    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))


def test_attack_files_use_the_jax_names(tmp_path):
    x_adv = torch.rand(3, 2, 2, 1)
    for n_samples in (None, 10):
        path = attacks.save_attack(x_adv, method="pgd", filename="m", n_samples=n_samples, rel_path=str(tmp_path))
        assert path == jax_attacks._attack_path("pgd", "m", None, n_samples, str(tmp_path))
        assert os.path.exists(path)
        loaded = attacks.load_attack(method="pgd", filename="m", n_samples=n_samples, rel_path=str(tmp_path))
        assert torch.equal(loaded, x_adv)
        ref = jax_attacks.load_attack(method="pgd", filename="m", n_samples=n_samples, rel_path=str(tmp_path))
        np.testing.assert_array_equal(np.asarray(ref), x_adv.numpy())
