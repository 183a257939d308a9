"""The port's ``sampled_dense_reference`` against the JAX package's, and the
port's sampled-dense twins against it, on the CPU.

Inputs are built as in ``tests/test_ops.py`` (B = 16, I = 32, O = 128; rho and
brho ~ N(0, 1) - 1), from numpy. Tolerances: with JAX's draws injected, or at
zero scale, both sides are f32 products of 32-term sums, so 1e-5 absolute on
O(1) values; noise moments at S = 256 are held as ``tests/test_ops.py`` holds
the Pallas kernels on a TPU (global mean within 0.05, mean per-entry std across
samples within 5%). Here the Philox twins draw the kernels' own stream, so
this is the port's counterpart of that TPU-only test.
"""
import math

import jax
import numpy as np
import pytest
import torch

from robustbnns_tpu.ops import sampled_dense_reference as jax_reference
from robustbnns_tpu_torch.ops import sampled_dense, sampled_dense_reference, sampled_dense_xs
from robustbnns_tpu_torch.ops.sampled_dense import softplus
from robustbnns_tpu_torch.utils.prng import key_from_seed

B, I, O = 16, 32, 128
S_MOMENTS = 256


@pytest.fixture
def layer():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, I)).astype(np.float32)
    loc = (rng.normal(size=(I, O)) * 0.1).astype(np.float32)
    rho = (rng.normal(size=(I, O)) - 1.0).astype(np.float32)
    bloc = (rng.normal(size=(O,)) * 0.1).astype(np.float32)
    brho = (rng.normal(size=(O,)) - 1.0).astype(np.float32)
    return x, loc, rho, bloc, brho


def t(a):
    return torch.from_numpy(np.array(a))


def jax_draws(key, n_samples, loc_shape, bloc_shape):
    """JAX's reference's draws for ``key``, made as ``sampled_dense.py:330-336``
    makes them: ``split(key, S)``, then ``split(k)`` into kw and kb, then ``normal``."""

    def one(k):
        kw, kb = jax.random.split(k)
        return jax.random.normal(kw, loc_shape), jax.random.normal(kb, bloc_shape)

    eps_w, eps_b = jax.vmap(one)(jax.random.split(key, n_samples))
    return np.asarray(eps_w), np.asarray(eps_b)


@pytest.mark.parametrize("seed,n_samples", [(0, 1), (9, 16)])
def test_injected_draws_match_jax(layer, seed, n_samples):
    x, loc, rho, bloc, brho = layer
    key = jax.random.key(seed)
    eps_w, eps_b = jax_draws(key, n_samples, loc.shape, bloc.shape)
    ours = sampled_dense_reference(*map(t, layer), n_samples, None, eps_w=t(eps_w), eps_b=t(eps_b))
    ref = np.asarray(jax_reference(x, loc, rho, bloc, brho, n_samples, key))
    assert ours.shape == ref.shape == (n_samples, B, O)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", ["x", "xs"])
def test_zero_scale_equals_jax_and_the_twins(layer, variant):
    """rho = brho = -1e4: softplus is 0, so every draw is the dense layer
    x @ loc + bloc, in both references and in the port's Philox twin."""
    x, loc, _, bloc, _ = layer
    neg, negb = np.full_like(loc, -1e4), np.full_like(bloc, -1e4)
    n = 4
    args = (t(x), t(loc), t(neg), t(bloc), t(negb))
    ours = sampled_dense_reference(*args, n, key_from_seed(3))
    ref = np.asarray(jax_reference(x, loc, neg, bloc, negb, n, jax.random.key(3)))
    if variant == "x":
        twin = sampled_dense(*args, n, 5)
    else:
        twin = sampled_dense_xs(t(x).expand(n, B, I), *args[1:], n, 5)
    dense = x.astype(np.float64) @ loc + bloc
    for got in (ours.numpy(), ref, twin.numpy()):
        assert got.shape == (n, B, O)
        np.testing.assert_allclose(got, np.broadcast_to(dense, got.shape), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(twin.numpy(), ours.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("which", ["jax_reference", "sampled_dense", "sampled_dense_xs",
                                   "sampled_dense_bf16", "sampled_dense_xs_bf16"])
def test_noise_moments_match_the_reference(layer, which, monkeypatch):
    """The port's reference against JAX's, and the port's twins (f32, and the
    bf16 ones under ``ROBUSTBNNS_KERNEL_PRECISION=default``) against the
    port's reference, at S = 256."""
    x, loc, rho, bloc, brho = layer
    args = tuple(map(t, layer))
    ref = sampled_dense_reference(*args, S_MOMENTS, key_from_seed(9)).numpy()
    if which == "jax_reference":
        got = np.asarray(jax_reference(x, loc, rho, bloc, brho, S_MOMENTS, jax.random.key(9)))
    else:
        if which.endswith("_bf16"):
            monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "default")
        if which.startswith("sampled_dense_xs"):
            got = sampled_dense_xs(args[0].expand(S_MOMENTS, B, I), *args[1:], S_MOMENTS, 123).numpy()
        else:
            got = sampled_dense(*args, S_MOMENTS, 123).numpy()
    assert float(got.mean()) == pytest.approx(float(ref.mean()), abs=0.05)
    assert float(got.std(0).mean()) == pytest.approx(float(ref.std(0).mean()), rel=0.05)


@pytest.mark.parametrize("which", ["twin", "reference"])
def test_noise_is_standard_normal(layer, which):
    """One-hot rows of x and a bias of zero scale leave out[s, b] = loc[b] +
    bloc + softplus(rho[b])·eps[s, b]: the draws themselves, S·B·O = 2^19 of
    them. Mean, variance and the share beyond 3 lie within 5 sigma of N(0, 1)'s."""
    _, loc, rho, bloc, _ = layer
    x = torch.eye(I)[:B]
    args = (x, t(loc), t(rho), t(bloc), torch.full((O,), -1e4))
    out = sampled_dense(*args, S_MOMENTS, 77) if which == "twin" else \
        sampled_dense_reference(*args, S_MOMENTS, key_from_seed(77))
    eps = ((out - t(loc)[:B] - t(bloc)) / softplus(t(rho)[:B])).double()
    n = eps.numel()
    tail = math.erfc(3 / math.sqrt(2))  # P(|N(0, 1)| > 3)
    assert abs(float(eps.mean())) <= 5 / math.sqrt(n)
    assert abs(float(eps.var()) - 1) <= 5 * math.sqrt(2 / n)
    assert abs(float((eps.abs() > 3).double().mean()) - tail) <= 5 * math.sqrt(tail * (1 - tail) / n)


def test_generators_and_devices(layer):
    """One generator seed gives one draw and another seed another; the output
    lies on x's device in x's dtype; given noise of the wrong shape is refused."""
    args = tuple(map(t, layer))
    a = sampled_dense_reference(*args, 3, key_from_seed(1))
    b = sampled_dense_reference(*args, 3, key_from_seed(1))
    c = sampled_dense_reference(*args, 3, key_from_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])
    assert a.device == args[0].device and a.dtype == torch.float32 and a.shape == (3, B, O)
    eps_w = torch.randn((3, I, O), generator=key_from_seed(4))
    d = sampled_dense_reference(*args, 3, key_from_seed(1), eps_w=eps_w)
    e = sampled_dense_reference(*args, 3, key_from_seed(1), eps_w=eps_w)
    assert torch.equal(d, e) and not torch.equal(d, a)
    with pytest.raises(ValueError, match="expected"):
        sampled_dense_reference(*args, 3, key_from_seed(1), eps_b=torch.zeros(2, O))
