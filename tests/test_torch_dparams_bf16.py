"""The port's bf16 parameter-gradient twins against the JAX package's, on the CPU.

Under ``ROBUSTBNNS_KERNEL_PRECISION=default`` the JAX package's parameter-gradient
kernels take ``dW = _dot(x.T, g)`` as a single-pass bf16 product
(``robustbnns_tpu/ops/sampled_dense.py:154``, ``:401``) and ``db = jnp.sum(g)``
in f32. The port's ``sampled_dense_dparams`` and ``sampled_dense_xs_dparams``
then run their bf16 twins on the CPU (the bf16 kernels on the card):
dW_s = bf16(x_s)ᵀ bf16(g_s) summed in f32, dbloc and dbrho from the unrounded g.

JAX's Pallas kernels in interpret mode compute f32 products whatever the
precision, so they are the reference only where both packages form the same
exact products: on bf16-valued x and g at zero scale (rho = -30, where drho and
dbrho vanish). With noise, the reference is ``jax.grad`` of the materialised
layer on bf16-valued operands with the port's own eps; on general f32 inputs
the twins are held to float64 products of the rounded operands.

Tolerances: products of bf16 values are exact in f32 in both packages, so
zero-scale results differ only in the order of <= 24-term f32 sums of O(1)
values (1e-5 absolute), gradients through the layer chain two such products
(1e-4, as ``tests/test_torch_ops.py``), and the twins against float64 differ
by f32 sums alone (1e-5 of Σ|x||g| per output). Through a whole fused network
JAX's f32 kernels and the port's bf16 twins part by the bf16 rounding of every
hidden activation and cotangent: 2⁻⁵ of the largest entry, the gate of
``chip_smoke.py``'s ``[precision]``.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustbnns_tpu.inference.svi import MeanFieldPosterior as JaxPosterior
from robustbnns_tpu.models import build_architecture as jax_build
from robustbnns_tpu.ops import sampled_dense as jax_sampled_dense
from robustbnns_tpu.ops import sampled_dense_xs as jax_sampled_dense_xs
from robustbnns_tpu.ops import svi_predict_fused as jax_svi_predict_fused
from robustbnns_tpu_torch.models.architectures import build_architecture
from robustbnns_tpu_torch.ops.fused_predict import svi_predict_fused
from robustbnns_tpu_torch.utils.checkpoint import meanfield_from_numpy
from robustbnns_tpu_torch.utils.pytree import tree_leaves

# the module, not the op of the same name that robustbnns_tpu_torch.ops exports
sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")

B, I, O, S = 8, 24, 20, 3  # O = 20: ragged against the 16-column tile
VARIANTS = ["x", "xs"]


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def bf16_round(a):
    """numpy f32 values rounded to bf16 (to nearest, ties to even), as f32."""
    return t(a).to(torch.bfloat16).float().numpy()


def layer(seed):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(B, I)).astype(np.float32),
        "loc": (rng.normal(size=(I, O)) * 0.1).astype(np.float32),
        "rho": (rng.normal(size=(I, O)) - 1.0).astype(np.float32),
        "bloc": (rng.normal(size=(O,)) * 0.1).astype(np.float32),
        "brho": (rng.normal(size=(O,)) - 1.0).astype(np.float32),
        "g": rng.normal(size=(S, B, O)).astype(np.float32),
    }


def layer_input(x, variant):
    return x if variant == "x" else np.stack([x, -0.5 * x, 2.0 * x])


def wrapper(variant):
    return sd.sampled_dense_dparams if variant == "x" else sd.sampled_dense_xs_dparams


@pytest.mark.parametrize("variant", VARIANTS)
def test_zero_scale_twins_match_jax_kernels(monkeypatch, variant):
    """bf16-valued x and g, rho = brho = -30: ``jax.vjp`` through JAX's
    interpret-mode ``sampled_dense``/``sampled_dense_xs`` under the variable
    against the port's wrapper (its bf16 twin): dloc and dbloc within 1e-5
    absolute; drho and dbrho carry σ(-30) ≈ 1e-13 and vanish in both."""
    monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "default")
    p = layer(1)
    xin, g = bf16_round(layer_input(p["x"], variant)), bf16_round(p["g"])
    neg, negb = np.full_like(p["loc"], -30.0), np.full_like(p["bloc"], -30.0)
    op = jax_sampled_dense if variant == "x" else jax_sampled_dense_xs
    _, vjp = jax.vjp(lambda *params: op(xin, *params, S, 3), p["loc"], neg, p["bloc"], negb)
    want = vjp(jnp.asarray(g))
    got = wrapper(variant)(t(g), t(xin), t(neg), t(negb), S, 3)
    for name, got_t, want_t in zip(("dloc", "drho", "dbloc", "dbrho"), got, want):
        assert got_t.shape == want_t.shape, name
        if name in ("dloc", "dbloc"):
            np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0, atol=1e-5, err_msg=name)
            assert float(got_t.abs().max()) > 1.0, name
        else:
            assert float(got_t.abs().max()) < 1e-9 and float(np.abs(np.asarray(want_t)).max()) < 1e-9, name


@pytest.mark.parametrize("variant", VARIANTS)
def test_noise_gradients_match_jax_autodiff(monkeypatch, variant):
    """With rho around -1 the noise matters: the port's autograd under the
    variable (the bf16 forward and dparams twins) against ``jax.grad`` of the
    materialised layer ``x_s @ (loc + softplus(rho)·eps_s) + (bloc +
    softplus(brho)·eps[s, I])`` on bf16-valued x and g, with the port's own eps
    injected as numpy and exact products. A bias row off by one, a permuted
    counter or a rounded bias fails here; 1e-4."""
    monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "default")
    p = layer(3)
    seed = 3
    xin, g = bf16_round(layer_input(p["x"], variant)), bf16_round(p["g"])
    eps = sd.sampled_noise(seed, S, I + 1, O, "cpu").numpy()

    def f(loc, rho, bloc, brho):
        w = loc + jax.nn.softplus(rho) * eps[:, :I]
        b = bloc + jax.nn.softplus(brho) * eps[:, I]
        return jnp.sum(g * (jnp.matmul(xin, w, precision="highest") + b[:, None, :]))

    want = jax.grad(f, argnums=(0, 1, 2, 3))(p["loc"], p["rho"], p["bloc"], p["brho"])
    op = sd.sampled_dense if variant == "x" else sd.sampled_dense_xs
    leaves = [t(p[k]).clone().requires_grad_(True) for k in ("loc", "rho", "bloc", "brho")]
    got = torch.autograd.grad((op(t(xin), *leaves, S, seed) * t(g)).sum(), leaves)
    for name, got_t, want_t in zip(("dloc", "drho", "dbloc", "dbrho"), got, want):
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-4, atol=1e-4, err_msg=name)
    assert float(np.abs(np.asarray(want[1])).max()) > 1e-2  # the noise term is exercised


@pytest.mark.parametrize("variant", VARIANTS)
def test_twins_match_float64_products_of_rounded_operands(variant):
    """On general f32 inputs: dloc = Σ_s bf16(x_s)ᵀ bf16(g_s) and drho =
    σ(rho) Σ_s (bf16(x_s)ᵀ bf16(g_s)) eps_s in float64, within 1e-5 of their
    error scales; dbloc and dbrho bit-equal to the f32 twin's; dloc and drho
    within the bf16 rounding bound (2·2⁻⁸ of their scales) of the f32 twin's,
    and away from it (the twin rounds)."""
    p = layer(4)
    seed = 99
    xin, g = layer_input(p["x"], variant), p["g"]
    args = (t(g), t(xin), t(p["rho"]), t(p["brho"]), S, seed)
    got = sd.sampled_dense_dparams_bf16_plain(*args)
    exact = sd.sampled_dense_dparams_plain(*args)
    eps = sd.sampled_noise(seed, S, I, O, "cpu").numpy().astype(np.float64)
    xr, gr = bf16_round(xin).astype(np.float64), bf16_round(g).astype(np.float64)
    dw = np.matmul(np.swapaxes(xr, -1, -2), gr)  # (S, I, O)
    sig = 1.0 / (1.0 + np.exp(-p["rho"].astype(np.float64)))
    want = (dw.sum(0), (dw * eps).sum(0) * sig)
    scales = sd.bf16_error_scale(f"{'' if variant == 'x' else 'xs_'}dparams", *args[:2], args[2], S, seed)
    for k in range(2):
        scale = scales[k].numpy()
        assert np.all(np.abs(got[k].numpy() - want[k]) <= 1e-5 * scale), k
        diff = np.abs(got[k].numpy() - exact[k].numpy())
        assert np.all(diff <= 2 * 2.0**-8 * scale + 1e-5 * scale), k
        assert diff.max() > 1e-4 * scale.max(), k  # f32 sums alone part by about 1e-7 of it
    assert torch.equal(got[2], exact[2]) and torch.equal(got[3], exact[3])


@pytest.mark.parametrize("variant", VARIANTS)
def test_error_scale_against_float64(variant):
    """``bf16_error_scale`` of the dparams kinds: Σ_s Σ_b |x_sbi||g_sbo| and
    the same terms weighted by |eps_sio|·σ(rho_io), against float64; no
    largest-term scale."""
    p = layer(5)
    xin = layer_input(p["x"], variant).astype(np.float64)
    seed = 7
    terms = np.abs(xin if xin.ndim == 3 else xin[None])[..., :, :, None] * np.abs(p["g"].astype(np.float64))[:, :, None]
    terms = terms.sum(1)  # (S, I, O)
    eps = np.abs(sd.sampled_noise(seed, S, I, O, "cpu").numpy().astype(np.float64))
    sig = 1.0 / (1.0 + np.exp(-p["rho"].astype(np.float64)))
    kind = "dparams" if variant == "x" else "xs_dparams"
    args = (kind, t(p["g"]), t(layer_input(p["x"], variant)), t(p["rho"]), S, seed)
    loc_scale, rho_scale = sd.bf16_error_scale(*args)
    np.testing.assert_allclose(loc_scale.numpy(), terms.sum(0), rtol=1e-5)
    np.testing.assert_allclose(rho_scale.numpy(), (terms * eps).sum(0) * sig, rtol=1e-5)
    with pytest.raises(ValueError):
        sd.bf16_error_scale(*args, largest=True)


@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_precision_routes_the_dparams_wrappers(monkeypatch, variant):
    """Each dparams wrapper gives its bf16 twin's result under
    ROBUSTBNNS_KERNEL_PRECISION=default (read at each call) and its f32
    twin's without, under "highest", and under ROBUSTBNNS_BF16=1 alone."""
    p = layer(6)
    args = (t(p["g"]), t(layer_input(p["x"], variant)), t(p["rho"]), t(p["brho"]), S, 8)
    f32, bf16 = sd.sampled_dense_dparams_plain(*args), sd.sampled_dense_dparams_bf16_plain(*args)
    assert not torch.equal(f32[0], bf16[0]) and not torch.equal(f32[1], bf16[1])

    def same(got, want):
        return all(torch.equal(a, b) for a, b in zip(got, want))

    monkeypatch.delenv("ROBUSTBNNS_KERNEL_PRECISION", raising=False)
    assert same(wrapper(variant)(*args), f32)
    monkeypatch.setenv("ROBUSTBNNS_BF16", "1")
    assert same(wrapper(variant)(*args), f32)
    monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "default")
    assert same(wrapper(variant)(*args), bf16)
    monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "highest")
    assert same(wrapper(variant)(*args), f32)
    monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "default")
    assert same(wrapper(variant)(*args), bf16)


@pytest.mark.parametrize("arch_name", ["fc", "fc2"])
def test_fused_posterior_gradient_matches_jax(monkeypatch, arch_name):
    """The slice end to end at zero scale (leaky, 6x6x1 inputs, hidden 32,
    S = 4): the gradient of the cross-entropy of the port's
    ``svi_predict_fused`` with respect to every posterior leaf under the
    variable, against ``jax.grad`` through the JAX package's
    ``svi_predict_fused`` under it (its interpret-mode kernels are f32): the
    loc leaves within 2⁻⁵ of their largest entry and not the port's f32
    gradient; the rho leaves vanish in both; only bf16 twins ran."""
    shape, classes, hidden, n_samples, seed = (6, 6, 1), 10, 32, 4, 21
    jarch = jax_build(arch_name, "leaky", shape, classes, hidden)
    tarch = build_architecture(arch_name, "leaky", shape, classes, hidden)
    loc = jax.tree_util.tree_map(np.asarray, jarch.init(jax.random.key(2)))
    neg = jax.tree_util.tree_map(lambda a: np.full_like(a, -30.0), loc)
    rng = np.random.default_rng(8)
    x = rng.uniform(size=(9,) + shape).astype(np.float32)
    labels = rng.integers(0, classes, size=9)

    monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "default")

    def jax_loss(lc, rh):
        probs = jax_svi_predict_fused(jarch, JaxPosterior(loc=lc, rho=rh), x, n_samples, seed)
        return -jnp.sum(jnp.log(probs[jnp.arange(9), labels]))

    want_loc, want_rho = jax.grad(jax_loss, argnums=(0, 1))(loc, neg)

    calls = []
    for name in ("fwd", "xs_fwd", "dx", "xs_dx", "dparams", "xs_dparams"):
        for suffix in ("_plain", "_bf16_plain"):
            fn = getattr(sd, f"sampled_dense_{name}{suffix}")
            monkeypatch.setattr(sd, f"sampled_dense_{name}{suffix}",
                                lambda *a, _n=name + suffix, _f=fn: calls.append(_n) or _f(*a))

    def port_grads():
        post = meanfield_from_numpy(loc, neg)
        leaves = type(post)(*(tuple({k: v.clone().requires_grad_(True) for k, v in lay.items()} for lay in tree)
                              for tree in post))
        flat = tree_leaves(leaves.loc) + tree_leaves(leaves.rho)
        probs = svi_predict_fused(tarch, leaves, t(x), n_samples, seed)
        loss = -torch.log(probs[torch.arange(9), torch.from_numpy(labels)]).sum()
        return torch.autograd.grad(loss, flat)

    got = port_grads()
    assert sorted(set(calls)) == ["dparams_bf16_plain", "fwd_bf16_plain", "xs_dparams_bf16_plain",
                                  "xs_dx_bf16_plain", "xs_fwd_bf16_plain"]
    monkeypatch.delenv("ROBUSTBNNS_KERNEL_PRECISION")
    exact = port_grads()
    n = len(tree_leaves(want_loc))
    for got_t, want_t, exact_t in zip(got[:n], tree_leaves(want_loc), exact[:n]):
        want_t = np.asarray(want_t)
        assert got_t.shape == want_t.shape
        np.testing.assert_allclose(got_t.numpy(), want_t, rtol=0, atol=2.0**-5 * np.abs(want_t).max())
    assert not all(torch.equal(a, b) for a, b in zip(got[:n], exact[:n]))
    for got_t, want_t in zip(got[n:], tree_leaves(want_rho)):
        assert float(got_t.abs().max()) < 1e-9 and float(np.abs(np.asarray(want_t)).max()) < 1e-9
