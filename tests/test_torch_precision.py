"""The port's bf16 opt-ins against the JAX package's, on the CPU.

* ``ROBUSTBNNS_BF16=1``: dense layers take bf16 operands with f32 sums and an
  f32 result, convs run wholly in bf16 (``models/architectures.py``), held to
  JAX's ``_dense``/``_conv2d_valid`` and ``svi_predict`` under the same
  variable (read by JAX while it traces, so each JAX function here is traced
  after ``monkeypatch.setenv``).
* ``ROBUSTBNNS_KERNEL_PRECISION=default``: the four bf16 twins of the fused
  ops. JAX's Pallas kernels in interpret mode on the CPU compute f32 products
  whatever the precision, so they are the reference only on inputs that are
  bf16 values at zero scale, where both packages form exact products; with
  noise the twins are held to a float64 formula on the rounded operands.
* MCMC ``precision="default"``: the port's sampler opens ``bf16_scope`` around
  each evaluation; JAX's ``"default"`` is f32 on the CPU, so the reference is
  JAX under ``ROBUSTBNNS_BF16=1``, whose dense layers then take bf16 operands.

Tolerances. Products of bf16 values are exact in f32 in both packages, so a
dense layer differs only in the order of its f32 sums: 1e-5 of Σ|x||w| per
output. Where f32 values are rounded to bf16 again after a first layer (hidden
activations, W_s rebuilt from recovered noise, a conv's bf16 output, the
backward's bf16 gradients), the two packages' f32 values differ in their last
bits and a few of them land on the other bf16 neighbour (one bf16 ulp, 2⁻⁷
relative): such results are held to 2⁻⁷ of their largest entry. MCMC results
keep the f32 tolerances of ``tests/test_torch_hmc.py``, widened where noted,
after every decision's margin is asserted.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hmc import Problem, assert_margins, close, t
from test_torch_nuts import Fc2Problem, JaxDraws
from test_torch_nuts import assert_margins as assert_nuts_margins

from robustbnns_tpu.inference import hmc as jhmc
from robustbnns_tpu.inference import nuts as jnuts
from robustbnns_tpu.inference.svi import MeanFieldPosterior as JaxPosterior
from robustbnns_tpu.inference.svi import sample_meanfield as jax_sample_meanfield
from robustbnns_tpu.models import architectures as jax_architectures
from robustbnns_tpu.models import build_architecture as jax_build
from robustbnns_tpu.ops import sampled_dense as jax_sampled_dense
from robustbnns_tpu.ops import sampled_dense_xs as jax_sampled_dense_xs
from robustbnns_tpu.predict import svi_predict as jax_svi_predict
from robustbnns_tpu_torch.inference import hmc, nuts
from robustbnns_tpu_torch.models import architectures
from robustbnns_tpu_torch.models.architectures import build_architecture
from robustbnns_tpu_torch.ops.fused_predict import svi_predict_fused
from robustbnns_tpu_torch.predict import svi_predict
from robustbnns_tpu_torch.utils.checkpoint import meanfield_from_numpy
from robustbnns_tpu_torch.utils.device import bf16_products, bf16_scope

sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")

BF16_OF_MAX = 2.0**-7  # one bf16 ulp, relative


def bf16_round(a):
    """numpy f32 values rounded to bf16 (to nearest, ties to even), as f32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def of_max(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def assert_nearer(got, want, other):
    """``got`` is within a tenth of the distance from ``want`` that ``other``
    (the exact f32 result) is: the bf16 arithmetic, not a looser f32 match."""
    err = lambda a: float(np.abs(np.asarray(a, np.float64) - np.asarray(want, np.float64)).max())  # noqa: E731
    assert err(got) < 0.1 * err(other), (err(got), err(other))


@pytest.fixture
def bf16_env(monkeypatch):
    monkeypatch.setenv("ROBUSTBNNS_BF16", "1")


def test_the_switch_reads_the_variable_per_call_and_the_scope(monkeypatch):
    monkeypatch.delenv("ROBUSTBNNS_BF16", raising=False)
    assert not bf16_products()
    with bf16_scope():
        assert bf16_products()
        with bf16_scope(False):
            assert bf16_products()
    assert not bf16_products()
    monkeypatch.setenv("ROBUSTBNNS_BF16", "1")
    assert bf16_products()
    monkeypatch.setenv("ROBUSTBNNS_BF16", "0")
    assert not bf16_products()
    with pytest.raises(RuntimeError):
        with bf16_scope():
            raise RuntimeError("the scope closes on an error")
    assert not bf16_products()
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("stacked", [False, True], ids=["shared", "stacked"])
def test_dense_and_its_gradients_match_jax(bf16_env, stacked):
    """JAX ``_dense`` (vmapped over draws when stacked) against the port's: the
    output within 1e-5 of Σ|x||w|, the input and weight gradients within 2⁻⁷
    of their largest entry; and the result is not the f32 one."""
    rng = np.random.default_rng(3)
    b, i, o, s = 6, 40, 12, 3
    x = rng.normal(size=(b, i)).astype(np.float32)
    lead = (s,) if stacked else ()
    w = rng.normal(size=lead + (i, o)).astype(np.float32)
    bias = rng.normal(size=lead + (o,)).astype(np.float32)
    g = rng.normal(size=lead + (b, o)).astype(np.float32)

    def jax_dense(xa, wa):
        if stacked:
            return jax.vmap(lambda ws, bs: jax_architectures._dense(xa, {"w": ws, "b": bs}))(wa, bias)
        return jax_architectures._dense(xa, {"w": wa, "b": bias})

    want = np.asarray(jax_dense(x, w))
    want_gx, want_gw = jax.grad(lambda xa, wa: jnp.sum(jax_dense(xa, wa) * g), argnums=(0, 1))(x, w)
    tx, tw = t(x).requires_grad_(True), t(w).requires_grad_(True)
    got = architectures._dense(tx, {"w": tw, "b": t(bias)})
    (got * t(g)).sum().backward()
    scale = np.abs(x) @ np.abs(w)
    assert np.all(np.abs(got.detach().numpy() - want) <= 1e-5 * scale)
    of_max(tx.grad, want_gx, BF16_OF_MAX)
    of_max(tw.grad, want_gw, BF16_OF_MAX)
    exact = x @ w.astype(np.float64) + bias[..., None, :]
    assert np.abs(got.detach().numpy() - exact).max() > 1e-4 * scale.max()
    gx32 = (g @ np.swapaxes(w, -1, -2).astype(np.float64)).sum(0) if stacked else g @ w.T.astype(np.float64)
    assert_nearer(tx.grad, want_gx, gx32)


def conv_nets():
    jarch = jax_build("conv", "leaky", (28, 28, 1), 10, 16, "mnist")
    tarch = build_architecture("conv", "leaky", (28, 28, 1), 10, 16, "mnist")
    params = jax.tree_util.tree_map(np.asarray, jarch.init(jax.random.key(4)))
    x = np.random.default_rng(5).uniform(size=(3, 28, 28, 1)).astype(np.float32)
    return jarch, tarch, params, x


def test_conv_logits_and_input_gradient_match_jax(bf16_env):
    """conv-16 on three MNIST-shaped images: JAX's bf16 convs (output rounded
    to bf16, then the f32 bias) and bf16 dense head against the port's, logits
    and the input gradient of their sum of squares within 2⁻⁷ of max; and the
    logits are not the f32 ones."""
    jarch, tarch, params, x = conv_nets()
    want = np.asarray(jarch.apply(params, x))
    want_g = jax.grad(lambda a: jnp.sum(jarch.apply(params, a) ** 2))(x)
    tparams = tuple({k: t(v) for k, v in layer.items()} for layer in params)
    tx = t(x).requires_grad_(True)
    got = tarch.apply(tparams, tx)
    (got**2).sum().backward()
    of_max(got.detach(), want, BF16_OF_MAX)
    of_max(tx.grad, want_g, BF16_OF_MAX)
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.delenv("ROBUSTBNNS_BF16")
        exact = tarch.apply(tparams, t(x))
    assert_nearer(got.detach(), want, exact)


@pytest.mark.parametrize("arch", ["fc", "fc2"])
def test_svi_predict_matches_jax(bf16_env, arch):
    """JAX's ``svi_predict`` under ROBUSTBNNS_BF16=1 against the port's on
    JAX's own draws (eps recovered as (w − loc)/softplus(rho)): probabilities
    within 2⁻⁷ of max."""
    shape, classes, hidden = (6, 6, 1), 10, 32
    jarch = jax_build(arch, "leaky", shape, classes, hidden)
    tarch = build_architecture(arch, "leaky", shape, classes, hidden)
    loc = jax.tree_util.tree_map(np.asarray, jarch.init(jax.random.key(0)))
    rng = np.random.default_rng(1)
    rho = jax.tree_util.tree_map(lambda p: (rng.normal(size=p.shape) - 3.0).astype(np.float32), loc)
    x = rng.uniform(size=(9,) + shape).astype(np.float32)
    jpost = JaxPosterior(loc=loc, rho=rho)
    keys = jax.random.split(jax.random.key(11), 5)
    want = np.asarray(jax_svi_predict(jarch, jpost, x, keys))
    eps = [jax.tree_util.tree_map(lambda w, m, r: (w - m) / jax.nn.softplus(r), jax_sample_meanfield(jpost, k), loc, rho)
           for k in keys]
    stacked = jax.tree_util.tree_map(lambda *e: np.stack([np.asarray(a) for a in e]), *eps)
    teps = tuple({k: torch.tensor(np.asarray(v)) for k, v in layer.items()} for layer in stacked)
    got = svi_predict(tarch, meanfield_from_numpy(loc, rho), torch.from_numpy(x), eps=teps)
    of_max(got, want, BF16_OF_MAX)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("ROBUSTBNNS_BF16")
        exact = svi_predict(tarch, meanfield_from_numpy(loc, rho), torch.from_numpy(x), eps=teps)
    assert_nearer(got, want, exact)


def layer(seed=0, b=8, i=24, o=20):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(b, i)).astype(np.float32),
        "loc": (rng.normal(size=(i, o)) * 0.1).astype(np.float32),
        "rho": (rng.normal(size=(i, o)) - 1.0).astype(np.float32),
        "bloc": (rng.normal(size=(o,)) * 0.1).astype(np.float32),
        "brho": (rng.normal(size=(o,)) - 1.0).astype(np.float32),
    }


KINDS = ["fwd", "xs_fwd", "dx", "xs_dx"]
S = 3


def port_op(kind):
    return getattr(sd, f"sampled_dense_{kind}")


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_twins_match_jax_kernels_at_zero_scale(monkeypatch, kind):
    """bf16-valued x (or g), loc and bloc, rho = -30: W_s is loc to the bit in
    both packages, so JAX's interpret-mode kernel under
    ROBUSTBNNS_KERNEL_PRECISION=default and the port's bf16 twin form the same
    exact products (1e-5 absolute on O(1) sums)."""
    monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "default")
    p = {k: bf16_round(v) for k, v in layer(1).items()}
    neg, negb = np.full_like(p["loc"], -30.0), np.full_like(p["bloc"], -30.0)
    rng = np.random.default_rng(2)
    x = p["x"] if kind in ("fwd", "dx") else bf16_round(np.stack([p["x"], -0.5 * p["x"], 2 * p["x"]]))
    g = bf16_round(rng.normal(size=(S, 8, 20)))
    op = jax_sampled_dense if kind in ("fwd", "dx") else jax_sampled_dense_xs
    args = (p["loc"], neg, p["bloc"], negb, S, 0)
    if kind.endswith("fwd"):
        want = op(x, *args)
        got = port_op(kind)(t(x), *(t(a) for a in args[:4]), S, 0)
    else:
        _, vjp = jax.vjp(lambda a: op(a, *args), x)
        want = vjp(jnp.asarray(g))[0]
        got = port_op(kind)(t(g), t(p["loc"]), t(neg), S, 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_twins_match_float64_with_noise(kind):
    """With noise: each twin equals float64 products of bf16(x or g) and
    bf16(W_s), W_s the f32 draw from the kernels' Philox noise, within 1e-5
    of Σ|x||W_s| (the f32 sum of exact products); the bias in f32. The f32
    twin is further away than that (the twin rounds)."""
    p = layer(3)
    rng = np.random.default_rng(4)
    x = p["x"] if kind == "fwd" else np.stack([p["x"], -p["x"], 0.5 * p["x"]])
    g = rng.normal(size=(S, 8, 20)).astype(np.float32)
    seed = 99
    w32, b32 = (a.numpy() for a in sd.sampled_weights(t(p["loc"]), t(p["rho"]), t(p["bloc"]), t(p["brho"]), S, seed))
    wr = bf16_round(w32).astype(np.float64)
    params = tuple(t(p[k]) for k in ("loc", "rho", "bloc", "brho"))
    if kind.endswith("fwd"):
        a = x
        got = getattr(sd, f"sampled_dense_{kind}_bf16_plain")(t(x), *params, S, seed).numpy()
        exact = getattr(sd, f"sampled_dense_{kind}_plain")(t(x), *params, S, seed).numpy()
        want = np.matmul(bf16_round(x).astype(np.float64), wr) + b32[:, None, :]
    else:
        a = g
        got = getattr(sd, f"sampled_dense_{kind}_bf16_plain")(t(g), *params[:2], S, seed).numpy()
        exact = getattr(sd, f"sampled_dense_{kind}_plain")(t(g), *params[:2], S, seed).numpy()
        want = np.matmul(bf16_round(g).astype(np.float64), wr.transpose(0, 2, 1))
        if kind == "dx":
            want = want.sum(0)
    scale = sd.bf16_error_scale(kind, t(a), params[0], params[1], S, seed).numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * scale)
    assert np.all(np.abs(got - exact) <= 2 * 2.0**-8 * scale + 1e-5 * scale)
    assert np.abs(got - exact).max() > 1e-3 * scale.max()


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_error_scale_sums_and_largest_terms(kind):
    """The scales of the bf16 gates, per output: Σ|a||W_s| over the
    contraction and, with ``largest``, its largest single term, against
    float64 (300 rows: the largest term is taken 256 rows at a time)."""
    p = layer(5, b=300)
    rng = np.random.default_rng(6)
    a = p["x"] if kind == "fwd" else (rng.normal(size=(S, 300, 24 if kind == "xs_fwd" else 20)).astype(np.float32))
    seed = 7
    w = np.abs(sd._sampled_w(t(p["loc"]), t(p["rho"]), S, seed).numpy().astype(np.float64))
    terms = np.abs(a.astype(np.float64))
    if kind.endswith("fwd"):  # (S, B, I, O): |a_bi| |W_sio|
        terms = (terms[None] if terms.ndim == 2 else terms)[..., None] * w[:, None]
        want_sum, want_max = terms.sum(2), terms.max(2)
    else:  # (S, B, I, O): |g_sbo| |W_sio|
        terms = terms[:, :, None, :] * w[:, None]
        want_sum, want_max = terms.sum(3), terms.max(3)
        if kind == "dx":
            want_sum, want_max = want_sum.sum(0), want_max.max(0)
    args = (t(a), t(p["loc"]), t(p["rho"]), S, seed)
    np.testing.assert_allclose(sd.bf16_error_scale(kind, *args).numpy(), want_sum, rtol=1e-5)
    np.testing.assert_allclose(sd.bf16_error_scale(kind, *args, largest=True).numpy(), want_max, rtol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_precision_routes_to_the_bf16_twins(monkeypatch, kind):
    """Each public wrapper gives its bf16 twin's result under
    ROBUSTBNNS_KERNEL_PRECISION=default (read at each call) and its f32
    twin's without; ROBUSTBNNS_BF16 alone changes nothing."""
    p = layer(5)
    params = tuple(t(p[k]) for k in ("loc", "rho", "bloc", "brho"))
    a = t(p["x"]) if kind == "fwd" else (t(np.stack([p["x"]] * S)) if kind == "xs_fwd" else
                                          t(np.random.default_rng(6).normal(size=(S, 8, 20)).astype(np.float32)))
    rest = params if kind.endswith("fwd") else params[:2]
    f32 = getattr(sd, f"sampled_dense_{kind}_plain")(a, *rest, S, 8)
    bf16 = getattr(sd, f"sampled_dense_{kind}_bf16_plain")(a, *rest, S, 8)
    monkeypatch.setenv("ROBUSTBNNS_BF16", "1")
    assert torch.equal(port_op(kind)(a, *rest, S, 8), f32)
    monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "default")
    assert torch.equal(port_op(kind)(a, *rest, S, 8), bf16)
    monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "highest")
    assert torch.equal(port_op(kind)(a, *rest, S, 8), f32)


def test_fused_predictive_follows_the_kernel_precision_only(monkeypatch):
    """The fused fc2 predictive: ROBUSTBNNS_BF16 leaves it on the f32 twins
    (JAX's kernels read only ROBUSTBNNS_KERNEL_PRECISION); under
    ROBUSTBNNS_KERNEL_PRECISION=default it runs the bf16 twins, its input
    gradient too, and its parameter gradient raises instead of running the
    f32 parameter-gradient twin."""
    arch = build_architecture("fc2", "leaky", (6, 6, 1), 10, 32)
    rng = np.random.default_rng(7)
    loc = tuple({k: (rng.normal(size=v.shape) * 0.2).astype(np.float32) for k, v in layer.items()}
                for layer in arch.init(torch.Generator().manual_seed(0)))
    rho = tuple({k: (rng.normal(size=v.shape) - 3.0).astype(np.float32) for k, v in layer.items()} for layer in loc)
    post = meanfield_from_numpy(loc, rho)
    x = t(rng.uniform(size=(5, 6, 6, 1)))
    calls = []
    for name in ("fwd", "xs_fwd", "dx", "xs_dx"):
        for suffix in ("_plain", "_bf16_plain"):
            fn = getattr(sd, f"sampled_dense_{name}{suffix}")
            monkeypatch.setattr(sd, f"sampled_dense_{name}{suffix}",
                                lambda *a, _n=name + suffix, _f=fn: calls.append(_n) or _f(*a))
    exact = svi_predict_fused(arch, post, x, 4, seed=3)
    monkeypatch.setenv("ROBUSTBNNS_BF16", "1")
    assert torch.equal(svi_predict_fused(arch, post, x, 4, seed=3), exact)
    assert all(not c.endswith("_bf16_plain") for c in calls)
    calls.clear()
    monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "default")
    xr = x.clone().requires_grad_(True)
    low = svi_predict_fused(arch, post, xr, 4, seed=3)
    low[:, 0].sum().backward()
    assert sorted(set(calls)) == ["dx_bf16_plain", "fwd_bf16_plain", "xs_dx_bf16_plain", "xs_fwd_bf16_plain"]
    assert torch.isfinite(xr.grad).all() and not torch.equal(low.detach(), exact)
    of_max(low.detach(), exact, 2.0**-5)
    leaves = post.loc[0]["w"].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        sd.sampled_dense(x.reshape(5, -1), leaves, post.rho[0]["w"], post.loc[0]["b"], post.rho[0]["b"],
                         4, 3).sum().backward()


def test_hmc_potential_and_gradient_match_jax_bf16(bf16_env):
    """fc-16 on 32 points: U and ∇U of the port's evaluation under
    precision='default' (the bf16 scope) against JAX's potential under
    ROBUSTBNNS_BF16=1; U within 1e-5 relative, ∇U within 2⁻⁷ of max, and
    both away from the exact f32 values."""
    prob = Problem(32)
    want_u, want_g = jax.value_and_grad(prob.jax_nullary())(jnp.asarray(prob.q0))
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("ROBUSTBNNS_BF16")
        u, g = hmc._Potential(prob.torch_nullary(), bf16=True)(t(prob.q0))
        u32, g32 = hmc._Potential(prob.torch_nullary())(t(prob.q0))
    np.testing.assert_allclose(float(u), float(want_u), rtol=1e-5)
    of_max(g, want_g, BF16_OF_MAX)
    assert abs(float(u - u32)) > 1e-5 * abs(float(u32))
    assert_nearer(g, want_g, g32)


@pytest.mark.parametrize("eps,seed", [(0.01, 3), (0.05, 4)])
def test_hmc_transition_matches_jax_bf16(monkeypatch, eps, seed):
    """One 5-step transition from JAX's draws: JAX's ``_hmc_transition`` under
    ROBUSTBNNS_BF16=1 against the port's with precision='default''s scope
    (the variable unset), after the decision's margin: q within 1e-5 of max
    and the accept probability within 1e-6·|H0|, as in the f32 test, and q
    nearer JAX's than the port's exact f32 transition is."""
    prob = Problem(32)
    rng = np.random.default_rng(seed)
    inv_mass = rng.uniform(0.5, 1.5, prob.d).astype(np.float32)
    key = jax.random.key(seed)
    monkeypatch.setenv("ROBUSTBNNS_BF16", "1")
    jq, jap = jhmc._hmc_transition(prob.jax_nullary(), 5)(jnp.asarray(prob.q0), key, eps, jnp.asarray(inv_mass))
    h0 = float(prob.jax_nullary()(jnp.asarray(prob.q0)))
    monkeypatch.delenv("ROBUSTBNNS_BF16")
    k_mom, k_acc = jax.random.split(key)
    z, u = jax.random.normal(k_mom, (prob.d,), jnp.float32), jax.random.uniform(k_acc)
    trace = []
    vg = hmc._Potential(prob.torch_nullary(), bf16=True)
    tq, tap = hmc._hmc_transition(vg, t(prob.q0), torch.tensor(eps), t(inv_mass), 5, t(z), t(u), trace)
    assert_margins(trace)
    close(tq, jq, rtol=1e-5)
    h0 += 0.5 * float(jnp.sum(z * z / inv_mass))
    np.testing.assert_allclose(float(tap), float(jap), rtol=0, atol=1e-6 * abs(h0))
    exact, _ = hmc._hmc_transition(hmc._Potential(prob.torch_nullary()), t(prob.q0), torch.tensor(eps),
                                   t(inv_mass), 5, t(z), t(u))
    assert_nearer(tq, jq, exact)


def test_hmc_and_nuts_sample_under_precision_default():
    """precision='default' runs both samplers (warmup and draws) with every
    evaluation in the bf16 scope, and nowhere else; the samples are finite and
    differ from the exact run from the same seed; the configs never default
    to it."""
    prob = Problem(32)
    seen = []
    pot = prob.torch_nullary()

    def watched(q):
        seen.append(bf16_products())
        return pot(q)

    for sample, config in ((hmc.hmc_sample, hmc.HMCConfig(num_samples=3, warmup=4, num_steps=3)),
                           (nuts.nuts_sample, nuts.NUTSConfig(num_samples=2, warmup=0, max_depth=4))):
        assert config.precision != "default"
        exact, _ = sample(pot, t(prob.q0), 0, config)
        seen.clear()
        low, info = sample(watched, t(prob.q0), 0, config._replace(precision="default"))
        assert seen and all(seen) and not bf16_products()
        assert low.shape == exact.shape and bool(torch.isfinite(low).all())
        assert info.evaluations == len(seen) and not torch.equal(low, exact)


def test_nuts_transition_matches_jax_bf16(monkeypatch):
    """fc2-16 (D = 627): successive NUTS transitions from JAX's keys, JAX's
    flat ``_nuts_transition`` traced under ROBUSTBNNS_BF16=1 against the
    port's in the bf16 scope, after every decision's margin: the same leaf
    counts and divergences, q within 1e-4 of max (as the f32 test holds
    fc2-16) and, where the exact f32 transition from the same q ends
    elsewhere, nearer JAX's than that."""
    fc2 = Fc2Problem()
    inv_mass = np.random.default_rng(7).uniform(0.5, 1.5, fc2.d).astype(np.float32)
    monkeypatch.setenv("ROBUSTBNNS_BF16", "1")
    flat = jax.jit(jnuts._nuts_transition(lambda q: fc2.jax(q), 5))
    jq, q = jnp.asarray(fc2.q0), t(fc2.q0)
    vg, vg32 = hmc._Potential(fc2.torch, bf16=True), hmc._Potential(fc2.torch)
    moved = 0
    for s in range(4):
        key = jax.random.key(500 + s)
        want = flat(jq, key, 0.2, jnp.asarray(inv_mass))
        monkeypatch.delenv("ROBUSTBNNS_BF16")
        trace = []
        exact = nuts._nuts_transition(vg32, q, torch.tensor(0.2), t(inv_mass), 5, JaxDraws(fc2.d, [key]))[0]
        q, acc, n_leaves, div = nuts._nuts_transition(vg, q, torch.tensor(0.2), t(inv_mass), 5,
                                                      JaxDraws(fc2.d, [key]), trace)
        monkeypatch.setenv("ROBUSTBNNS_BF16", "1")
        assert_nuts_margins(trace)
        assert n_leaves == int(want[2]) and bool(div) == bool(want[3])
        close(q, want[0], of_max=1e-4)
        np.testing.assert_allclose(float(acc), float(want[1]), rtol=0, atol=1e-5)
        if float((exact - t(want[0])).abs().max()) > 1e-6 * float(np.abs(want[0]).max()):
            assert_nearer(q, want[0], exact)
            moved += 1
        jq = want[0]
    assert moved >= 2  # transitions where bf16 and f32 part


def test_finite_difference_adjoint_of_the_bf16_ops():
    """The bf16 dx is bf16(g)·bf16(W)ᵀ, not the exact adjoint of the rounded
    forward: ⟨dx, v⟩ against ⟨g, (f(x+hv) − f(x−hv))/2h⟩ in float64 products
    of the twins' own bf16 operands is off by the rounding of g, within
    2⁻⁵ relative (the gate of chip_smoke's [precision]), where the f32 ops'
    adjoint is exact to 1e-4."""
    p = layer(8, b=16, i=64, o=48)
    params = tuple(t(p[k]) for k in ("loc", "rho", "bloc", "brho"))
    rng = np.random.default_rng(9)
    x, v = t(p["x"]), t(rng.normal(size=p["x"].shape))
    g = t(rng.normal(size=(S, 16, 48)))
    errs = {}
    for name, fwd, dx in (("f32", sd.sampled_dense_fwd_plain, sd.sampled_dense_dx_plain),
                          ("bf16", sd.sampled_dense_fwd_bf16_plain, sd.sampled_dense_dx_bf16_plain)):
        h = 1e-2 if name == "f32" else 0.5  # bf16 steps below one ulp of x change nothing
        f = lambda a: fwd(a, *params, S, 1).double()  # noqa: E731
        fd = float((g.double() * (f(x + h * v) - f(x - h * v)) / (2 * h)).sum())
        ad = float((dx(g, params[0], params[1], S, 1).double() * v.double()).sum())
        errs[name] = abs(ad - fd) / abs(fd)
    assert errs["f32"] < 1e-4 and math.isfinite(errs["bf16"]) and errs["bf16"] < 2.0**-5, errs
