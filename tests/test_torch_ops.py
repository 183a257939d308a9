"""The port's sampled-dense ops against the JAX package's (Pallas in interpret mode).

On the CPU every wrapper runs its plain PyTorch twin, which draws the same
Philox noise as the CUDA kernel; the kernels themselves are held to the twins
on the card by ``tests/test_torch_kernels.py`` and ``chip_smoke.py``. Inputs
come from numpy.

Tolerances: zero-scale results are f32 products of <= 64-term sums, compared
with another f32 implementation, so 1e-5 absolute on O(1) values; gradients
(of the input or of the posterior parameters) chain two such products, 1e-4.
Noise moments at S = 256 concentrate to a few percent, as in
``tests/test_ops.py``.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustbnns_tpu.ops import sampled_dense as jax_sampled_dense
from robustbnns_tpu.ops import sampled_dense_reference
from robustbnns_tpu.ops import sampled_dense_xs as jax_sampled_dense_xs
from robustbnns_tpu_torch.ops.sampled_dense import (
    philox4x32_10,
    sampled_dense,
    sampled_dense_dparams,
    sampled_dense_dx,
    sampled_dense_fwd,
    sampled_dense_xs,
    sampled_dense_xs_dparams,
    sampled_dense_xs_dx,
    sampled_dense_xs_fwd,
    sampled_noise,
    softplus,
)

B, I, O, S = 8, 24, 20, 3  # O = 20: not a multiple of the 16-column tile


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
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize(
    "words,key,expected",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ],
)
def test_philox_known_answers(words, key, expected):
    """Random123's known-answer vectors for Philox4x32-10."""
    ctr = [torch.tensor([w], dtype=torch.int64) for w in words]
    out = philox4x32_10(*ctr, *key)
    assert tuple(int(v) for v in out) == expected


def test_noise_is_a_function_of_seed_sample_row_column():
    """eps[s, i, o] does not depend on the shape asked for, so any tiling regenerates it."""
    big = sampled_noise(5, 4, 30, 24, "cpu")
    small = sampled_noise(5, 2, 10, 10, "cpu")
    torch.testing.assert_close(small, big[:2, :10, :10], rtol=0, atol=0)
    assert abs(float(big.mean())) < 0.1 and abs(float(big.std()) - 1.0) < 0.1
    assert not torch.equal(sampled_noise(6, 4, 30, 24, "cpu"), big)


def test_softplus_matches_jax():
    x = np.linspace(-40, 40, 401, dtype=np.float32)
    np.testing.assert_allclose(softplus(t(x)).numpy(), np.asarray(jax.nn.softplus(x)), rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("variant", ["x", "xs"])
def test_zero_scale_forward_matches_jax(layer, variant):
    """With rho -> -inf the op is a plain dense layer, in both packages."""
    x, loc, _, bloc, _ = layer
    neg, negb = np.full_like(loc, -30.0), np.full_like(bloc, -30.0)
    if variant == "x":
        ours = sampled_dense(t(x), t(loc), t(neg), t(bloc), t(negb), S, 0)
        ref = jax_sampled_dense(x, loc, neg, bloc, negb, S, 0)
    else:
        xs = np.stack([x * (s + 1) for s in range(S)])
        ours = sampled_dense_xs(t(xs), t(loc), t(neg), t(bloc), t(negb), S, 0)
        ref = jax_sampled_dense_xs(xs, loc, neg, bloc, negb, S, 0)
    assert ours.shape == (S, B, O)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("variant", ["x", "xs"])
def test_zero_scale_input_gradient_matches_jax_grad(layer, variant):
    """The dx/dxs twins against ``jax.grad`` through the Pallas custom VJP."""
    x, loc, _, bloc, _ = layer
    neg, negb = np.full_like(loc, -30.0), np.full_like(bloc, -30.0)
    xin = x if variant == "x" else np.stack([x, 0.5 * x, -x])
    op_t = sampled_dense if variant == "x" else sampled_dense_xs
    op_j = jax_sampled_dense if variant == "x" else jax_sampled_dense_xs

    g_ref = jax.grad(lambda a: jnp.sum(op_j(a, loc, neg, bloc, negb, S, 0) ** 2))(xin)
    xr = t(xin).clone().requires_grad_(True)
    (op_t(xr, t(loc), t(neg), t(bloc), t(negb), S, 0) ** 2).sum().backward()
    np.testing.assert_allclose(xr.grad.numpy(), np.asarray(g_ref), rtol=1e-4, atol=1e-4)


def test_dx_twins_match_the_weights_they_regenerate(layer):
    """dx = Σ_s g_s W_sᵀ and dxs[s] = g_s W_sᵀ with W_s from the forward's own noise."""
    _, loc, rho, _, _ = layer
    g = np.random.default_rng(1).normal(size=(S, B, O)).astype(np.float32)
    eps = sampled_noise(11, S, I, O, "cpu").numpy().astype(np.float64)
    w = loc + np.log1p(np.exp(rho.astype(np.float64))) * eps
    dxs_ref = np.einsum("sbo,sio->sbi", g, w)
    np.testing.assert_allclose(sampled_dense_xs_dx(t(g), t(loc), t(rho), S, 11).numpy(), dxs_ref, atol=1e-5)
    np.testing.assert_allclose(sampled_dense_dx(t(g), t(loc), t(rho), S, 11).numpy(), dxs_ref.sum(0), atol=1e-5)


@pytest.mark.parametrize("variant", ["x", "xs"])
def test_explicit_eps_forward_matches_numpy_formula(layer, variant):
    """out[s] = x @ (loc + softplus(rho)·eps_s) + (bloc + softplus(brho)·eps_b,s)."""
    x, loc, rho, bloc, brho = layer
    seed = 12345
    eps = sampled_noise(seed, S, I + 1, O, "cpu").numpy().astype(np.float64)
    sp = lambda a: np.log1p(np.exp(a.astype(np.float64)))  # noqa: E731
    w = loc + sp(rho) * eps[:, :I]
    b = bloc + sp(brho) * eps[:, I]
    if variant == "x":
        ours = sampled_dense_fwd(t(x), t(loc), t(rho), t(bloc), t(brho), S, seed)
        ref = np.einsum("bi,sio->sbo", x, w) + b[:, None, :]
    else:
        xs = np.stack([x, -x, 2 * x])
        ours = sampled_dense_xs_fwd(t(xs), t(loc), t(rho), t(bloc), t(brho), S, seed)
        ref = np.einsum("sbi,sio->sbo", xs, w) + b[:, None, :]
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)


def test_noise_moments_match_the_jax_reference(layer):
    """Across S = 256 draws, the global mean and the mean per-entry std agree with
    the JAX package's XLA reference (its noise is threefry, ours Philox)."""
    x, loc, rho, bloc, brho = layer
    n = 256
    ours = sampled_dense(t(x), t(loc), t(rho), t(bloc), t(brho), n, 123).numpy()
    ref = np.asarray(sampled_dense_reference(x, loc, rho, bloc, brho, n, jax.random.key(9)))
    assert float(ours.mean()) == pytest.approx(float(ref.mean()), abs=0.05)
    assert float(ours.std(0).mean()) == pytest.approx(float(ref.std(0).mean()), rel=0.05)


def test_seed_sensitivity(layer):
    """Same seed -> same draws; another seed -> other draws; samples differ."""
    args = tuple(t(a) for a in layer)
    o1 = sampled_dense(*args, S, 7)
    o2 = sampled_dense(*args, S, 7)
    o3 = sampled_dense(*args, S, 8)
    assert torch.equal(o1, o2)
    assert not torch.equal(o1, o3)
    assert not torch.equal(o1[0], o1[1])
    # a negative int32 seed is the same draw as its uint32 bit pattern
    assert torch.equal(sampled_dense(*args, S, -1), sampled_dense(*args, S, 0xFFFFFFFF))


@pytest.mark.parametrize("variant", ["x", "xs"])
def test_finite_difference_with_noise(layer, variant):
    """The backward regenerates the forward's noise: a directional derivative
    matches central differences (f32 FD at step 1e-3: 2e-2 relative, as in
    ``tests/test_ops.py``)."""
    x, loc, rho, bloc, brho = (t(a) for a in layer)
    xin = x if variant == "x" else torch.stack([x, 0.5 * x, -x])
    op = sampled_dense if variant == "x" else sampled_dense_xs
    f = lambda a: (op(a, loc, rho, bloc, brho, S, 5) ** 2).sum()  # noqa: E731
    xr = xin.clone().requires_grad_(True)
    f(xr).backward()
    v = torch.from_numpy(np.random.default_rng(4).normal(size=xin.shape).astype(np.float32))
    step = 1e-3
    fd = (f(xin + step * v) - f(xin - step * v)) / (2 * step)
    analytic = (xr.grad * v).sum()
    assert abs(float(fd - analytic)) / (abs(float(fd)) + 1e-6) < 2e-2


def test_parameter_gradients_raise(layer):
    """The dparams wrappers refuse a wrong shape, and tensors that are neither
    all on the CPU nor all on the card, instead of falling back to a twin."""
    x, _, rho, _, brho = (t(a) for a in layer)
    g = torch.ones((S, B, O))
    xs = torch.stack([x] * S)
    with pytest.raises(ValueError):
        sampled_dense_dparams(g[:, :, :-1], x, rho, brho, S, 0)
    with pytest.raises(ValueError):
        sampled_dense_dparams(g, xs, rho, brho, S, 0)
    with pytest.raises(ValueError):
        sampled_dense_xs_dparams(g, x, rho, brho, S, 0)
    with pytest.raises(ValueError, match="all tensors"):
        sampled_dense_dparams(g, x, rho.to("meta"), brho, S, 0)


def _jax_param_grads(op_j, xin, params, g):
    """``jax.grad`` of Σ g ⊙ op(xin, loc, rho, bloc, brho) w.r.t. the four parameters."""
    f = lambda *p: jnp.sum(jnp.asarray(g) * op_j(xin, *p, S, 3))  # noqa: E731
    return jax.grad(f, argnums=(0, 1, 2, 3))(*params)


@pytest.mark.parametrize("variant", ["x", "xs"])
def test_zero_scale_param_gradients_match_jax_grad(layer, variant):
    """The dparams twins in the zero-scale limit against ``jax.grad`` through the
    Pallas custom VJP (as ``tests/test_ops.py`` holds dloc and dbloc to the
    dense layer): dloc = Σ_s x_sᵀ g_s and dbloc = Σ_s Σ_b g_s, while drho and
    dbrho carry σ(-30) ≈ 1e-13 and vanish in both. O = 20 is ragged against
    the 16-column tile."""
    x, loc, _, bloc, _ = layer
    neg, negb = np.full_like(loc, -30.0), np.full_like(bloc, -30.0)
    g = np.random.default_rng(2).normal(size=(S, B, O)).astype(np.float32)
    xin = x if variant == "x" else np.stack([x, 0.5 * x, -x])
    op_j = jax_sampled_dense if variant == "x" else jax_sampled_dense_xs
    twin = sampled_dense_dparams if variant == "x" else sampled_dense_xs_dparams
    ref = _jax_param_grads(op_j, xin, (loc, neg, bloc, negb), g)
    ours = twin(t(g), t(xin), t(neg), t(negb), S, 3)
    for name, got, want in zip(("dloc", "drho", "dbloc", "dbrho"), ours, ref):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("variant", ["x", "xs"])
def test_param_gradients_with_noise_match_jax_autodiff(layer, variant):
    """With rho around -1 the noise matters: the port's autograd (through the
    dparams twins) against ``jax.grad`` of the materialised layer
    ``x_s @ (loc + softplus(rho)·eps_s) + (bloc + softplus(brho)·eps[s, I])``
    with the port's own eps injected as numpy. A bias row off by one or a
    permuted counter fails here. Sums of <= 3·8 O(1) products in f32, so 1e-4."""
    x, loc, rho, bloc, brho = layer
    seed = 3
    eps = sampled_noise(seed, S, I + 1, O, "cpu").numpy()
    g = np.random.default_rng(3).normal(size=(S, B, O)).astype(np.float32)
    xin = x if variant == "x" else np.stack([x, 0.5 * x, -x])

    def f(loc, rho, bloc, brho):
        w = loc + jax.nn.softplus(rho) * eps[:, :I]
        b = bloc + jax.nn.softplus(brho) * eps[:, I]
        out = jnp.matmul(xin, w, precision="highest") + b[:, None, :]
        return jnp.sum(g * out)

    ref = jax.grad(f, argnums=(0, 1, 2, 3))(loc, rho, bloc, brho)
    op = sampled_dense if variant == "x" else sampled_dense_xs
    leaves = [t(a).clone().requires_grad_(True) for a in (loc, rho, bloc, brho)]
    ours = torch.autograd.grad((op(t(xin), *leaves, S, seed) * t(g)).sum(), leaves)
    for name, got, want in zip(("dloc", "drho", "dbloc", "dbrho"), ours, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4, err_msg=name)
    assert float(np.abs(np.asarray(ref[1])).max()) > 1e-2  # the noise term is exercised


@pytest.mark.parametrize("variant", ["x", "xs"])
def test_autograd_runs_only_the_twins_asked_for(monkeypatch, layer, variant):
    """The backward runs the dx twin only for an input that asks for its
    gradient and the dparams twin only for parameters that do, counted by
    spying on the twins (the wrappers' kernels on the card)."""
    # the module, not the op that ``ops`` re-exports under the same name
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    suffix = "" if variant == "x" else "_xs"
    calls = {"dx": 0, "dparams": 0}
    for kind in calls:
        name = f"sampled_dense{suffix}_{kind}_plain"
        twin = getattr(sd, name)

        def spy(*args, _twin=twin, _kind=kind):
            calls[_kind] += 1
            return _twin(*args)

        monkeypatch.setattr(sd, name, spy)
    x, loc, rho, bloc, brho = (t(a) for a in layer)
    xin = x if variant == "x" else torch.stack([x, -x, x])
    op = sampled_dense if variant == "x" else sampled_dense_xs

    def run(x_grad, param_grads):
        xr = xin.clone().requires_grad_(x_grad)
        params = [p.clone().requires_grad_(need) for p, need in zip((loc, rho, bloc, brho), param_grads)]
        wanted = [v for v in (xr, *params) if v.requires_grad]
        before = dict(calls)
        grads = torch.autograd.grad(op(xr, *params, S, 1).square().sum(), wanted)
        assert all(gr is not None for gr in grads)
        return calls["dx"] - before["dx"], calls["dparams"] - before["dparams"]

    assert run(True, (False,) * 4) == (1, 0)
    assert run(False, (True, False, False, False)) == (0, 1)
    assert run(False, (False, False, False, True)) == (0, 1)
    assert run(True, (True,) * 4) == (1, 1)


def test_dparams_twins_match_the_numpy_formulas(layer):
    """dloc = Σ_s dW_s, drho = Σ_s dW_s·eps_s·σ(rho), dbloc = Σ_s Σ_b g_s and
    dbrho = Σ_s (Σ_b g_s)·eps[s, I]·σ(brho), with dW_s = x_sᵀ g_s, in float64."""
    x, _, rho, _, brho = layer
    g = np.random.default_rng(5).normal(size=(S, B, O))
    xs = np.stack([x, 2 * x, -x]).astype(np.float64)
    eps = sampled_noise(17, S, I + 1, O, "cpu").numpy().astype(np.float64)
    sig = lambda a: 1.0 / (1.0 + np.exp(-a.astype(np.float64)))  # noqa: E731
    dw = np.einsum("sbi,sbo->sio", xs, g)
    db = g.sum(1)
    want = (dw.sum(0), (dw * eps[:, :I] * sig(rho)).sum(0), db.sum(0), (db * eps[:, I] * sig(brho)).sum(0))
    got = sampled_dense_xs_dparams(t(g.astype(np.float32)), t(xs.astype(np.float32)), t(rho), t(brho), S, 17)
    for name, a, b in zip(("dloc", "drho", "dbloc", "dbrho"), got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4, err_msg=name)


def test_wrappers_check_shapes(layer):
    x, loc, rho, bloc, brho = (t(a) for a in layer)
    with pytest.raises(ValueError):
        sampled_dense_fwd(x[:, :-1], loc, rho, bloc, brho, S, 0)
    with pytest.raises(ValueError):
        sampled_dense_xs_fwd(x, loc, rho, bloc, brho, S, 0)
    with pytest.raises(ValueError, match="all tensors"):  # never a twin on mixed devices
        sampled_dense_fwd(x, loc.to("meta"), rho, bloc, brho, S, 0)


# The dx kernels' launch plan (computed in Python, followed by the CUDA kernel)
PLAN_SHAPES = [  # (S, B, I, O): the main path, the edge shapes of the card tests, tiny ones
    (10, 128, 784, 1024), (10, 128, 1024, 1024), (10, 128, 1024, 10), (10, 1, 784, 1024),
    (3, 37, 784, 13), (1, 128, 1024, 10), (100, 128, 784, 1024), (10, 2048, 784, 1024),
    (2, 64, 256, 4000), (3, 8, 24, 20), (5, 130, 37, 10), (2, 45, 70, 66), (1, 3, 10, 17),
]


@pytest.mark.parametrize("sum_samples", [True, False], ids=["dx", "xs_dx"])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "S{}_B{}_I{}_O{}".format(*s))
def test_dx_plan_covers_every_unit_once(shape, sum_samples):
    """Every (s, o-chunk) of an output tile is walked by exactly one block row,
    a dxs run stays inside one sample, and the grid covers B and I."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    s, b, i, o = shape
    plan = sd.dx_plan(s, b, i, o, 132, sum_samples)
    chunks = -(-o // sd.DX_DEPTH)
    assert plan.units == s * chunks
    if o <= sd.NARROW_MAX_O:
        assert plan.narrow and plan.n_split == 1 and plan.scratch == ()
        assert plan.grid[1] == (1 if sum_samples else s)
        assert plan.grid[0] * sd.NARROW_COLS >= i and plan.grid[2] * sd.NARROW_ROWS >= b
        return
    runs = sd.dx_unit_runs(plan, s, sum_samples)
    assert not plan.narrow and plan.grid[1] == len(runs)
    walked = [u for run in runs for u in run]
    assert sorted(walked) == list(range(plan.units)) and all(len(run) > 0 for run in runs)
    if not sum_samples:
        assert all(run.start // chunks == (run.stop - 1) // chunks for run in runs)
    assert plan.grid[0] * sd.DX_COLS >= i > (plan.grid[0] - 1) * sd.DX_COLS
    assert plan.grid[2] * sd.DX_ROWS >= b > (plan.grid[2] - 1) * sd.DX_ROWS
    lead = (plan.n_split,) if sum_samples else (plan.n_split, s)
    assert plan.scratch == ((*lead, b, i) if plan.n_split > 1 else ())


@pytest.mark.parametrize("sum_samples", [True, False], ids=["dx", "xs_dx"])
@pytest.mark.parametrize("b,i,o", [(128, 784, 1024), (2048, 784, 1024), (1, 70, 36), (37, 784, 13)])
def test_dx_plan_scratch_does_not_grow_with_samples(b, i, o, sum_samples):
    """The partial sums stay within a bound set by the card, whatever S is (a
    per-sample scratch for dx at S = 100, B = 2048 would be 642 MB): dx's at
    most DX_MAX_SPLIT tiles of (B, I), dxs's only while the grid is small."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    sizes = [math.prod(sd.dx_plan(s, b, i, o, 132, sum_samples).scratch or (0,)) for s in (1, 10, 100, 1000)]
    if sum_samples:
        assert max(sizes) <= sd.DX_MAX_SPLIT * b * i
        assert sizes == sorted(sizes) and sizes[2] == sizes[3]  # capped: S = 100 and 1000 alike
    else:
        assert max(sizes) <= 2 * sd.DX_BLOCKS_PER_SM * 132 * sd.DX_ROWS * sd.DX_COLS
        assert sizes[3] == 0


def test_dx_plan_fills_the_card_at_the_main_path():
    """At model_7's shapes (B = 128, S = 10) on 132 SMs: dx's 13 tiles split
    into 40 runs fill the four block slots of nearly every SM; dxs's 160 tiles
    at the hidden layer split in three; the head takes the narrow path."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    plan = sd.dx_plan(10, 128, 784, 1024, 132, True)
    assert (plan.n_split, math.prod(plan.grid), plan.scratch) == (40, 520, (40, 128, 784))
    xs = sd.dx_plan(10, 128, 1024, 1024, 132, False)
    assert (xs.n_split, math.prod(xs.grid)) == (3, 480)
    head = sd.dx_plan(10, 128, 1024, 10, 132, False)
    assert head.narrow and head.grid == (32, 10, 1)


# The forward kernels' launch plan (computed in Python, followed by the CUDA kernel)
FWD_PLAN_SHAPES = PLAN_SHAPES + [(2, 64, 3072, 512), (10, 100, 2, 32), (10, 100, 32, 2), (40, 1, 70, 66)]


@pytest.mark.parametrize("shape", FWD_PLAN_SHAPES, ids=lambda s: "S{}_B{}_I{}_O{}".format(*s))
def test_fwd_plan_covers_every_chunk_once(shape):
    """Every chunk of I of an output tile is walked by exactly one run, and the
    grid covers S, B and O."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    s, b, i, o = shape
    plan = sd.fwd_plan(s, b, i, o, 132)
    assert plan.narrow == (o <= sd.NARROW_MAX_O)
    depth = sd.FWD_NARROW_DEPTH if plan.narrow else sd.FWD_DEPTH
    assert plan.chunks == -(-i // depth)
    runs = sd.fwd_chunk_runs(plan)
    assert len(runs) == plan.n_split and all(len(run) > 0 for run in runs)
    assert [c for run in runs for c in run] == list(range(plan.chunks))
    assert plan.grid[0] == s * plan.n_split
    if plan.narrow:
        assert plan.grid[1] == 1
    else:
        assert plan.grid[1] * sd.FWD_COLS >= o > (plan.grid[1] - 1) * sd.FWD_COLS
    assert plan.grid[2] * sd.FWD_ROWS >= b > (plan.grid[2] - 1) * sd.FWD_ROWS
    assert plan.scratch == ((plan.n_split, s, b, o) if plan.n_split > 1 else ())


@pytest.mark.parametrize("b,i,o", [(128, 784, 1024), (2048, 784, 1024), (1, 70, 36), (37, 784, 13),
                                   (128, 1024, 10), (64, 3072, 512)])
def test_fwd_plan_partials_stay_bounded(b, i, o):
    """The partial tiles fit one wave of the card's block slots whatever S is,
    and vanish once the samples alone fill it (a per-sample scratch of three
    runs at S = 100, B = 2048 would be 2.5 GB)."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    cols = sd.NARROW_MAX_O if o <= sd.NARROW_MAX_O else sd.FWD_COLS
    for s in (1, 10, 100, 1000):
        plan = sd.fwd_plan(s, b, i, o, 132)
        tiles = s * plan.grid[1] * plan.grid[2]
        if plan.n_split > 1:
            assert plan.n_split * tiles <= sd.FWD_BLOCKS_PER_SM * 132
            assert math.prod(plan.scratch) <= sd.FWD_BLOCKS_PER_SM * 132 * sd.FWD_ROWS * cols
    assert sd.fwd_plan(1000, b, i, o, 132).scratch == ()


def test_fwd_plan_fills_the_card_at_the_main_path():
    """At model_7's shapes (B = 128, S = 10) on 132 SMs: the 160 tiles of each
    wide layer split into three runs, 480 blocks in one wave of the 528 block
    slots; the head's ten tiles split I into 32 runs of one chunk each."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    for i in (784, 1024):
        plan = sd.fwd_plan(10, 128, i, 1024, 132)
        assert (plan.n_split, plan.grid, plan.scratch) == (3, (30, 16, 1), (3, 10, 128, 1024))
    head = sd.fwd_plan(10, 128, 1024, 10, 132)
    assert head.narrow and (head.n_split, head.grid, head.scratch) == (32, (320, 1, 1), (32, 10, 128, 10))


# The dparams kernels' launch plan (computed in Python, followed by the CUDA kernel)
@pytest.mark.parametrize("shape", FWD_PLAN_SHAPES, ids=lambda s: "S{}_B{}_I{}_O{}".format(*s))
def test_dparams_plan_covers_every_sample_once(shape):
    """Every sample of every tile of dloc/drho is walked by exactly one run,
    the grid covers I and O, a wide tile's runs fit one cluster, and only the
    narrow path has partials, with two runs or more."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    s, _, i, o = shape
    plan = sd.dparams_plan(s, i, o, 132)
    assert plan.narrow == (o <= sd.NARROW_MAX_O)
    runs = sd.dparams_sample_runs(plan, s)
    assert len(runs) == plan.n_split and all(len(run) > 0 for run in runs)
    assert [k for run in runs for k in run] == list(range(s))
    if plan.narrow:
        assert plan.grid[1:] == (plan.n_split, 1)
        assert plan.grid[0] * sd.DP_NARROW_COLS >= i > (plan.grid[0] - 1) * sd.DP_NARROW_COLS
        assert plan.scratch == ((plan.n_split, 2, i + 1, o) if plan.n_split > 1 else ())
    else:
        assert plan.grid[2] == plan.n_split <= sd.DP_MAX_RUNS and plan.scratch == ()
        assert plan.grid[0] * sd.DP_COLS >= o > (plan.grid[0] - 1) * sd.DP_COLS
        assert plan.grid[1] * sd.DP_ROWS >= i > (plan.grid[1] - 1) * sd.DP_ROWS


@pytest.mark.parametrize("i,o", [(784, 1024), (1024, 1024), (1024, 10), (70, 36), (784, 13), (3072, 512),
                                 (256, 4000), (2, 32), (32, 2)])
def test_dparams_plan_partials_stay_bounded(i, o):
    """The runs fill at most one wave of the card's block slots whatever S is,
    so the narrow path's partial planes stay within one wave of tiles and the
    wide path has none; a block walks the whole batch, so B (up to 4096 here)
    never enters the plan."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    narrow = o <= sd.NARROW_MAX_O
    slots = (sd.DP_NARROW_BLOCKS_PER_SM if narrow else sd.DP_BLOCKS_PER_SM) * 132
    tile = sd.DP_NARROW_COLS * sd.NARROW_MAX_O if narrow else sd.DP_ROWS * sd.DP_COLS
    sizes = []
    for s in (1, 10, 100, 1000):
        plan = sd.dparams_plan(s, i, o, 132)
        if plan.n_split > 1:
            assert math.prod(plan.grid) <= slots
            assert math.prod(plan.scratch) <= 2 * slots * (tile + o)
        sizes.append(math.prod(plan.scratch or (0,)))
    assert sizes == sorted(sizes)  # more runs only while more samples fit the wave


def test_dparams_plan_fills_the_card_at_the_main_path():
    """At model_7's shapes (S = 10) on 132 SMs: the 112 and 128 tiles of the
    wide layers split into two runs of five samples, clusters of two, 224 and
    256 blocks in one wave of the 264 block slots (two an SM); the head's 32
    input blocks take one sample a run, 320 blocks."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    first = sd.dparams_plan(10, 784, 1024, 132)
    assert (first.n_split, first.grid, first.scratch) == (2, (16, 7, 2), ())
    hidden = sd.dparams_plan(10, 1024, 1024, 132)
    assert (hidden.n_split, hidden.grid, hidden.scratch) == (2, (16, 8, 2), ())
    head = sd.dparams_plan(10, 1024, 10, 132)
    assert head.narrow and (head.n_split, head.grid, head.scratch) == (10, (32, 10, 1), (10, 2, 1025, 10))
