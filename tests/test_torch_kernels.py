"""The port's CUDA sampled-dense kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA card and the CUDA toolkit: the module carries
the ``cuda`` marker and each test skips without a card. On the card::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: the suite's conftest sets JAX up, and nothing here uses JAX.)

Tolerance: a kernel and its twin draw the same Philox words and form the same
weights, but sum the products in another order (up to S·O terms of f32) and may
round ``log``/``sin``/``cos`` an ulp apart, so results agree to 1e-4 relative
plus 1e-4 of the largest entry. The noise itself is compared entry by entry to
1e-5 absolute: a few ulps of an O(1) normal.

The bf16 forward and input-gradient variants
(``ROBUSTBNNS_KERNEL_PRECISION=default``) multiply the same bf16 operands as
their twins, exactly in f32, so they differ only in the order of the f32 sums
and where a W_s that the kernel and torch round an ulp apart in f32 lands on
the other bf16 neighbour: one term off by at most 2⁻⁷ of its |x||W_s|. Each
output is held to the f32 tolerance of its twin plus 2⁻⁷ of its largest term,
and to 2·2⁻⁸·Σ|x||W_s| (both operands rounded) plus the f32 tolerance of the
exact f32 twin. The bf16 parameter-gradient variants round x and g, which
round alike on the card and on the CPU, and no W_s: they meet their twins at
the f32 tolerance alone.
"""
import importlib
import math

import numpy as np
import pytest
import torch

# the module, not the op of the same name that robustbnns_tpu_torch.ops exports
sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")

pytestmark = pytest.mark.cuda

SHAPES = [  # (B, I, O, S)
    (8, 24, 20, 3),  # O not a multiple of the 16-column tile
    (130, 37, 10, 5),  # two row tiles, I not a multiple of 4, the 10-class head
    (45, 70, 66, 2),  # ragged B, I and O past a 64-output tile
    (128, 784, 1024, 10),  # model_7's first layer at the attack batch
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    from robustbnns_tpu_torch.utils.device import exact_f32

    exact_f32()
    return torch.device("cuda")


def layer(b, i, o, s, device):
    rng = np.random.default_rng(b * 7919 + i * 31 + o)

    def normal(*shape, scale=1.0, shift=0.0):
        a = rng.normal(size=shape) * scale + shift
        return torch.tensor(a.astype(np.float32), device=device)

    return {
        "x": normal(b, i), "xs": normal(s, b, i), "g": normal(s, b, o),
        "loc": normal(i, o, scale=0.1), "rho": normal(i, o, scale=0.5, shift=-3.0),
        "bloc": normal(o, scale=0.1), "brho": normal(o, scale=0.5, shift=-3.0),
    }


def assert_close(got, ref):
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


def launches(*wrappers) -> tuple:
    """The launches counted so far of each kernel wrapper."""
    counts = sd.launch_counts()
    return tuple(counts[w.__name__] for w in wrappers)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
def test_kernels_match_plain_twins(cuda, shape):
    b, i, o, s = shape
    p = layer(b, i, o, s, cuda)
    params, seed = (p["loc"], p["rho"], p["bloc"], p["brho"]), 2026
    cases = [
        (sd.sampled_dense_fwd, sd.sampled_dense_fwd_plain, (p["x"], *params)),
        (sd.sampled_dense_xs_fwd, sd.sampled_dense_xs_fwd_plain, (p["xs"], *params)),
        (sd.sampled_dense_dx, sd.sampled_dense_dx_plain, (p["g"], p["loc"], p["rho"])),
        (sd.sampled_dense_xs_dx, sd.sampled_dense_xs_dx_plain, (p["g"], p["loc"], p["rho"])),
        (sd.sampled_dense_dparams, sd.sampled_dense_dparams_plain, (p["g"], p["x"], p["rho"], p["brho"])),
        (sd.sampled_dense_xs_dparams, sd.sampled_dense_xs_dparams_plain,
         (p["g"], p["xs"], p["rho"], p["brho"])),
    ]
    for kernel, plain, args in cases:
        (before,) = launches(kernel)
        got = kernel(*args, s, seed)
        torch.cuda.synchronize()
        assert launches(kernel) == (before + 1,)
        want = plain(*args, s, seed)
        for got_t, want_t in zip(*((t,) if torch.is_tensor(t) else t for t in (got, want))):
            assert got_t.is_cuda and torch.isfinite(got_t).all()
            assert_close(got_t, want_t)


def test_kernel_noise_is_the_twins_noise(cuda):
    """With loc = 0 and softplus(rho) = 1 the forward returns its own eps: an
    identity input reads weight row b, a zero input reads the bias row I."""
    i_dim, o_dim, s, seed = 40, 20, 3, 77
    rho = torch.full((i_dim, o_dim), math.log(math.expm1(1.0)), device=cuda)
    brho = torch.full((o_dim,), math.log(math.expm1(1.0)), device=cuda)
    zeros = torch.zeros((i_dim, o_dim), device=cuda)
    bzeros = torch.zeros((o_dim,), device=cuda)
    eps = sd.sampled_noise(seed, s, i_dim + 1, o_dim, cuda)
    bias_only = sd.sampled_dense_fwd(torch.zeros((5, i_dim), device=cuda), zeros, rho, bzeros, brho, s, seed)
    torch.testing.assert_close(bias_only, eps[:, i_dim : i_dim + 1].expand(s, 5, o_dim), rtol=0, atol=1e-5)
    out = sd.sampled_dense_fwd(torch.eye(i_dim, device=cuda), zeros, rho, bzeros, brho, s, seed)
    torch.testing.assert_close(out - bias_only[:, :1], eps[:, :i_dim], rtol=0, atol=1e-5)


def test_autograd_runs_the_dx_kernels(cuda):
    """The backward launches the dx kernel for the input and the dparams kernel
    for the parameters, each only when its gradient is asked for."""
    b, i, o, s = 16, 48, 32, 4
    p = layer(b, i, o, s, cuda)
    params = (p["loc"], p["rho"], p["bloc"], p["brho"])
    for op, dx_kernel, dp_kernel, x in (
        (sd.sampled_dense, sd.sampled_dense_dx, sd.sampled_dense_dparams, p["x"]),
        (sd.sampled_dense_xs, sd.sampled_dense_xs_dx, sd.sampled_dense_xs_dparams, p["xs"]),
    ):
        xr = x.clone().requires_grad_(True)
        before = launches(dx_kernel, dp_kernel)
        (op(xr, *params, s, 9) * p["g"]).sum().backward()
        assert launches(dx_kernel, dp_kernel) == (before[0] + 1, before[1])
        assert_close(xr.grad, dx_kernel(p["g"], p["loc"], p["rho"], s, 9))
        leaves = [t.clone().requires_grad_(True) for t in params]
        grads = torch.autograd.grad((op(x, *leaves, s, 9) * p["g"]).sum(), leaves)
        assert launches(dx_kernel, dp_kernel) == (before[0] + 2, before[1] + 1)
        for got, want in zip(grads, dp_kernel(p["g"], x, p["rho"], p["brho"], s, 9)):
            assert_close(got, want)


def test_seeds_select_the_draws(cuda):
    b, i, o, s = 8, 24, 20, 3
    p = layer(b, i, o, s, cuda)
    args = (p["x"], p["loc"], p["rho"], p["bloc"], p["brho"], s)
    a, again, other = (sd.sampled_dense_fwd(*args, seed) for seed in (5, 5, 6))
    assert torch.equal(a, again) and not torch.equal(a, other)
    assert torch.equal(sd.sampled_dense_fwd(*args, -1), sd.sampled_dense_fwd(*args, 0xFFFFFFFF))


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    b, i, o, s = 8, 24, 20, 3
    p = layer(b, i, o, s, cuda)
    params = (p["loc"], p["rho"], p["bloc"], p["brho"])
    with pytest.raises(TypeError):
        sd.sampled_dense_fwd(p["x"].double(), *params, s, 0)
    with pytest.raises(ValueError):
        sd.sampled_dense_fwd(p["x"].t().contiguous().t(), *params, s, 0)  # not contiguous
    with pytest.raises(ValueError):
        sd.sampled_dense_fwd(p["x"].cpu(), *params, s, 0)  # mixed devices
    wide = layer(b, 4000, o, s, cuda)  # too wide for a per-block slice of rho in shared memory
    args = (wide["x"], wide["loc"], wide["rho"], wide["bloc"], wide["brho"], s, 0)
    assert_close(sd.sampled_dense_fwd(*args), sd.sampled_dense_fwd_plain(*args))


DX_EDGE_SHAPES = [  # (B, I, O, S), as chip_smoke.py's dx-edge phase
    (1, 784, 1024, 10),  # one row of a 128-row tile
    (37, 784, 13, 3),  # the narrow path, O not a multiple of 4
    (128, 1024, 10, 1),  # the 10-class head at S = 1
    (128, 784, 1024, 100),  # S = 100: the partials stay at 20
    (2048, 784, 1024, 10),  # 16 row tiles
    (64, 256, 4000, 2),  # an O whose whole softplus(rho) slice fits no block's shared memory
]


@pytest.mark.parametrize("shape", DX_EDGE_SHAPES, ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
def test_dx_kernels_at_edge_shapes(cuda, shape):
    """Both dx kernels against their twins, bit-identical across two calls, and
    dx against the sum over samples of dxs."""
    b, i, o, s = shape
    p = layer(b, i, o, s, cuda)
    args = (p["g"], p["loc"], p["rho"], s, 31)
    dx, dxs = sd.sampled_dense_dx(*args), sd.sampled_dense_xs_dx(*args)
    assert torch.equal(dx, sd.sampled_dense_dx(*args))
    assert torch.equal(dxs, sd.sampled_dense_xs_dx(*args))
    assert torch.isfinite(dx).all() and torch.isfinite(dxs).all()
    assert_close(dx, sd.sampled_dense_dx_plain(*args))
    assert_close(dxs, sd.sampled_dense_xs_dx_plain(*args))
    assert_close(dx, dxs.sum(0))


FWD_EDGE_SHAPES = [  # (B, I, O, S), as chip_smoke.py's fwd-edge phase
    (1, 784, 1024, 10),  # one row of a 128-row tile
    (37, 784, 13, 3),  # the narrow path, O not a multiple of 4
    (128, 1024, 10, 1),  # the 10-class head at S = 1
    (128, 784, 1024, 100),  # S = 100: no partials
    (2048, 784, 1024, 10),  # 16 row tiles
    (64, 3072, 512, 2),  # CIFAR-10's input width: too wide for a per-block slice of rho in shared memory
    (100, 2, 32, 10),  # the Half Moons hidden layer: I = 2
    (100, 32, 2, 10),  # the Half Moons head: O = 2
]


@pytest.mark.parametrize("shape", FWD_EDGE_SHAPES, ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
def test_fwd_kernels_at_edge_shapes(cuda, shape):
    """Both forwards against their twins, bit-identical across two calls, and
    xs_fwd on a broadcast x equal to fwd."""
    b, i, o, s = shape
    p = layer(b, i, o, s, cuda)
    params = (p["loc"], p["rho"], p["bloc"], p["brho"], s, 31)
    out, out_xs = sd.sampled_dense_fwd(p["x"], *params), sd.sampled_dense_xs_fwd(p["xs"], *params)
    assert torch.equal(out, sd.sampled_dense_fwd(p["x"], *params))
    assert torch.equal(out_xs, sd.sampled_dense_xs_fwd(p["xs"], *params))
    assert torch.equal(out, sd.sampled_dense_xs_fwd(p["x"].expand(s, b, i).contiguous(), *params))
    assert torch.isfinite(out).all() and torch.isfinite(out_xs).all()
    assert_close(out, sd.sampled_dense_fwd_plain(p["x"], *params))
    assert_close(out_xs, sd.sampled_dense_xs_fwd_plain(p["xs"], *params))


DPARAMS_EDGE_SHAPES = FWD_EDGE_SHAPES + [  # (B, I, O, S), as chip_smoke.py's dparams-edge phase
    (64, 256, 4000, 2),  # a wide O: 63 output tiles
]


@pytest.mark.parametrize("shape", DPARAMS_EDGE_SHAPES, ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
def test_dparams_kernels_at_edge_shapes(cuda, shape):
    """Both dparams kernels against their twins, bit-identical across two
    calls, and xs_dparams on a broadcast x equal to dparams."""
    b, i, o, s = shape
    p = layer(b, i, o, s, cuda)
    tail = (p["rho"], p["brho"], s, 31)
    got, got_xs = sd.sampled_dense_dparams(p["g"], p["x"], *tail), sd.sampled_dense_xs_dparams(p["g"], p["xs"], *tail)
    again = sd.sampled_dense_dparams(p["g"], p["x"], *tail) + sd.sampled_dense_xs_dparams(p["g"], p["xs"], *tail)
    assert all(torch.equal(a, c) for a, c in zip(got + got_xs, again))
    broadcast = sd.sampled_dense_xs_dparams(p["g"], p["x"].expand(s, b, i).contiguous(), *tail)
    assert all(torch.equal(a, c) for a, c in zip(broadcast, got))
    for outs, want in ((got, sd.sampled_dense_dparams_plain(p["g"], p["x"], *tail)),
                       (got_xs, sd.sampled_dense_xs_dparams_plain(p["g"], p["xs"], *tail))):
        for got_t, want_t in zip(outs, want):
            assert torch.isfinite(got_t).all()
            assert_close(got_t, want_t)


BF16_SHAPES = SHAPES + [  # (B, I, O, S) beyond SHAPES: chip_smoke.py's edge shapes of the attack kernels
    (1, 784, 1024, 10),  # one row of a 128-row tile
    (37, 784, 13, 3),  # the narrow paths, O not a multiple of 4
    (128, 1024, 10, 1),  # the 10-class head at S = 1
    (128, 1024, 1024, 10),  # model_7's hidden layer
    (100, 2, 32, 10),  # the Half Moons hidden layer: I = 2
]


@pytest.mark.parametrize("shape", BF16_SHAPES, ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
def test_bf16_kernels_match_bf16_twins(cuda, shape, monkeypatch):
    """Under ROBUSTBNNS_KERNEL_PRECISION=default each public wrapper launches
    its bf16 kernel (and no f32 one): bit-identical across two calls; within
    the f32 tolerance of the bf16 twin plus 2⁻⁷ of the largest single term
    |x_i||W_si| (one W_s rounded to the other bf16 neighbour); within the bf16
    rounding bound of the exact f32 twin; and nearer the bf16 twin than a
    tenth of its distance from the f32 twin, which a kernel that skipped the
    bf16 rounding would not be."""
    b, i, o, s = shape
    p = layer(b, i, o, s, cuda)
    params, seed = (p["loc"], p["rho"], p["bloc"], p["brho"]), 2027
    cases = [
        ("fwd", sd.sampled_dense_fwd, sd.sampled_dense_fwd_bf16, sd.sampled_dense_fwd_bf16_plain,
         sd.sampled_dense_fwd_plain, p["x"], params),
        ("xs_fwd", sd.sampled_dense_xs_fwd, sd.sampled_dense_xs_fwd_bf16, sd.sampled_dense_xs_fwd_bf16_plain,
         sd.sampled_dense_xs_fwd_plain, p["xs"], params),
        ("dx", sd.sampled_dense_dx, sd.sampled_dense_dx_bf16, sd.sampled_dense_dx_bf16_plain,
         sd.sampled_dense_dx_plain, p["g"], params[:2]),
        ("xs_dx", sd.sampled_dense_xs_dx, sd.sampled_dense_xs_dx_bf16, sd.sampled_dense_xs_dx_bf16_plain,
         sd.sampled_dense_xs_dx_plain, p["g"], params[:2]),
    ]
    for kind, public, kernel, twin, exact, a, rest in cases:
        monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "default")
        before, f32_before = launches(kernel, public)
        got = public(a, *rest, s, seed)
        again = public(a, *rest, s, seed)
        torch.cuda.synchronize()
        assert launches(kernel, public) == (before + 2, f32_before)
        assert torch.equal(got, again) and torch.isfinite(got).all()
        monkeypatch.delenv("ROBUSTBNNS_KERNEL_PRECISION")
        scale = sd.bf16_error_scale(kind, a, p["loc"], p["rho"], s, seed)
        term = sd.bf16_error_scale(kind, a, p["loc"], p["rho"], s, seed, largest=True)
        ref, f32 = twin(a, *rest, s, seed), exact(a, *rest, s, seed)
        err, err32 = (got - ref).abs(), (got - f32).abs()
        assert (err <= 2.0**-7 * term + 1e-4 * ref.abs() + 1e-4 * float(ref.abs().max())).all(), kind
        assert (err32 <= 2 * 2.0**-8 * scale + 1e-4 * f32.abs() + 1e-4 * float(f32.abs().max())).all(), kind
        assert float(err.max()) < 0.1 * float(err32.max()), (kind, float(err.max()), float(err32.max()))


BF16_DPARAMS_SHAPES = DPARAMS_EDGE_SHAPES + [  # (B, I, O, S) beyond the edge shapes: model_7's three layers
    (128, 784, 1024, 10),
    (128, 1024, 1024, 10),
    (128, 1024, 10, 10),
]


@pytest.mark.parametrize("shape", BF16_DPARAMS_SHAPES, ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
def test_bf16_dparams_kernels_match_bf16_twins(cuda, shape, monkeypatch):
    """Under ROBUSTBNNS_KERNEL_PRECISION=default each parameter-gradient
    wrapper launches its bf16 kernel, counted under the bf16 name only:
    bit-identical across two calls; within the f32 tolerance of the bf16
    twin (no W_s is rounded, so the kernel and its twin form the same exact
    products and differ in the order of the f32 sums alone); within the
    bf16 rounding bound of the exact f32 kernel; and dloc and drho nearer the
    bf16 twin than a tenth of their distance from the f32 kernel."""
    b, i, o, s = shape
    p = layer(b, i, o, s, cuda)
    seed = 2028
    for kind, public, kernel, x in (("dparams", sd.sampled_dense_dparams, sd.sampled_dense_dparams_bf16, p["x"]),
                                    ("xs_dparams", sd.sampled_dense_xs_dparams, sd.sampled_dense_xs_dparams_bf16,
                                     p["xs"])):
        args = (p["g"], x, p["rho"], p["brho"], s, seed)
        monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "default")
        before, f32_before = launches(kernel, public)
        got, again = public(*args), public(*args)
        torch.cuda.synchronize()
        assert launches(kernel, public) == (before + 2, f32_before), kind
        assert all(torch.equal(a, c) and bool(torch.isfinite(a).all()) for a, c in zip(got, again)), kind
        monkeypatch.delenv("ROBUSTBNNS_KERNEL_PRECISION")
        twin = sd.sampled_dense_dparams_bf16_plain(*args)
        f32 = public(*args)
        scales = sd.bf16_error_scale(kind, p["g"], x, p["rho"], s, seed)
        for k, (got_t, twin_t, f32_t) in enumerate(zip(got, twin, f32)):
            assert_close(got_t, twin_t)
            if k < 2:
                err32 = (got_t - f32_t).abs()
                assert (err32 <= 2 * 2.0**-8 * scales[k] + 1e-4 * f32_t.abs()
                        + 1e-4 * float(f32_t.abs().max())).all(), (kind, k)
                err = float((got_t - twin_t).abs().max())
                assert err < 0.1 * float(err32.max()), (kind, k, err, float(err32.max()))


GROUPED_CONV_SHAPES = [  # (B, S, hidden)
    (128, 8, 512),  # model_0's widths at the attack batch
    (128, 100, 512),  # model_0's attack: S = 100
    (128, 8, 256),  # model_6
    (128, 8, 1024),  # model_2, 4, 8, 9
    (128, 1, 512),  # the NN path
    (127, 8, 512),  # a batch that is not a multiple of the block's two images
    (1, 8, 512),
]


@pytest.mark.parametrize("shape", GROUPED_CONV_SHAPES, ids=lambda s: "B{}_S{}_N{}".format(*s))
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])  # the trunk's, and a per-draw input's
def test_grouped_conv_kernel_against_float64(cuda, shape, layout):
    """``csrc/grouped_conv.cu`` against float64 ``F.conv2d`` with ``groups=S``,
    the output in the input's layout.
    Each output sums K = 800 products and the bias in f32 with FMAs in a
    fixed order, so it lies within (K + 1)·2⁻²⁴ of its terms' absolute sum of the
    exact value (the worst case of a K-term f32 sum; a fault moves outputs
    by the size of a term, far beyond it). Bit-identical across two calls,
    and one launch counted a forward."""
    from robustbnns_tpu_torch.ops import launch_counts

    gc = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv")
    b_dim, n_draws, hidden = shape
    gen = torch.Generator(device=cuda).manual_seed(b_dim * 7919 + n_draws * 31 + hidden)
    x = torch.rand((b_dim, 32 * n_draws, 12, 12), generator=gen, device=cuda)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.randn((n_draws, 5, 5, 32, hidden), generator=gen, device=cuda) / 800**0.5
    bias = 0.1 * torch.randn((n_draws, hidden), generator=gen, device=cuda)
    before = launch_counts()["grouped_conv.fwd"]
    got, again = gc.grouped_conv_fwd(x, w, bias), gc.grouped_conv_fwd(x, w, bias)
    torch.cuda.synchronize()
    assert launch_counts()["grouped_conv.fwd"] == before + 2
    out_format = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    assert got.is_contiguous(memory_format=out_format)
    assert torch.equal(got, again) and bool(torch.isfinite(got).all())
    with torch.no_grad():
        exact = gc.grouped_conv_plain(x.double(), w.double(), bias.double())
        terms = gc.grouped_conv_plain(x.double().abs(), w.double().abs(), bias.double().abs())
        assert bool(((got.double() - exact).abs() <= 801 * 2.0**-24 * terms).all())
        del exact, terms


GROUPED_CONV_DGRAD_SHAPES = [  # (B, S, hidden)
    (128, 100, 512),  # model_0's attack: two images a block
    (128, 1, 512),  # SVI's ELBO step and the NN path: one image a block
    (127, 8, 512),  # a batch that is not a multiple of two images
]


@pytest.mark.parametrize("shape", GROUPED_CONV_DGRAD_SHAPES, ids=lambda s: "B{}_S{}_N{}".format(*s))
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])  # the trunk's, and a per-draw input's
def test_grouped_conv_dgrad_kernel_against_float64(cuda, shape, layout):
    """The input gradient of ``csrc/grouped_conv.cu`` against its plain twin
    (the input gradient of ``grouped_conv_plain``) in float64, dx in g's
    layout with the strides of aten's input gradient for an input in that
    layout. Each dx element sums K = 25·N products in f32 with FMAs in a
    fixed order, so it lies within (K + 1)·2⁻²⁴ of its terms' absolute sum of
    the exact value (a fault moves entries by the size of a term, far beyond
    it). Bit-identical across two calls, one launch counted a call."""
    from robustbnns_tpu_torch.ops import launch_counts

    gc = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv")
    b_dim, n_draws, hidden = shape
    fmt = torch.channels_last if layout == "channels_last" else torch.contiguous_format
    gen = torch.Generator(device=cuda).manual_seed(b_dim * 7919 + n_draws * 31 + hidden + 1)
    g = torch.randn((b_dim, n_draws * hidden, 8, 8), generator=gen, device=cuda).contiguous(memory_format=fmt)
    w = torch.randn((n_draws, 5, 5, 32, hidden), generator=gen, device=cuda) / 800**0.5
    before = launch_counts()["grouped_conv.dgrad"]
    got = gc.grouped_conv_dgrad(g, w, 1, 0)
    assert launch_counts()["grouped_conv.dgrad"] == before + 1
    again = gc.grouped_conv_dgrad(g, w, 1, 0)
    torch.cuda.synchronize()
    assert launch_counts()["grouped_conv.dgrad"] == before + 2
    assert torch.equal(got, again) and bool(torch.isfinite(got).all())
    x = torch.zeros((b_dim, n_draws * 32, 12, 12), device=cuda).contiguous(memory_format=fmt)
    library = torch.ops.aten.convolution_backward(g, x, gc.oihw(w), None, [1, 1], [0, 0], [1, 1], False, [0, 0],
                                                  n_draws, [True, False, False])[0]
    assert got.shape == library.shape and got.stride() == library.stride()
    del x, library
    with torch.no_grad():
        exact = gc.dgrad5x5_plain(g.double(), w.double())
        terms = gc.dgrad5x5_plain(g.double().abs(), w.double().abs())
        assert bool(((got.double() - exact).abs() <= (25 * hidden + 1) * 2.0**-24 * terms).all())
        del exact, terms


def test_per_sample_input_grads_on_a_conv_model(cuda, monkeypatch):
    """``_per_sample_input_grads`` (``vmap`` of ``grad``) on a CUDA f32 conv
    model of the kernel's widths: the transforms' wrapped tensors keep the
    trunk on ``F.conv2d``, so it launches no kernel and gives the bits it
    gives with the kernel's route switched off. Each draw's input gradient
    is near its one-draw autograd, whose forward is the kernel: the two conv
    routes round differently, and a max-pool window or leaky unit within that
    rounding of its switch sends a little of the gradient elsewhere, so the
    two are held together in norm."""
    from robustbnns_tpu_torch.analysis.gradients import _per_sample_input_grads, _summed_loss
    from robustbnns_tpu_torch.models import architectures
    from robustbnns_tpu_torch.ops import launch_counts
    from robustbnns_tpu_torch.utils.pytree import map_params

    arch = architectures.build_architecture("conv", "leaky", (28, 28, 1), 10, 512, "mnist")
    gen = torch.Generator(device=cuda).manual_seed(5)
    n_draws = 4
    params = map_params(lambda v: v[None].repeat(n_draws, *([1] * v.dim())) + 1e-2 * torch.randn(
        (n_draws,) + v.shape, generator=gen, device=cuda), arch.init(torch.Generator(device=cuda).manual_seed(5)))
    x = torch.rand((16, 28, 28, 1), generator=gen, device=cuda)
    labels = torch.randint(0, 10, (16,), generator=gen, device=cuda)
    before = launch_counts()["grouped_conv.fwd"]
    got = _per_sample_input_grads(arch.apply, params, x, labels)
    torch.cuda.synchronize()
    assert launch_counts()["grouped_conv.fwd"] == before
    for s in range(n_draws):
        xs = x.clone().requires_grad_(True)
        one = map_params(lambda v: v[s:s + 1], params)
        (want,) = torch.autograd.grad(_summed_loss(arch.apply, one, xs, labels), xs)
        assert float((got[s] - want).norm() / want.norm()) < 1e-2
    assert launch_counts()["grouped_conv.fwd"] == before + n_draws
    monkeypatch.setattr(architectures, "takes", lambda *args: False)
    assert torch.equal(got, _per_sample_input_grads(arch.apply, params, x, labels))


CONV3X3_SHAPES = [(16, 16, 1), (16, 32, 2), (32, 32, 1), (32, 64, 2), (64, 64, 1)]  # (Ci, Co, stride)


@pytest.mark.parametrize("shape", CONV3X3_SHAPES, ids=lambda s: "Ci{}_Co{}_stride{}".format(*s))
@pytest.mark.parametrize("mode", ["fwd", "dgrad"])
def test_grouped_conv3x3_kernel_against_float64(cuda, shape, mode):
    """``csrc/grouped_conv3x3.cu`` at ResNet-20's attack shapes (B 128, S
    100) against its plain twins in float64: the forward (``F.conv2d`` with
    ``groups=S``, padding 1) and the input gradient (the rotated conv, or
    the four parity classes at stride 2). Each output sums at most K = 9·C
    products (and the forward's bias) in f32 with FMAs in a fixed order, so it
    lies within (K + 1)·2⁻²⁴ of its terms' absolute sum of the exact value (a
    fault moves outputs by the size of a term, far beyond it). Bit-identical
    across two calls, one launch counted a call."""
    from robustbnns_tpu_torch.ops import launch_counts

    gc = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv")
    c_in, c_out, stride = shape
    side, b_dim, n_draws = gc.SHAPES3X3[shape], 128, 100
    gen = torch.Generator(device=cuda).manual_seed(c_in * 7919 + c_out * 31 + stride)
    w = torch.randn((n_draws, 3, 3, c_in, c_out), generator=gen, device=cuda) / (9 * c_in) ** 0.5
    if mode == "fwd":
        x = torch.rand((b_dim, n_draws * c_in, side, side), generator=gen, device=cuda)
        bias = 0.1 * torch.randn((n_draws, c_out), generator=gen, device=cuda)
        run = lambda: gc.grouped_conv_fwd(x, w, bias, stride, 1)  # noqa: E731
        twin = lambda f: gc.grouped_conv_plain(f(x), f(w), f(bias), stride, 1)  # noqa: E731
        k_terms = 9 * c_in + 1
    else:
        g = torch.randn((b_dim, n_draws * c_out, side // stride, side // stride), generator=gen, device=cuda)
        run = lambda: gc.grouped_conv_dgrad(g, w, stride, 1)  # noqa: E731
        twin = lambda f: gc.dgrad3x3_plain(f(g), f(w), stride)  # noqa: E731
        k_terms = 9 * c_out
    counter = f"grouped_conv3x3.{mode}"
    before = launch_counts()[counter]
    got, again = run(), run()
    torch.cuda.synchronize()
    assert launch_counts()[counter] == before + 2
    assert torch.equal(got, again) and bool(torch.isfinite(got).all())
    with torch.no_grad():
        exact = twin(lambda t: t.double())
        terms = twin(lambda t: t.double().abs())
        assert got.shape == exact.shape
        assert bool(((got.double() - exact).abs() <= (k_terms + 1) * 2.0**-24 * terms).all())
        del exact, terms


def test_resnet20_pgd_iteration_runs_the_3x3_kernel(cuda):
    """One PGD iteration on a ``resnet20`` posterior at S 10, B 16, in f32 on
    the card: its forward runs the 18 grouped 3×3 convs on the kernel and
    the first conv alone on ``F.conv2d``, and its input gradient runs the
    kernel's 18 input gradients."""
    from robustbnns_tpu_torch.attacks.gradient_attacks import pgd_attack
    from robustbnns_tpu_torch.config import BNNConfig
    from robustbnns_tpu_torch.inference import svi
    from robustbnns_tpu_torch.models.bnn import BNN
    from robustbnns_tpu_torch.ops import launch_counts
    from robustbnns_tpu_torch.utils import timing
    from robustbnns_tpu_torch.utils.pytree import map_params

    config = BNNConfig("cifar", 16, "relu", "resnet20", "svi", epochs=1, lr=0.01)
    bnn = BNN.from_config(config, (32, 32, 3), 10, device="cuda")
    loc = bnn.arch.init(torch.Generator(device=cuda).manual_seed(3))
    bnn.posterior = svi.MeanFieldPosterior(loc=loc, rho=map_params(lambda v: torch.full_like(v, -5.0), loc))
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.rand((16, 32, 32, 3), generator=gen, device=cuda)
    y = torch.randint(0, 10, (16,), generator=gen, device=cuda)
    before = {**launch_counts(), **timing.counters()}
    x_adv = pgd_attack(bnn.predictive_fn(10), x, y, epsilon=8 / 255, iters=1,
                       generator=torch.Generator().manual_seed(5))  # the CLI's CPU generator
    torch.cuda.synchronize()
    after = {**launch_counts(), **timing.counters()}
    delta = {k: after[k] - before.get(k, 0) for k in ("grouped_conv3x3.fwd", "grouped_conv3x3.dgrad",
                                                       "resnet.cudnn_convs", "attack.iterations")}
    assert delta == {"grouped_conv3x3.fwd": 18, "grouped_conv3x3.dgrad": 18, "resnet.cudnn_convs": 1,
                     "attack.iterations": 1}
    assert bool(torch.isfinite(x_adv).all()) and float((x_adv - x).abs().max()) <= 8 / 255 + 1e-6
