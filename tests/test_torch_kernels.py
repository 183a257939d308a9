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
        before = kernel.launches
        got = kernel(*args, s, seed)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
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
        before = (dx_kernel.launches, dp_kernel.launches)
        (op(xr, *params, s, 9) * p["g"]).sum().backward()
        assert (dx_kernel.launches, dp_kernel.launches) == (before[0] + 1, before[1])
        assert_close(xr.grad, dx_kernel(p["g"], p["loc"], p["rho"], s, 9))
        leaves = [t.clone().requires_grad_(True) for t in params]
        grads = torch.autograd.grad((op(x, *leaves, s, 9) * p["g"]).sum(), leaves)
        assert (dx_kernel.launches, dp_kernel.launches) == (before[0] + 2, before[1] + 1)
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
        before, f32_before = kernel.launches, public.launches
        got = public(a, *rest, s, seed)
        again = public(a, *rest, s, seed)
        torch.cuda.synchronize()
        assert (kernel.launches, public.launches) == (before + 2, f32_before)
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
        before, f32_before = kernel.launches, public.launches
        got, again = public(*args), public(*args)
        torch.cuda.synchronize()
        assert (kernel.launches, public.launches) == (before + 2, f32_before), kind
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
