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
    (45, 70, 66, 2),  # ragged B, I and O past the 64 x 64 dparams tile
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
