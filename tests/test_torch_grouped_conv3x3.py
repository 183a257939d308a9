"""ResNet-20's grouped 3×3 convolutions (``ops/grouped_conv3x3.py``) on the CPU.

The plain twins are the kernel's two functions: the forward is ``F.conv2d``
with ``groups=S``, padding 1, on the permuted stacked weights; the input
gradient is a 3×3 conv of the output gradient with each tap rotated 180° and
transposed (stride 1), or four parity classes of 2×2 convs put in place
(stride 2). On integer-valued inputs every product and sum is exact in f32,
whatever the order, so the twins meet ``F.conv2d`` and
``torch.nn.grad.conv2d_input`` bit for bit there and a wrong tap, offset or
transposition cannot hide in rounding. :class:`GroupedConv3x3` on CPU tensors
runs the twins, with the library's weight and bias gradients. The residual
trunk sends only CUDA f32 calls of the kernel's shapes to it (with
``takes3x3`` answering as it would on the card here); the wrapper raises on
what the kernel does not take. The kernel itself is checked on the card
(``tests/test_torch_kernels.py``) and its source on the CPU
(``tests/test_torch_kernel_emulation.py``).
"""
import importlib

import pytest
import torch
import torch.nn.functional as F

import robustbnns_tpu_torch.ops as ops
from robustbnns_tpu_torch.analysis.gradients import _per_sample_input_grads, _summed_loss
from robustbnns_tpu_torch.models import architectures
from robustbnns_tpu_torch.models.architectures import build_architecture
from robustbnns_tpu_torch.ops.grouped_conv import oihw
from robustbnns_tpu_torch.utils import timing
from robustbnns_tpu_torch.utils.device import bf16_scope
from robustbnns_tpu_torch.utils.pytree import map_params

# the modules, not the ops of the same names that robustbnns_tpu_torch.ops exports
g3 = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv3x3")
gc = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv")

SHAPES = list(g3.SHAPES)
IDS = ["Ci{}_Co{}_stride{}".format(*s) for s in SHAPES]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's convs, as in ``tests/test_torch_resnet.py``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def conv_inputs(shape, b_dim=2, n_draws=3, integers=False, seed=0):
    """x, w, b and an output gradient g of one of the kernel's shapes; with
    ``integers`` every entry an integer in [-3, 3], so all sums are exact."""
    c_in, c_out, stride = shape
    side = g3.SHAPES[shape]
    gen = torch.Generator().manual_seed(seed + c_in + 7 * c_out + stride)

    def draw(*dims, scale):
        if integers:
            return torch.randint(-3, 4, dims, generator=gen).float()
        return scale * torch.randn(dims, generator=gen)

    return (draw(b_dim, n_draws * c_in, side, side, scale=1.0),
            draw(n_draws, 3, 3, c_in, c_out, scale=(9 * c_in) ** -0.5),
            draw(n_draws, c_out, scale=0.1),
            draw(b_dim, n_draws * c_out, side // stride, side // stride, scale=1.0))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_the_twins_are_conv2d_and_its_input_gradient_bit_for_bit(shape):
    """On integer-valued inputs: the forward twin equals ``F.conv2d`` on each
    draw's own channels, the input-gradient twin equals
    ``torch.nn.grad.conv2d_input`` of the grouped conv, and at stride 2 the
    input gradient is the sum of its four parity classes, each on its own
    pixels."""
    c_in, c_out, stride = shape
    x, w, b, g = conv_inputs(shape, integers=True)
    n_draws = w.shape[0]
    want = torch.cat([F.conv2d(x[:, c_in * s:c_in * (s + 1)], w[s].permute(3, 2, 0, 1), b[s], stride, 1)
                      for s in range(n_draws)], dim=1)
    assert torch.equal(g3.grouped_conv3x3_plain(x, w, b, stride), want)
    dx = torch.nn.grad.conv2d_input(x.shape, oihw(w), g, stride, 1, 1, n_draws)
    assert torch.equal(g3.grouped_conv3x3_dgrad_plain(g, w, stride), dx)
    if stride == 2:
        total = torch.zeros_like(dx)
        for py in range(2):
            for px in range(2):
                part = torch.zeros_like(dx)
                part[:, :, py::2, px::2] = g3.parity_class(g, w, py, px)
                total += part
        assert torch.equal(total, dx)
        assert [len(g3.parity_taps(p)) for p in range(2)] == [1, 2]  # 1, 2, 2 and 4 taps a class


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("asked", ["all", "input"])
def test_the_autograd_function_is_conv2d_on_the_cpu(shape, asked):
    """:class:`GroupedConv3x3` on CPU tensors: its output is ``F.conv2d``'s bit
    for bit, its input gradient the rotated conv's (to f32 rounding of at most
    9·64-term sums), its weight and bias gradients the library's bit for bit,
    each computed only where asked for."""
    c_in, c_out, stride = shape
    x, w, b, g = conv_inputs(shape)
    wants = (True, asked == "all", asked == "all")
    ours = [t.clone().requires_grad_(want) for t, want in zip((x, w, b), wants)]
    lib = [t.clone().requires_grad_(want) for t, want in zip((x, w, b), wants)]
    out = g3.grouped_conv3x3(*ours, stride)
    ref = F.conv2d(lib[0], oihw(lib[1]), lib[2].reshape(-1), stride, 1, 1, w.shape[0])
    assert torch.equal(out, ref)
    out.backward(g)
    ref.backward(g)
    torch.testing.assert_close(ours[0].grad, lib[0].grad, rtol=0, atol=1e-5 * float(lib[0].grad.abs().max()))
    for got, want, asked_for in zip(ours[1:], lib[1:], wants[1:]):
        assert (got.grad is None) == (not asked_for)
        if asked_for:
            assert got.grad.shape == got.shape and torch.equal(got.grad, want.grad)


def test_the_kernels_shapes():
    """``fits3x3`` takes the five shapes in f32 at padding 1 on their sides,
    NCHW contiguous; ``takes3x3`` never on the CPU; both refuse bf16 (tensors
    or products), ``torch.func``-wrapped tensors, other widths, strides,
    sides, paddings and kernel sides."""
    for shape in SHAPES:
        x, w, b, _ = conv_inputs(shape)
        stride = shape[2]
        assert g3.fits3x3(x, w, b, stride, 1) and not g3.takes3x3(x, w, b, stride, 1)
        assert not g3.fits3x3(x, w, b, stride, 0)  # padding
        assert not g3.fits3x3(x, w, b, 3 - stride, 1)  # the other stride
        assert not g3.fits3x3(x.to(torch.bfloat16), w, b, stride, 1)
        assert not g3.fits3x3(x[:0], w, b, stride, 1)  # an empty batch
        assert not g3.fits3x3(x[:, :, :4, :4].contiguous(), w, b, stride, 1)  # another side
        assert not g3.fits3x3(x.contiguous(memory_format=torch.channels_last), w, b, stride, 1)
        with bf16_scope():
            assert not g3.fits3x3(x, w, b, stride, 1)
    x, w, b, _ = conv_inputs((16, 16, 1))
    wide = torch.zeros((3, 3, 3, 16, 24))  # a width of no shape
    assert not g3.fits3x3(x, wide, torch.zeros((3, 24)), 1, 1)
    five = torch.zeros((3, 5, 5, 16, 16))  # a 5×5 filter
    assert not g3.fits3x3(x, five, b, 1, 1)
    seen = []
    torch.func.vmap(lambda xi: seen.append(g3.fits3x3(xi[None], w, b, 1, 1)) or xi)(x)
    assert seen == [False]


FAULTS = ["dtype", "width", "side", "stride", "not_contiguous", "device"]


@pytest.mark.parametrize("mode,fault", [("fwd", f) for f in FAULTS + ["bias"]] + [("dgrad", f) for f in FAULTS])
def test_the_wrappers_raise_on_what_the_kernel_does_not_take(mode, fault):
    x, w, b, g = conv_inputs((32, 64, 2))
    stride, error = 2, ValueError
    if fault == "dtype":
        x, g, error = x.double(), g.double(), TypeError
    elif fault == "width":
        w, b = w[..., :48].contiguous(), b[:, :48].contiguous()
    elif fault == "side":
        x, g = x[:, :, :8, :8].contiguous(), g[:, :, :4, :4].contiguous()
    elif fault == "stride":
        stride = 1
    elif fault == "bias":
        b = b.reshape(-1)
    elif fault == "not_contiguous":
        x, g = x.transpose(2, 3), g.transpose(2, 3)
    else:
        w = w.to("meta")
    with pytest.raises(error):
        if mode == "fwd":
            g3.grouped_conv3x3_fwd(x, w, b, stride)
        else:
            g3.grouped_conv3x3_dgrad(g, w, stride)


def resnet(n_draws=2, seed=3):
    arch = build_architecture("resnet20", "relu", (32, 32, 3), 10, 16, "cifar")
    gen = torch.Generator().manual_seed(seed)
    params = map_params(lambda v: v[None].repeat(n_draws, *([1] * v.dim())) + 1e-2 * torch.randn(
        (n_draws,) + v.shape, generator=gen), arch.init(gen))
    x = torch.rand((2, 32, 32, 3), generator=gen)
    return arch, params, x, torch.tensor([1, 7])


def test_the_trunk_takes_the_kernel_where_it_fits_and_counts_one_library_conv(monkeypatch):
    """With ``takes3x3`` answering as it would on the card, a ResNet-20
    forward sends each of its 18 grouped convs to the kernel's function with
    the stacked weights as they are (9 shapes of stage 1 ... 3, two with
    stride 2), keeps its logits and input gradient, and counts one conv run by
    ``F.conv2d`` (the first); under bf16 products all 19 stay on ``F.conv2d``."""
    calls = []

    def recorded(x, w, b, stride):
        calls.append((tuple(w.shape[3:]), stride))
        return g3.grouped_conv3x3(x, w, b, stride)

    arch, params, x, labels = resnet()
    want_logits = arch.apply(params, x)
    monkeypatch.setattr(architectures, "takes3x3", g3.fits3x3)
    monkeypatch.setattr(architectures, "grouped_conv3x3", recorded)
    xt = x.clone().requires_grad_(True)
    before = timing.counters().get("resnet.cudnn_convs", 0)
    got = arch.apply(params, xt)
    assert timing.counters()["resnet.cudnn_convs"] - before == 1
    assert calls == [((16, 16), 1)] * 6 + [((16, 32), 2)] + [((32, 32), 1)] * 5 + [((32, 64), 2)] + [
        ((64, 64), 1)] * 5
    torch.testing.assert_close(got, want_logits, rtol=0, atol=1e-6 * float(want_logits.abs().max()))
    (grad,) = torch.autograd.grad(got.sum(), xt)
    xr = x.clone().requires_grad_(True)
    monkeypatch.undo()
    (want,) = torch.autograd.grad(arch.apply(params, xr).sum(), xr)
    torch.testing.assert_close(grad, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    monkeypatch.setattr(architectures, "takes3x3", g3.fits3x3)
    monkeypatch.setattr(architectures, "grouped_conv3x3", recorded)
    calls.clear()
    before = timing.counters()["resnet.cudnn_convs"]
    with bf16_scope():
        arch.apply(params, x)
    assert calls == [] and timing.counters()["resnet.cudnn_convs"] - before == 19


def test_model0_keeps_its_5x5_route(monkeypatch):
    """With both kernels' checks answering as they would on the card, the
    conv trunk's 5×5 VALID second conv still goes to ``ops.grouped_conv``
    alone: the 3×3 kernel's check refuses it."""
    routes = []
    monkeypatch.setattr(architectures, "takes", gc._fits)
    monkeypatch.setattr(architectures, "takes3x3", g3.fits3x3)
    monkeypatch.setattr(architectures, "grouped_conv", lambda *a: routes.append("5x5") or gc.grouped_conv(*a))
    monkeypatch.setattr(architectures, "grouped_conv3x3", lambda *a: routes.append("3x3") or g3.grouped_conv3x3(*a))
    arch = build_architecture("conv", "leaky", (28, 28, 1), 10, 128, "mnist")
    gen = torch.Generator().manual_seed(4)
    params = map_params(lambda v: v[None].repeat(2, *([1] * v.dim())), arch.init(gen))
    arch.apply(params, torch.rand((3, 28, 28, 1), generator=gen))
    assert routes == ["5x5"]
    assert not g3.fits3x3(torch.rand(3, 64, 12, 12), params[1]["w"], params[1]["b"], 1, 0)


def test_the_trunk_keeps_conv2d_inside_torch_func_transforms(monkeypatch):
    """``_per_sample_input_grads`` (``vmap`` of ``grad``) on ``resnet20``:
    with ``takes3x3`` answering as it would on the card, the wrapped tensors
    of the transforms do not fit the kernel, so the trunk keeps ``F.conv2d``
    (all 19 convs counted there) and each draw's gradient equals its own
    one-draw autograd, which takes the kernel's route."""
    calls = []
    monkeypatch.setattr(architectures, "takes3x3", g3.fits3x3)
    monkeypatch.setattr(architectures, "grouped_conv3x3", lambda *a: calls.append(a) or g3.grouped_conv3x3(*a))
    arch, params, x, labels = resnet()
    before = timing.counters().get("resnet.cudnn_convs", 0)
    got = _per_sample_input_grads(arch.apply, params, x, labels)
    assert calls == [] and timing.counters()["resnet.cudnn_convs"] - before == 19
    for s in range(2):
        xs = x.clone().requires_grad_(True)
        one = map_params(lambda v: v[s:s + 1], params)
        (want,) = torch.autograd.grad(_summed_loss(arch.apply, one, xs, labels), xs)
        assert len(calls) == 18 * (s + 1)  # outside the transforms the one-draw apply takes the kernel's route
        torch.testing.assert_close(got[s], want, rtol=1e-4, atol=1e-6 * float(want.abs().max()))


def test_launch_counts_report_the_grouped_conv3x3():
    ops.reset_launch_counts()
    counts = ops.launch_counts()
    assert counts["grouped_conv3x3.fwd"] == counts["grouped_conv3x3.dgrad"] == 0
    x, w, b, g = conv_inputs((16, 16, 1), b_dim=1, n_draws=1)
    g3.grouped_conv3x3_fwd(x, w, b, 1)  # the plain twins: no launch
    g3.grouped_conv3x3_dgrad(g, w, 1)
    assert ops.launch_counts()["grouped_conv3x3.fwd"] == ops.launch_counts()["grouped_conv3x3.dgrad"] == 0
