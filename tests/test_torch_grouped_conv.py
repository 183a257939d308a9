"""The grouped-by-draw convolutions of ``ops/grouped_conv.py`` on the CPU.

Two kinds (:data:`KINDS`): the conv trunk's 5×5 VALID second conv and
ResNet-20's residual 3×3 convs (padding 1, stride 1 or 2). :class:`GroupedConv`
on CPU tensors runs the plain functions: the forward is ``F.conv2d`` with
``groups=S`` on the permuted stacked weights; the 5×5 kind's input gradient is
``F.conv_transpose2d`` on those weights, in the output gradient's layout; the
3×3 kind's is a 3×3 conv of the output gradient with each tap rotated 180° and
transposed (stride 1), or four parity classes of 2×2 convs put in place
(stride 2); the weight and bias gradients are the library's backward
(``aten.convolution_backward``, what autograd's ``ConvolutionBackward0``
calls), asked for those two alone. On integer-valued inputs every product and
sum is exact in f32, whatever the order, so the twins meet ``F.conv2d`` and its
autograd input gradient bit for bit there and a wrong tap, offset or
transposition cannot hide in rounding. The trunks send only CUDA f32 calls of
a kind's shapes to its kernel (with ``takes`` answering as it would on the
card here, through ``fits``): on the CPU, under ``bf16_scope``, inside
``torch.func`` transforms and at other shapes they compute what ``F.conv2d``
did before. The wrappers raise on what the kernels do not take. The kernels
themselves are checked on the card (``tests/test_torch_kernels.py``) and their
sources on the CPU (``tests/test_torch_kernel_emulation.py``).
"""
import importlib

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

import robustbnns_tpu_torch.ops as ops
from robustbnns_tpu_torch.analysis.gradients import _per_sample_input_grads, _summed_loss
from robustbnns_tpu_torch.models import architectures
from robustbnns_tpu_torch.models.architectures import build_architecture
from robustbnns_tpu_torch.ops.grouped_conv import oihw
from robustbnns_tpu_torch.utils import timing
from robustbnns_tpu_torch.utils.device import bf16_scope
from robustbnns_tpu_torch.utils.pytree import map_params

# the module, not the op of the same name that robustbnns_tpu_torch.ops exports
gc = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv")

SHAPES3X3 = list(gc.SHAPES3X3)
IDS3X3 = ["Ci{}_Co{}_stride{}".format(*s) for s in SHAPES3X3]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's convs, as in ``tests/test_torch_resnet.py``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def is_channels_last(t):
    return not t.is_contiguous() and t.is_contiguous(memory_format=torch.channels_last)


def conv_inputs(b_dim, n_draws, hidden, seed=0):
    """x, w, b and an output gradient g of the 5×5 kind."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((b_dim, 32 * n_draws, 12, 12), generator=gen)
    w = torch.randn((n_draws, 5, 5, 32, hidden), generator=gen) / 800**0.5
    b = 0.1 * torch.randn((n_draws, hidden), generator=gen)
    g = torch.randn((b_dim, n_draws * hidden, 8, 8), generator=gen)
    return x, w, b, g


def conv3x3_inputs(shape, b_dim=2, n_draws=3, integers=False, seed=0):
    """x, w, b and an output gradient g of one of the 3×3 kind's shapes; with
    ``integers`` every entry an integer in [-3, 3], so all sums are exact."""
    c_in, c_out, stride = shape
    side = gc.SHAPES3X3[shape]
    gen = torch.Generator().manual_seed(seed + c_in + 7 * c_out + stride)

    def draw(*dims, scale):
        if integers:
            return torch.randint(-3, 4, dims, generator=gen).float()
        return scale * torch.randn(dims, generator=gen)

    return (draw(b_dim, n_draws * c_in, side, side, scale=1.0),
            draw(n_draws, 3, 3, c_in, c_out, scale=(9 * c_in) ** -0.5),
            draw(n_draws, c_out, scale=0.1),
            draw(b_dim, n_draws * c_out, side // stride, side // stride, scale=1.0))


class LibraryBackwardMasks(TorchDispatchMode):
    """Records the output mask (dx, dw, db asked for) of each
    ``aten.convolution_backward`` call made inside it."""

    def __init__(self):
        super().__init__()
        self.masks = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket is torch.ops.aten.convolution_backward:
            self.masks.append(list(args[10]))
        return func(*args, **(kwargs or {}))


# (x, w, b, g, stride, padding) of each kind's calls in the tests below
AUTOGRAD_CASES = [pytest.param(("5x5", n_draws, hidden, layout), id=f"5x5-{layout}-S{n_draws}-Co{hidden}")
                  for layout in ("nchw", "channels_last") for hidden in (128, 256) for n_draws in (1, 3)]
AUTOGRAD_CASES += [pytest.param(("3x3", shape), id=f"3x3-{i}") for shape, i in zip(SHAPES3X3, IDS3X3)]


def case_inputs(case):
    if case[0] == "3x3":
        return (*conv3x3_inputs(case[1]), case[1][2], 1)
    _, n_draws, hidden, layout = case
    x, w, b, g = conv_inputs(2, n_draws, hidden)
    if layout == "channels_last":
        x, g = x.contiguous(memory_format=torch.channels_last), g.contiguous(memory_format=torch.channels_last)
    return x, w, b, g, 1, 0


@pytest.mark.parametrize("asked", ["all", "input"])
@pytest.mark.parametrize("case", AUTOGRAD_CASES)
def test_the_autograd_function_is_conv2d_on_the_cpu(case, asked):
    """:class:`GroupedConv` on CPU tensors: its output is ``F.conv2d``'s bit
    for bit, in the input's layout; its weight and bias gradients the
    library's bit for bit, each computed only where asked for, from one
    library call that asks for those two alone; its input gradient the dgrad
    twin's: the library's bit for bit, in the input's layout (5×5), and the
    rotated conv's (3×3: to f32 rounding of at most 9·64-term sums)."""
    x, w, b, g, stride, padding = case_inputs(case)
    wants = (True, asked == "all", asked == "all")
    ours = [t.clone().requires_grad_(want) for t, want in zip((x, w, b), wants)]
    lib = [t.clone().requires_grad_(want) for t, want in zip((x, w, b), wants)]
    out = gc.grouped_conv(*ours, stride, padding)
    ref = F.conv2d(lib[0], oihw(lib[1]), lib[2].reshape(-1), stride, padding, 1, w.shape[0])
    assert torch.equal(out, ref) and is_channels_last(out) == is_channels_last(x)
    with LibraryBackwardMasks() as library:
        out.backward(g)
    assert library.masks == ([[False, True, True]] if asked == "all" else [])
    ref.backward(g)
    if case[0] == "5x5":
        assert torch.equal(ours[0].grad, lib[0].grad) and is_channels_last(ours[0].grad) == is_channels_last(x)
    else:
        torch.testing.assert_close(ours[0].grad, lib[0].grad, rtol=0, atol=1e-5 * float(lib[0].grad.abs().max()))
    for got, want, asked_for in zip(ours[1:], lib[1:], wants[1:]):
        assert (got.grad is None) == (not asked_for)
        if asked_for:
            assert got.grad.shape == got.shape and torch.equal(got.grad, want.grad)


@pytest.mark.parametrize("shape", SHAPES3X3 + ["5x5"], ids=IDS3X3 + ["5x5"])
def test_the_twins_are_conv2d_and_its_input_gradient_bit_for_bit(shape):
    """On integer-valued inputs: the 3×3 forward twin equals ``F.conv2d`` on
    each draw's own channels, the input-gradient twin equals
    ``torch.nn.grad.conv2d_input`` of the grouped conv, and at stride 2 the
    input gradient is the sum of its four parity classes, each on its own
    pixels; the 5×5 input-gradient twin equals the autograd input gradient
    of ``F.conv2d`` with ``groups=S``, NCHW and channels-last, in its
    layout."""
    if shape == "5x5":
        gen = torch.Generator().manual_seed(5)
        x, w, g = (torch.randint(-3, 4, dims, generator=gen).float()
                   for dims in ((2, 3 * 32, 12, 12), (3, 5, 5, 32, 128), (2, 3 * 128, 8, 8)))
        for fmt in (torch.contiguous_format, torch.channels_last):
            xr = x.clone(memory_format=fmt).requires_grad_(True)
            g_fmt = g.contiguous(memory_format=fmt)
            F.conv2d(xr, oihw(w), None, 1, 0, 1, 3).backward(g_fmt)
            got = gc.dgrad5x5_plain(g_fmt, w)
            assert torch.equal(got, xr.grad) and got.stride() == xr.grad.stride()
        return
    c_in, c_out, stride = shape
    x, w, b, g = conv3x3_inputs(shape, integers=True)
    n_draws = w.shape[0]
    want = torch.cat([F.conv2d(x[:, c_in * s:c_in * (s + 1)], w[s].permute(3, 2, 0, 1), b[s], stride, 1)
                      for s in range(n_draws)], dim=1)
    assert torch.equal(gc.grouped_conv_plain(x, w, b, stride, 1), want)
    dx = torch.nn.grad.conv2d_input(x.shape, oihw(w), g, stride, 1, 1, n_draws)
    assert torch.equal(gc.dgrad3x3_plain(g, w, stride), dx)
    if stride == 2:
        total = torch.zeros_like(dx)
        for py in range(2):
            for px in range(2):
                part = torch.zeros_like(dx)
                part[:, :, py::2, px::2] = gc.parity_class(g, w, py, px)
                total += part
        assert torch.equal(total, dx)
        assert [len(gc.parity_taps(p)) for p in range(2)] == [1, 2]  # 1, 2, 2 and 4 taps a class


@pytest.mark.parametrize("kind", ["5x5", "3x3"])
def test_the_kernels_shapes(kind):
    """``fits`` takes each kind's shapes in f32 at its stride and padding, in
    the layouts its kernel reads (5×5: NCHW or channels-last; 3×3: NCHW
    contiguous); ``takes`` never on the CPU; both refuse bf16 (tensors or
    products), ``torch.func``-wrapped tensors, an empty batch, other widths,
    strides, sides, paddings and kernel sides."""
    if kind == "5x5":
        x, w, b, _ = conv_inputs(2, 3, 128)
        assert gc.fits(x, w, b) and not gc.takes(x, w, b)  # the CPU never takes the kernel
        assert not gc.fits(x, w, b, 1, 1) and not gc.fits(x, w, b, 2, 0)  # padding, stride
        assert not gc.fits(x[:, :, :6, :6].contiguous(), w, b)  # conv2's 6x6 input on 16x16 images
        _, w64, b64, _ = conv_inputs(2, 3, 64)
        assert not gc.fits(x, w64, b64)  # hidden below the tile
        assert not gc.fits(x.to(torch.bfloat16), w, b)
        assert not gc.fits(x[:0], w, b)  # an empty batch
        assert gc.fits(x.contiguous(memory_format=torch.channels_last), w, b)
        assert not gc.fits(x.transpose(2, 3), w, b)  # neither NCHW nor channels-last
        with bf16_scope():
            assert not gc.fits(x, w, b)
        g = conv_inputs(2, 3, 128)[3]
        dgrad = gc.KINDS[(5, 1, 0)].dgrad
        assert dgrad.fits(g, w, 1) and dgrad.fits(g.contiguous(memory_format=torch.channels_last), w, 1)
        assert not dgrad.fits(g.transpose(2, 3), w, 1) and not dgrad.fits(g[:, :, :6, :6].contiguous(), w, 1)
        assert dgrad.layout(x) == torch.contiguous_format
        assert dgrad.layout(x.contiguous(memory_format=torch.channels_last)) == torch.channels_last
        return
    for shape in SHAPES3X3:
        x, w, b, _ = conv3x3_inputs(shape)
        stride = shape[2]
        assert gc.fits(x, w, b, stride, 1) and not gc.takes(x, w, b, stride, 1)
        assert not gc.fits(x, w, b, stride, 0)  # padding
        assert not gc.fits(x, w, b, 3 - stride, 1)  # the other stride
        assert not gc.fits(x.to(torch.bfloat16), w, b, stride, 1)
        assert not gc.fits(x[:0], w, b, stride, 1)  # an empty batch
        assert not gc.fits(x[:, :, :4, :4].contiguous(), w, b, stride, 1)  # another side
        assert not gc.fits(x.contiguous(memory_format=torch.channels_last), w, b, stride, 1)
        with bf16_scope():
            assert not gc.fits(x, w, b, stride, 1)
    x, w, b, _ = conv3x3_inputs((16, 16, 1))
    wide = torch.zeros((3, 3, 3, 16, 24))  # a width of no shape
    assert not gc.fits(x, wide, torch.zeros((3, 24)), 1, 1)
    five = torch.zeros((3, 5, 5, 16, 16))  # a 5×5 filter
    assert not gc.fits(x, five, b, 1, 1)
    seen = []
    torch.func.vmap(lambda xi: seen.append(gc.fits(xi[None], w, b, 1, 1)) or xi)(x)
    assert seen == [False]


@pytest.mark.parametrize("key", list(gc.KINDS), ids=lambda k: "k{}_stride{}_padding{}".format(*k))
def test_no_kind_is_taken_under_bf16_products(key):
    """Each kind of :data:`KINDS` fits its own f32 inputs, and under
    ``bf16_products()`` none does: the architectures then run the conv
    wholly in bf16 on ``F.conv2d``."""
    side, stride, padding = key
    if side == 5:
        x, w, b, _ = conv_inputs(2, 2, 128)
    else:
        x, w, b, _ = conv3x3_inputs(next(s for s in SHAPES3X3 if s[2] == stride))
    assert gc.fits(x, w, b, stride, padding)
    with bf16_scope():
        assert not gc.fits(x, w, b, stride, padding)
    assert gc.fits(x, w, b, stride, padding)


FAULTS = ["dtype", "width", "side", "stride", "not_contiguous", "device"]
RAISES = [("5x5", f) for f in ["dtype", "width", "input_side", "channels", "bias", "not_contiguous"]]
RAISES += [("5x5_dgrad", f) for f in ["dtype", "width", "output_side", "not_contiguous"]]
RAISES += [("fwd", f) for f in FAULTS + ["bias"]] + [("dgrad", f) for f in FAULTS]


@pytest.mark.parametrize("mode,fault", RAISES)
def test_the_wrappers_raise_on_what_the_kernel_does_not_take(mode, fault):
    """The 5×5 kind's forward and input gradient, and the 3×3 kind's forward
    and input gradient (``mode`` ``fwd`` and ``dgrad``, at (32, 64, 2)), on
    what their kernels do not take, on the CPU as on the card."""
    if mode == "5x5":
        x, w, b, _ = conv_inputs(2, 2, 128)
        error = ValueError
        if fault == "dtype":
            x, error = x.double(), TypeError
        elif fault == "width":
            _, w, b, _ = conv_inputs(2, 2, 96)
        elif fault == "input_side":
            x = x[:, :, :10, :10].contiguous()
        elif fault == "channels":
            x = x[:, :32].contiguous()
        elif fault == "bias":
            b = b.reshape(-1)
        else:  # neither NCHW nor channels-last
            x = x.transpose(2, 3)
        with pytest.raises(error):
            gc.grouped_conv_fwd(x, w, b)
        return
    if mode == "5x5_dgrad":
        _, w, _, g = conv_inputs(2, 2, 128)
        error = ValueError
        if fault == "dtype":
            g, error = g.double(), TypeError
        elif fault == "width":
            _, w, _, g = conv_inputs(2, 2, 96)
        elif fault == "output_side":
            g = g[:, :, :6, :6].contiguous()
        else:  # neither NCHW nor channels-last
            g = g.transpose(2, 3)
        with pytest.raises(error):
            gc.grouped_conv_dgrad(g, w, 1, 0)
        return
    x, w, b, g = conv3x3_inputs((32, 64, 2))
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
            gc.grouped_conv_fwd(x, w, b, stride, 1)
        else:
            gc.grouped_conv_dgrad(g, w, stride, 1)


def trunk_before(act, params, x):
    """``_conv_trunk_apply`` as it was before the kernel: both convs on
    ``architectures._conv2d`` (``F.conv2d``, or its bf16 form)."""
    n_draws = params[0]["w"].shape[0]
    h = architectures._conv2d(x.permute(0, 3, 1, 2), oihw(params[0]["w"]), params[0]["b"].reshape(-1), 1)
    h = F.max_pool2d(act(h), 2, 2)
    h = architectures._conv2d(h, oihw(params[1]["w"]), params[1]["b"].reshape(-1), n_draws)
    h = F.max_pool2d(act(h), 2, 1)
    batch, _, h4, w4 = h.shape
    h = h.reshape(batch, n_draws, -1, h4, w4).permute(1, 0, 3, 4, 2).reshape(n_draws, batch, -1)
    return architectures._dense(h, params[2])


def stacked_conv(hidden, n_draws=2, seed=3):
    arch = build_architecture("conv", "leaky", (28, 28, 1), 10, hidden, "mnist")
    gen = torch.Generator().manual_seed(seed)
    params = map_params(lambda v: v[None].repeat(n_draws, *([1] * v.dim())) + 1e-2 * torch.randn(
        (n_draws,) + v.shape, generator=gen), arch.init(gen))
    return arch, params, torch.rand((3, 28, 28, 1), generator=gen)


def resnet(n_draws=2, seed=3):
    arch = build_architecture("resnet20", "relu", (32, 32, 3), 10, 16, "cifar")
    gen = torch.Generator().manual_seed(seed)
    params = map_params(lambda v: v[None].repeat(n_draws, *([1] * v.dim())) + 1e-2 * torch.randn(
        (n_draws,) + v.shape, generator=gen), arch.init(gen))
    x = torch.rand((2, 32, 32, 3), generator=gen)
    return arch, params, x, torch.tensor([1, 7])


@pytest.mark.parametrize("hidden,bf16", [(128, False), (128, True), (64, False)],
                         ids=["cpu", "bf16_scope", "below_the_tile"])
def test_the_trunk_keeps_its_numbers_where_the_kernel_does_not_run(hidden, bf16):
    arch, params, x = stacked_conv(hidden)
    ops.reset_launch_counts()
    with bf16_scope(bf16):
        got = arch.apply(params, x)
        want = trunk_before(architectures.ACTIVATIONS["leaky"], params, x)
    assert torch.equal(got, want)
    assert ops.launch_counts()["grouped_conv.fwd"] == 0


def test_the_trunk_takes_the_kernel_where_it_fits_and_not_under_bf16(monkeypatch):
    """With ``takes`` answering as it would on the card, the conv trunk sends
    the second conv to the 5×5 kind with the stacked weights as they are and
    the first conv's output in its channels-last layout, and under
    ``bf16_scope`` keeps it on ``F.conv2d``."""
    calls = []

    def recorded(x, w, b, stride, padding):
        calls.append((*(t.shape for t in (x, w, b)), is_channels_last(x), stride, padding))
        return gc.grouped_conv_plain(x, w, b, stride, padding)

    monkeypatch.setattr(architectures, "takes", gc.fits)
    monkeypatch.setattr(architectures, "grouped_conv", recorded)
    arch, params, x = stacked_conv(128, n_draws=2)
    want = trunk_before(architectures.ACTIVATIONS["leaky"], params, x)
    assert torch.equal(arch.apply(params, x), want)
    assert calls == [((3, 64, 12, 12), (2, 5, 5, 32, 128), (2, 128), True, 1, 0)]
    with bf16_scope():
        arch.apply(params, x)
    assert len(calls) == 1


def test_the_trunk_takes_the_kernel_where_it_fits_and_counts_one_library_conv(monkeypatch):
    """With ``takes`` answering as it would on the card, a ResNet-20 forward
    sends each of its 18 grouped convs to the 3×3 kind with the stacked
    weights as they are (9 shapes of stage 1 ... 3, two with stride 2),
    keeps its logits and input gradient, and counts one conv run by
    ``F.conv2d`` (the first); under bf16 products all 19 stay on ``F.conv2d``."""
    calls = []

    def recorded(x, w, b, stride, padding):
        calls.append((tuple(w.shape[1:]), stride, padding))
        return gc.grouped_conv(x, w, b, stride, padding)

    arch, params, x, labels = resnet()
    want_logits = arch.apply(params, x)
    monkeypatch.setattr(architectures, "takes", gc.fits)
    monkeypatch.setattr(architectures, "grouped_conv", recorded)
    xt = x.clone().requires_grad_(True)
    before = timing.counters().get("resnet.cudnn_convs", 0)
    got = arch.apply(params, xt)
    assert timing.counters()["resnet.cudnn_convs"] - before == 1
    assert calls == [((3, 3, 16, 16), 1, 1)] * 6 + [((3, 3, 16, 32), 2, 1)] + [((3, 3, 32, 32), 1, 1)] * 5 + [
        ((3, 3, 32, 64), 2, 1)] + [((3, 3, 64, 64), 1, 1)] * 5
    torch.testing.assert_close(got, want_logits, rtol=0, atol=1e-6 * float(want_logits.abs().max()))
    (grad,) = torch.autograd.grad(got.sum(), xt)
    xr = x.clone().requires_grad_(True)
    monkeypatch.undo()
    (want,) = torch.autograd.grad(arch.apply(params, xr).sum(), xr)
    torch.testing.assert_close(grad, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    monkeypatch.setattr(architectures, "takes", gc.fits)
    monkeypatch.setattr(architectures, "grouped_conv", recorded)
    calls.clear()
    before = timing.counters()["resnet.cudnn_convs"]
    with bf16_scope():
        arch.apply(params, x)
    assert calls == [] and timing.counters()["resnet.cudnn_convs"] - before == 19


def test_model0_keeps_its_5x5_route(monkeypatch):
    """With ``takes`` answering as it would on the card, the conv trunk's
    5×5 VALID second conv goes to the 5×5 kind alone: no 3×3 kind fits it."""
    routes = []
    monkeypatch.setattr(architectures, "takes", gc.fits)
    monkeypatch.setattr(architectures, "grouped_conv",
                        lambda x, w, b, stride, padding: routes.append(gc.KINDS[(w.shape[1], stride, padding)].name)
                        or gc.grouped_conv(x, w, b, stride, padding))
    arch = build_architecture("conv", "leaky", (28, 28, 1), 10, 128, "mnist")
    gen = torch.Generator().manual_seed(4)
    params = map_params(lambda v: v[None].repeat(2, *([1] * v.dim())), arch.init(gen))
    arch.apply(params, torch.rand((3, 28, 28, 1), generator=gen))
    assert routes == ["grouped_conv"]
    assert not gc.fits(torch.rand(3, 64, 12, 12), params[1]["w"], params[1]["b"], 1, 1)


@pytest.mark.parametrize("model", ["conv", "resnet20"])
def test_the_trunk_keeps_conv2d_inside_torch_func_transforms(monkeypatch, model):
    """``_per_sample_input_grads`` (``vmap`` of ``grad``) on a conv model and
    on ``resnet20``: with ``takes`` answering as it would on the card, the
    wrapped tensors of the transforms do not fit a kernel, so the trunk keeps
    ``F.conv2d`` (``resnet20``: all 19 convs counted there) and each draw's
    gradient equals its own one-draw autograd, which takes the kernels'
    route."""
    calls = []
    monkeypatch.setattr(architectures, "takes", gc.fits)
    monkeypatch.setattr(architectures, "grouped_conv", lambda *a: calls.append(a) or gc.grouped_conv(*a))
    if model == "conv":
        arch, params, x = stacked_conv(128, n_draws=2)
        labels, per_apply, library_convs = torch.tensor([0, 3, 7]), 1, 0
    else:
        arch, params, x, labels = resnet()
        per_apply, library_convs = 18, 19
    before = timing.counters().get("resnet.cudnn_convs", 0)
    got = _per_sample_input_grads(arch.apply, params, x, labels)
    assert calls == [] and timing.counters().get("resnet.cudnn_convs", 0) - before == library_convs
    for s in range(2):
        xs = x.clone().requires_grad_(True)
        one = map_params(lambda v: v[s:s + 1], params)
        (want,) = torch.autograd.grad(_summed_loss(arch.apply, one, xs, labels), xs)
        assert len(calls) == per_apply * (s + 1)  # outside the transforms the one-draw apply takes the kernels' route
        if model == "conv":
            torch.testing.assert_close(got[s], want, rtol=1e-5, atol=1e-7)
        else:
            torch.testing.assert_close(got[s], want, rtol=1e-4, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("counter", ["grouped_conv.fwd", "grouped_conv.dgrad", "grouped_conv3x3.fwd",
                                     "grouped_conv3x3.dgrad"])
def test_launch_counts_report_the_grouped_convs(counter):
    """``ops.launch_counts`` holds each kind's counters beside the
    sampled-dense wrappers', 16 in all; the plain functions of CPU tensors
    launch nothing."""
    ops.reset_launch_counts()
    counts = ops.launch_counts()
    assert counts[counter] == 0 and counts["sampled_dense_fwd"] == 0 and len(counts) == 16
    if counter.startswith("grouped_conv."):
        x, w, b, g = conv_inputs(1, 1, 128)
        gc.grouped_conv_fwd(x, w, b)
        gc.grouped_conv_dgrad(g, w, 1, 0)
    else:
        x, w, b, g = conv3x3_inputs((16, 16, 1), b_dim=1, n_draws=1)
        gc.grouped_conv_fwd(x, w, b, 1, 1)
        gc.grouped_conv_dgrad(g, w, 1, 1)
    assert ops.launch_counts()[counter] == 0
