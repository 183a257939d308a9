"""The conv trunk's grouped second convolution (``ops/grouped_conv.py``) on the CPU.

:class:`GroupedConv` on CPU tensors runs its plain version, ``F.conv2d`` with
``groups=S`` on the permuted stacked weights, and the library's backward
(``aten.convolution_backward``, what autograd's ``ConvolutionBackward0``
calls): its output and its input, weight and bias gradients equal
``F.conv2d``'s through autograd bit for bit. The conv trunk sends only CUDA
f32 calls of the kernel's shapes to the kernel: on the CPU, under
``bf16_scope`` and at a hidden size below the kernel's 128-channel tile it
computes what ``F.conv2d`` did before. The wrapper raises on what the
kernel does not take. The kernel itself is checked on the card
(``tests/test_torch_kernels.py``) and its source on the CPU
(``tests/test_torch_kernel_emulation.py``).
"""
import importlib

import pytest
import torch
import torch.nn.functional as F

import robustbnns_tpu_torch.ops as ops
from robustbnns_tpu_torch.models import architectures
from robustbnns_tpu_torch.analysis.gradients import _per_sample_input_grads, _summed_loss
from robustbnns_tpu_torch.models.architectures import build_architecture
from robustbnns_tpu_torch.ops.grouped_conv import oihw
from robustbnns_tpu_torch.utils.device import bf16_scope
from robustbnns_tpu_torch.utils.pytree import map_params

# the module, not the op of the same name that robustbnns_tpu_torch.ops exports
gc = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv")


def is_channels_last(t):
    return not t.is_contiguous() and t.is_contiguous(memory_format=torch.channels_last)


def conv_inputs(b_dim, n_draws, hidden, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((b_dim, 32 * n_draws, 12, 12), generator=gen)
    w = torch.randn((n_draws, 5, 5, 32, hidden), generator=gen) / 800**0.5
    b = 0.1 * torch.randn((n_draws, hidden), generator=gen)
    g = torch.randn((b_dim, n_draws * hidden, 8, 8), generator=gen)
    return x, w, b, g


@pytest.mark.parametrize("n_draws", [1, 3])
@pytest.mark.parametrize("hidden", [128, 256])
@pytest.mark.parametrize("asked", ["all", "input"])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_the_function_is_conv2d_bit_for_bit_on_the_cpu(n_draws, hidden, asked, layout):
    x, w, b, g = conv_inputs(2, n_draws, hidden)
    if layout == "channels_last":
        x, g = x.contiguous(memory_format=torch.channels_last), g.contiguous(memory_format=torch.channels_last)
    wants = (True, asked == "all", asked == "all")
    ours = [t.clone().requires_grad_(want) for t, want in zip((x, w, b), wants)]
    lib = [t.clone().requires_grad_(want) for t, want in zip((x, w, b), wants)]
    out = gc.grouped_conv(*ours)
    ref = F.conv2d(lib[0], oihw(lib[1]), lib[2].reshape(-1), groups=n_draws)
    out.backward(g)
    ref.backward(g)
    assert out.shape == (2, n_draws * hidden, 8, 8) and is_channels_last(out) == is_channels_last(x)
    assert torch.equal(out, ref)
    for got, want, asked_for in zip(ours, lib, wants):
        assert (got.grad is None) == (not asked_for)
        if asked_for:
            assert got.grad.shape == got.shape and torch.equal(got.grad, want.grad)


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
    """With ``takes`` answering as it would on the card, the trunk sends
    the second conv to the kernel's function with the stacked weights as
    they are and the first conv's output in its channels-last layout, and
    under ``bf16_scope`` keeps it on ``F.conv2d``."""
    calls = []

    def recorded(x, w, b):
        calls.append((*(t.shape for t in (x, w, b)), is_channels_last(x)))
        return gc.grouped_conv_plain(x, w, b)

    monkeypatch.setattr(architectures, "takes", gc._fits)
    monkeypatch.setattr(architectures, "grouped_conv", recorded)
    arch, params, x = stacked_conv(128, n_draws=2)
    want = trunk_before(architectures.ACTIVATIONS["leaky"], params, x)
    assert torch.equal(arch.apply(params, x), want)
    assert calls == [((3, 64, 12, 12), (2, 5, 5, 32, 128), (2, 128), True)]
    with bf16_scope():
        arch.apply(params, x)
    assert len(calls) == 1


def test_the_kernels_shapes():
    x, w, b, _ = conv_inputs(2, 3, 128)
    assert gc._fits(x, w, b) and not gc.takes(x, w, b)  # the CPU never takes the kernel
    assert not gc._fits(x[:, :, :6, :6].contiguous(), w, b)  # conv2's 6x6 input on 16x16 images
    _, w64, b64, _ = conv_inputs(2, 3, 64)
    assert not gc._fits(x, w64, b64)  # hidden below the tile
    assert not gc._fits(x.to(torch.bfloat16), w, b)
    assert not gc._fits(x[:0], w, b)  # an empty batch
    assert gc._fits(x.contiguous(memory_format=torch.channels_last), w, b)
    assert not gc._fits(x.transpose(2, 3), w, b)  # neither NCHW nor channels-last


@pytest.mark.parametrize("fault", ["dtype", "width", "input_side", "channels", "bias", "not_contiguous"])
def test_the_wrapper_raises_on_what_the_kernel_does_not_take(fault):
    x, w, b, _ = conv_inputs(2, 2, 128)
    if fault == "dtype":
        x, error = x.double(), TypeError
    elif fault == "width":
        (_, w, b, _), error = conv_inputs(2, 2, 96), ValueError
    elif fault == "input_side":
        x, error = x[:, :, :10, :10].contiguous(), ValueError
    elif fault == "channels":
        x, error = x[:, :32].contiguous(), ValueError
    elif fault == "bias":
        b, error = b.reshape(-1), ValueError
    else:  # neither NCHW nor channels-last
        x, error = x.transpose(2, 3), ValueError
    with pytest.raises(error):
        gc.grouped_conv_fwd(x, w, b)


def test_the_trunk_keeps_conv2d_inside_torch_func_transforms(monkeypatch):
    """``_per_sample_input_grads`` (``vmap`` of ``grad``) on a conv model:
    with ``takes`` answering as it would on the card, the wrapped tensors of
    the transforms do not fit the kernel, so the trunk keeps ``F.conv2d``
    and each draw's gradient equals its own one-draw autograd."""
    calls = []
    monkeypatch.setattr(architectures, "takes", gc._fits)
    monkeypatch.setattr(architectures, "grouped_conv", lambda *a: calls.append(a) or gc.grouped_conv(*a))
    arch, params, x = stacked_conv(128, n_draws=2)
    labels = torch.tensor([0, 3, 7])
    got = _per_sample_input_grads(arch.apply, params, x, labels)
    assert calls == []
    for s in range(2):
        xs = x.clone().requires_grad_(True)
        one = map_params(lambda v: v[s:s + 1], params)
        (want,) = torch.autograd.grad(_summed_loss(arch.apply, one, xs, labels), xs)
        assert len(calls) == s + 1  # outside the transforms the one-draw apply takes the kernel's route
        torch.testing.assert_close(got[s], want, rtol=1e-5, atol=1e-7)


def test_launch_counts_report_the_grouped_conv():
    ops.reset_launch_counts()
    counts = ops.launch_counts()
    assert counts["grouped_conv.fwd"] == 0 and counts["sampled_dense_fwd"] == 0 and len(counts) == 15
    x, w, b, _ = conv_inputs(1, 1, 128)
    gc.grouped_conv_fwd(x, w, b)  # the plain version: no launch
    assert ops.launch_counts()["grouped_conv.fwd"] == 0
