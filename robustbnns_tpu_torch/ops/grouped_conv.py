"""The conv trunk's second convolution, grouped by draw, on a hand-written kernel.

``out[b, s·N + o, y, x] = bias[s, o] + Σ_{ky, kx < 5} Σ_{c < 32}
x[b, s·32 + c, y + ky, x + kx] · w[s, ky, kx, c, o]``: S groups of 32 input
channels, each with its own 5×5 VALID filter bank, on the layouts the trunk
holds — the NCHW input ``(B, S·32, 12, 12)``, the stacked HWIO weights
``(S, 5, 5, 32, N)`` read as they are, the bias ``(S, N)`` and the NCHW
output ``(B, S·N, 8, 8)``.

The input comes NCHW or channels-last, and the output takes its layout, as
``F.conv2d``'s does: the trunk's first conv leaves a one-channel image's
activations channels-last, and the backward's library convolutions then get
the layouts they got from ``F.conv2d``.

``csrc/grouped_conv.cu`` computes the forward on the card in exact f32
(FFMA, a fixed order of sums, no atomics; the design and its bound are in
the source). It replaces no Pallas kernel: the JAX package leaves this conv
to XLA. :func:`grouped_conv_plain` is the same function as ``F.conv2d`` with
``groups=S``, the wrapper's route for CPU tensors. The backward
(:class:`GroupedConv`) is the library's: ``aten.convolution_backward``, the
op that autograd's ``ConvolutionBackward0`` calls for ``F.conv2d``, with the
same arguments. The wrapper counts its launches in ``grouped_conv.fwd``
(:func:`launch_counts`).

:func:`takes` says which calls the kernel takes; the conv trunk routes the
others to ``F.conv2d``, among them every call inside a ``torch.func``
transform (``analysis.gradients._per_sample_input_grads``'s ``vmap`` of
``grad``), whose wrapped tensors the kernel cannot read.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from robustbnns_tpu_torch.ops.build import library
from robustbnns_tpu_torch.utils.timing import count, counters, reset_counters

GROUP_CHANNELS, KERNEL_SIDE, INPUT_SIDE, OUTPUT_SIDE = 32, 5, 12, 8
N_TILE = 128  # output channels a block: the kernel takes N a multiple of it
COUNTER = "grouped_conv.fwd"


@functools.cache
def _kernel():
    """The C entry point ``grouped_conv_fwd``, typed once per process."""
    fn = library("grouped_conv.cu").grouped_conv_fwd
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int
    return fn


def oihw(w: torch.Tensor) -> torch.Tensor:
    """Stacked HWIO conv weights (S, kh, kw, I, O) as ``F.conv2d``'s (S·O, I, kh, kw)."""
    return w.permute(0, 4, 3, 1, 2).reshape(-1, w.shape[3], w.shape[1], w.shape[2])


def _fits(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> bool:
    """What the kernel computes: plain f32 tensors (not the wrappers of a
    ``torch.func`` transform, whose data it cannot read) of its shapes, 32
    input channels a group, a 5×5 filter on a 12×12 input, N a multiple of
    :data:`N_TILE`, a batch, the input NCHW or channels-last."""
    return (
        all(t.dtype == torch.float32 and not torch._C._functorch.is_functorch_wrapped_tensor(t) for t in (x, w, b))
        and w.dim() == 5
        and w.shape[1:4] == (KERNEL_SIDE, KERNEL_SIDE, GROUP_CHANNELS)
        and w.shape[4] % N_TILE == 0
        and x.dim() == 4
        and x.shape[0] > 0
        and x.shape[1:] == (w.shape[0] * GROUP_CHANNELS, INPUT_SIDE, INPUT_SIDE)
        and b.shape == (w.shape[0], w.shape[4])
        and (x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last))
    )


def takes(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the kernel computes this grouped conv: CUDA tensors it fits (:func:`_fits`)."""
    return x.device.type == "cuda" and _fits(x, w, b)


def grouped_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``F.conv2d`` with ``groups=S`` on the permuted weights: the kernel's function."""
    return F.conv2d(x, oihw(w), b.reshape(-1), groups=w.shape[0])


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    """Raise on what the kernel does not take, on either device."""
    for t in (w, b):
        if t.device != x.device:
            raise ValueError(f"all tensors must be on {x.device}, got one on {t.device}")
    for t in (x, w, b):
        if t.dtype != torch.float32:
            raise TypeError(f"the grouped-conv kernel takes float32, got {t.dtype}")
        if x.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError("the grouped-conv kernel takes 16-byte aligned tensors")
    if not (w.is_contiguous() and b.is_contiguous() and _fits(x, w, b)):
        raise ValueError(
            f"the grouped-conv kernel takes x (B>0, S·{GROUP_CHANNELS}, {INPUT_SIDE}, {INPUT_SIDE}) NCHW or "
            f"channels-last, w (S, {KERNEL_SIDE}, {KERNEL_SIDE}, {GROUP_CHANNELS}, N) with N a multiple of "
            f"{N_TILE} and b (S, N), the last two contiguous; got {tuple(x.shape)} strides {x.stride()}, "
            f"{tuple(w.shape)}, {tuple(b.shape)}")


def grouped_conv_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The forward, in the input's layout: ``csrc/grouped_conv.cu`` for CUDA tensors (or raises),
    :func:`grouped_conv_plain` for CPU tensors. One launch, counted in
    ``grouped_conv.fwd``."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return grouped_conv_plain(x, w, b)
    n_draws, hidden, nhwc = w.shape[0], w.shape[4], not x.is_contiguous()
    out = torch.empty((x.shape[0], n_draws * hidden, OUTPUT_SIDE, OUTPUT_SIDE), device=x.device,
                      memory_format=torch.channels_last if nhwc else torch.contiguous_format)
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), x.shape[0], n_draws, hidden,
                        int(nhwc), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_conv_fwd failed to launch: cudaError {err}")
    count(COUNTER)
    return out


class GroupedConv(torch.autograd.Function):
    """:func:`grouped_conv_fwd` with the library's backward: the input,
    weight and bias gradients of ``aten.convolution_backward``, each computed
    only where asked for."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return grouped_conv_fwd(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        n_draws, kh, kw, c_in, hidden = w.shape
        dx, dw, db = torch.ops.aten.convolution_backward(
            g, x, oihw(w), [n_draws * hidden], [1, 1], [0, 0], [1, 1], False, [0, 0], n_draws,
            list(ctx.needs_input_grad))
        if dw is not None:
            dw = dw.reshape(n_draws, hidden, c_in, kh, kw).permute(0, 3, 4, 2, 1)
        if db is not None:
            db = db.reshape(n_draws, hidden)
        return dx, dw, db


def grouped_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The grouped conv of ``x`` (B, S·32, 12, 12) with ``w`` (S, 5, 5, 32,
    N) and ``b`` (S, N): (B, S·N, 8, 8), differentiable in all three."""
    return GroupedConv.apply(x, w, b)


def reset_launch_counts() -> None:
    reset_counters(COUNTER)


def launch_counts() -> dict[str, int]:
    """The kernel's launches, under its counter's name."""
    return {COUNTER: counters().get(COUNTER, 0)}
