"""ResNet-20's residual 3×3 convolutions, grouped by draw, on a hand-written kernel.

``out[b, s·Co + o, y, x] = bias[s, o] + Σ_{ky, kx < 3} Σ_{c < Ci}
x[b, s·Ci + c, st·y + ky − 1, st·x + kx − 1] · w[s, ky, kx, c, o]``: S groups
of Ci input channels, each with its own 3×3 filter bank, padding 1 (zeros
outside the input), stride st 1 or 2, on the layouts the residual trunk
holds — the contiguous NCHW input ``(B, S·Ci, side, side)``, the stacked
HWIO weights ``(S, 3, 3, Ci, Co)`` read as they are, the bias ``(S, Co)``
and the NCHW output ``(B, S·Co, side/st, side/st)``.

``csrc/grouped_conv3x3.cu`` computes the forward and the input gradient on
the card in exact f32 (FFMA, a fixed order of sums, no atomics; the design
and its bound are in the source), one launch each for all S draws, at
ResNet-20's five shapes of width 16 on the sides of 32×32 inputs
(:data:`SHAPES`). It replaces no Pallas kernel: the JAX package has no
ResNet. The input gradient is itself a 3×3 conv of the output gradient, with
each tap's weights transposed, at offsets ``1 − ky`` (stride 1); at stride 2
it splits into the four parity classes of the input's pixels, which take 1,
2, 2 and 4 taps. :func:`grouped_conv3x3_plain` and
:func:`grouped_conv3x3_dgrad_plain` are those two functions in plain
PyTorch, the wrappers' route for CPU tensors. :class:`GroupedConv3x3`'s
weight and bias gradients are the library's (``aten.convolution_backward``,
the op that autograd's ``ConvolutionBackward0`` calls for ``F.conv2d``, with
the same arguments). The wrappers count their launches in
``grouped_conv3x3.fwd`` and ``grouped_conv3x3.dgrad`` (:func:`launch_counts`).

:func:`takes3x3` says which calls the kernel takes; the residual trunk
routes the others to ``F.conv2d``: the CPU, bf16 products, other shapes,
sides or paddings, and every call inside a ``torch.func`` transform, whose
wrapped tensors the kernel cannot read.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from robustbnns_tpu_torch.ops.build import library
from robustbnns_tpu_torch.ops.grouped_conv import oihw
from robustbnns_tpu_torch.utils.device import bf16_products
from robustbnns_tpu_torch.utils.timing import count, counters, reset_counters

# (Ci, Co, stride) of ResNet-20's grouped convs at width 16 -> the input's
# side on 32×32 images: stage 1 at 32, stage 2's first conv (stride 2) at 32,
# the rest of stage 2 at 16, stage 3's first at 16, the rest at 8
SHAPES = {(16, 16, 1): 32, (16, 32, 2): 32, (32, 32, 1): 16, (32, 64, 2): 16, (64, 64, 1): 8}
COUNTERS = ("grouped_conv3x3.fwd", "grouped_conv3x3.dgrad")


@functools.cache
def _kernels():
    """The C entry points ``grouped_conv3x3_fwd`` and ``grouped_conv3x3_dgrad``, typed once per process."""
    lib = library("grouped_conv3x3.cu")
    fwd, dgrad = lib.grouped_conv3x3_fwd, lib.grouped_conv3x3_dgrad
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    dgrad.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fwd.restype = dgrad.restype = ctypes.c_int
    return fwd, dgrad


def _plain_f32(t: torch.Tensor) -> bool:
    return t.dtype == torch.float32 and not torch._C._functorch.is_functorch_wrapped_tensor(t)


def _fits(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> bool:
    """What the kernel computes: plain f32 tensors (not the wrappers of a
    ``torch.func`` transform, whose data it cannot read), 3×3 weights of one
    of :data:`SHAPES` with ``stride``, an NCHW contiguous batch of that
    shape's side, a bias per draw and channel."""
    if not (all(_plain_f32(t) for t in (x, w, b)) and w.dim() == 5 and w.shape[1:3] == (3, 3)):
        return False
    n_draws, _, _, c_in, c_out = w.shape
    side = SHAPES.get((c_in, c_out, stride))
    return (
        side is not None
        and x.dim() == 4
        and x.shape[0] > 0
        and x.shape[1:] == (n_draws * c_in, side, side)
        and b.shape == (n_draws, c_out)
        and x.is_contiguous()
    )


def fits3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, padding: int) -> bool:
    """Whether the kernel would compute this grouped conv were the tensors on
    the card: padding 1, not under :func:`.utils.device.bf16_products`, and
    what it fits (:func:`_fits`)."""
    return padding == 1 and not bf16_products() and _fits(x, w, b, stride)


def takes3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, padding: int) -> bool:
    """Whether the kernel computes this grouped conv: CUDA tensors it would compute (:func:`fits3x3`)."""
    return x.device.type == "cuda" and fits3x3(x, w, b, stride, padding)


def grouped_conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """``F.conv2d`` with ``groups=S``, padding 1, on the permuted weights: the forward kernel's function."""
    return F.conv2d(x, oihw(w), b.reshape(-1), stride, 1, 1, w.shape[0])


def parity_taps(parity: int) -> list[tuple[int, int]]:
    """The taps k of a stride-2 conv that reach the input pixels of one
    parity along an axis, with the offset of the output pixel each reads:
    input ``2i + parity`` takes ``g[i + (parity + 1 − k) / 2]`` where
    ``parity + 1 − k`` is even (even pixels tap 1 alone, odd ones 0 and 2)."""
    return [(k, (parity + 1 - k) // 2) for k in range(3) if (parity + 1 - k) % 2 == 0]


def parity_class(g: torch.Tensor, w: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """The input gradient of a stride-2 grouped conv at the input pixels of
    row parity ``py`` and column parity ``px``, ``(B, S·Ci, H, W)`` for a
    ``g`` of side ``(H, W)``: a 2×2 conv of ``g`` padded by one zero row and
    column at the end, with the class's taps' weights transposed and the
    others zero."""
    n_draws, _, _, c_in, c_out = w.shape
    k2 = w.new_zeros((n_draws, 2, 2, c_out, c_in))
    for ky, dy in parity_taps(py):
        for kx, dx in parity_taps(px):
            k2[:, dy, dx] = w[:, ky, kx].transpose(-1, -2)
    return F.conv2d(F.pad(g, (0, 1, 0, 1)), oihw(k2), None, 1, 0, 1, n_draws)


def grouped_conv3x3_dgrad_plain(g: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """The input gradient kernel's function, ``(B, S·Ci, side, side)`` from
    ``g`` ``(B, S·Co, side/stride, side/stride)``: at stride 1 a 3×3 conv
    of ``g`` with padding 1 and the taps rotated 180° and transposed, at
    stride 2 its four :func:`parity_class` es put in place."""
    n_draws = w.shape[0]
    if stride == 1:
        return F.conv2d(g, oihw(w.flip(1, 2).transpose(3, 4)), None, 1, 1, 1, n_draws)
    batch, _, height, width = g.shape
    dx = g.new_empty((batch, n_draws * w.shape[3], 2 * height, 2 * width))
    for py in range(2):
        for px in range(2):
            dx[:, :, py::2, px::2] = parity_class(g, w, py, px)
    return dx


def _fits_dgrad(g: torch.Tensor, w: torch.Tensor, stride: int) -> bool:
    """What the input-gradient kernel computes: plain f32 tensors, 3×3
    weights of one of :data:`SHAPES` with ``stride`` and an output gradient
    of that shape's output side."""
    if not (_plain_f32(g) and _plain_f32(w) and w.dim() == 5 and w.shape[1:3] == (3, 3)):
        return False
    side = SHAPES.get((w.shape[3], w.shape[4], stride))
    return (side is not None and g.dim() == 4 and g.shape[0] > 0
            and g.shape[1:] == (w.shape[0] * w.shape[4], side // stride, side // stride))


def _check(tensors: tuple, fits: bool, stride: int) -> None:
    """Raise on what the kernel does not take, on either device: the first
    tensor's device for all, float32, 16-byte aligned on the card, contiguous
    and of a shape it fits."""
    first = tensors[0]
    for t in tensors[1:]:
        if t.device != first.device:
            raise ValueError(f"all tensors must be on {first.device}, got one on {t.device}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the grouped 3x3 conv kernel takes float32, got {t.dtype}")
        if first.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError("the grouped 3x3 conv kernel takes 16-byte aligned tensors")
    if not (fits and all(t.is_contiguous() for t in tensors)):
        raise ValueError(
            f"the grouped 3x3 conv kernel takes contiguous NCHW activations (B>0, S·C, side, side), w (S, 3, 3, "
            f"Ci, Co) and b (S, Co), with (Ci, Co, stride) -> the input's side one of {SHAPES}; got "
            f"{[tuple(t.shape) for t in tensors]}, strides {[t.stride() for t in tensors]}, stride {stride}")


def _geometry(w: torch.Tensor, stride: int) -> tuple[int, int, int, int]:
    """Draws, input and output channels, and the input's side."""
    n_draws, _, _, c_in, c_out = w.shape
    return n_draws, c_in, c_out, SHAPES[(c_in, c_out, stride)]


def grouped_conv3x3_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """The forward: ``csrc/grouped_conv3x3.cu`` for CUDA tensors (or raises),
    :func:`grouped_conv3x3_plain` for CPU tensors. One launch, counted in
    ``grouped_conv3x3.fwd``."""
    _check((x, w, b), _fits(x, w, b, stride), stride)
    if x.device.type == "cpu":
        return grouped_conv3x3_plain(x, w, b, stride)
    n_draws, c_in, c_out, side = _geometry(w, stride)
    out = torch.empty((x.shape[0], n_draws * c_out, side // stride, side // stride), device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels()[0](x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), x.shape[0], n_draws, c_in,
                            c_out, stride, side, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_conv3x3_fwd failed to launch: cudaError {err}")
    count(COUNTERS[0])
    return out


def grouped_conv3x3_dgrad(g: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """The input gradient (B, S·Ci, side, side) from the output gradient
    ``g`` (B, S·Co, side/stride, side/stride): ``csrc/grouped_conv3x3.cu``
    for CUDA tensors (or raises), :func:`grouped_conv3x3_dgrad_plain` for CPU
    tensors. One launch, counted in ``grouped_conv3x3.dgrad``."""
    _check((g, w), _fits_dgrad(g, w, stride), stride)
    if g.device.type == "cpu":
        return grouped_conv3x3_dgrad_plain(g, w, stride)
    n_draws, c_in, c_out, side = _geometry(w, stride)
    dx = torch.empty((g.shape[0], n_draws * c_in, side, side), device=g.device)
    with torch.cuda.device(g.device):
        err = _kernels()[1](g.data_ptr(), w.data_ptr(), dx.data_ptr(), g.shape[0], n_draws, c_in, c_out, stride,
                            side, torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped_conv3x3_dgrad failed to launch: cudaError {err}")
    count(COUNTERS[1])
    return dx


class GroupedConv3x3(torch.autograd.Function):
    """:func:`grouped_conv3x3_fwd` with :func:`grouped_conv3x3_dgrad` for the
    input gradient, and the library's weight and bias gradients
    (``aten.convolution_backward``), each computed only where asked for."""

    @staticmethod
    def forward(ctx, x, w, b, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return grouped_conv3x3_fwd(x, w, b, stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride = ctx.stride
        g = g.contiguous()
        dx = grouped_conv3x3_dgrad(g, w, stride) if ctx.needs_input_grad[0] else None
        dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            n_draws, kh, kw, c_in, c_out = w.shape
            _, dw, db = torch.ops.aten.convolution_backward(
                g, x, oihw(w), [n_draws * c_out], [stride, stride], [1, 1], [1, 1], False, [0, 0], n_draws,
                [False, ctx.needs_input_grad[1], ctx.needs_input_grad[2]])
            if dw is not None:
                dw = dw.reshape(n_draws, c_out, c_in, kh, kw).permute(0, 3, 4, 2, 1)
            if db is not None:
                db = db.reshape(n_draws, c_out)
        return dx, dw, db, None


def grouped_conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """The grouped 3×3 conv (padding 1) of ``x`` (B, S·Ci, side, side) with
    ``w`` (S, 3, 3, Ci, Co) and ``b`` (S, Co) at ``stride``: (B, S·Co,
    side/stride, side/stride), differentiable in all three."""
    return GroupedConv3x3.apply(x, w, b, stride)


def reset_launch_counts() -> None:
    reset_counters("grouped_conv3x3.")


def launch_counts() -> dict[str, int]:
    """The kernel's launches, forward and input gradient, under their counters' names."""
    totals = counters()
    return {name: totals.get(name, 0) for name in COUNTERS}
