"""Convolutions grouped by draw on hand-written kernels: the conv trunk's
second convolution and ResNet-20's residual 3×3 convolutions.

``out[b, s·Co + o, y, x] = bias[s, o] + Σ_{ky, kx < k} Σ_{c < Ci}
x[b, s·Ci + c, st·y + ky − p, st·x + kx − p] · w[s, ky, kx, c, o]``: S groups
of Ci input channels, each with its own k×k filter bank, at stride st and
padding p (zeros outside the input), on the layouts the trunks hold — NCHW
activations ``(B, S·C, side, side)``, the stacked HWIO weights ``(S, k, k,
Ci, Co)`` read as they are and the bias ``(S, Co)``.
:func:`grouped_conv_plain` is that function, ``F.conv2d`` with ``groups=S``
on the permuted weights, and the wrappers' route for CPU tensors.

:data:`KINDS` holds the convs that a kernel computes, by (k, stride,
padding). Each kernel computes in exact f32 (FFMA, a fixed order of sums, no
atomics; the designs and their bounds are in the sources), one launch for
all S draws, and replaces no Pallas kernel (the JAX package leaves the conv
trunk to XLA and has no ResNet):

- ``grouped_conv`` (5, 1, 0), ``csrc/grouped_conv.cu``: the conv trunk's
  second conv, 32 input channels a group on a 12×12 input, Co a multiple of
  :data:`N_TILE`; the forward and the input gradient. The input comes NCHW
  or channels-last, and the output takes its layout, as ``F.conv2d``'s does:
  the trunk's first conv leaves a one-channel image's activations
  channels-last, and the backward's library convolutions then get the
  layouts they got from ``F.conv2d``. The input gradient reads the output
  gradient in place in the input's layout and gives dx in it, as the
  library's input gradient does (:func:`dgrad5x5_plain`, its function in
  plain PyTorch).
- ``grouped_conv3x3`` (3, 1, 1) and (3, 2, 1), ``csrc/grouped_conv3x3.cu``:
  ResNet-20's residual convs at width 16 on 32×32 inputs
  (:data:`SHAPES3X3`), contiguous NCHW; the forward and the input gradient.
  The input gradient is itself a 3×3 conv of the output gradient, with each
  tap's weights transposed, at offsets ``1 − ky`` (stride 1); at stride 2 it
  splits into the four parity classes of the input's pixels, which take 1,
  2, 2 and 4 taps (:func:`dgrad3x3_plain`, its function in plain PyTorch).

A kind's launches are counted in ``<name>.fwd`` and ``<name>.dgrad``
(:func:`.build.launch_counts`). :class:`GroupedConv`'s backward takes the
input gradient from the kind's dgrad kernel, and the weight and bias
gradients from the library: ``aten.convolution_backward``, the op that
autograd's ``ConvolutionBackward0`` calls for ``F.conv2d``, with the same
arguments, each gradient computed only where asked for.

:func:`takes` alone says which calls a kernel computes; the architectures
route the others to ``F.conv2d``: the CPU, bf16 products, other shapes,
strides, paddings or layouts, and every call inside a ``torch.func``
transform (``analysis.gradients._per_sample_input_grads``'s ``vmap`` of
``grad``), whose wrapped tensors no kernel can read.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from robustbnns_tpu_torch.ops import build
from robustbnns_tpu_torch.utils.device import bf16_products, plain_f32

GROUP_CHANNELS, INPUT_SIDE, OUTPUT_SIDE = 32, 12, 8  # the 5×5 kind's
N_TILE = 128  # output channels a block of the 5×5 kernel: it takes Co a multiple of it
# (Ci, Co, stride) of ResNet-20's grouped convs at width 16 -> the input's
# side on 32×32 images: stage 1 at 32, stage 2's first conv (stride 2) at 32,
# the rest of stage 2 at 16, stage 3's first at 16, the rest at 8
SHAPES3X3 = {(16, 16, 1): 32, (16, 32, 2): 32, (32, 32, 1): 16, (32, 64, 2): 16, (64, 64, 1): 8}


def oihw(w: torch.Tensor) -> torch.Tensor:
    """Stacked HWIO conv weights (S, kh, kw, I, O) as ``F.conv2d``'s (S·O, I, kh, kw)."""
    return w.permute(0, 4, 3, 1, 2).reshape(-1, w.shape[3], w.shape[1], w.shape[2])


def grouped_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
                       padding: int = 0) -> torch.Tensor:
    """``F.conv2d`` with ``groups=S`` on the permuted weights: the forward kernels' function."""
    return F.conv2d(x, oihw(w), b.reshape(-1), stride, padding, 1, w.shape[0])


def dgrad5x5_plain(g: torch.Tensor, w: torch.Tensor, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """The 5×5 input-gradient kernel's function: the input gradient of
    :func:`grouped_conv_plain`, (B, S·Ci, 12, 12) from ``g`` (B, S·Co, 8, 8),
    in ``g``'s layout: ``F.conv_transpose2d`` with ``groups=S`` on the same
    permuted weights."""
    return F.conv_transpose2d(g, oihw(w), None, stride, padding, 0, w.shape[0])


def parity_taps(parity: int) -> list[tuple[int, int]]:
    """The taps k of a stride-2 conv that reach the input pixels of one
    parity along an axis, with the offset of the output pixel each reads:
    input ``2i + parity`` takes ``g[i + (parity + 1 − k) / 2]`` where
    ``parity + 1 − k`` is even (even pixels tap 1 alone, odd ones 0 and 2)."""
    return [(k, (parity + 1 - k) // 2) for k in range(3) if (parity + 1 - k) % 2 == 0]


def parity_class(g: torch.Tensor, w: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """The input gradient of a stride-2 grouped 3×3 conv at the input pixels
    of row parity ``py`` and column parity ``px``, ``(B, S·Ci, H, W)`` for a
    ``g`` of side ``(H, W)``: a 2×2 conv of ``g`` padded by one zero row and
    column at the end, with the class's taps' weights transposed and the
    others zero."""
    n_draws, _, _, c_in, c_out = w.shape
    k2 = w.new_zeros((n_draws, 2, 2, c_out, c_in))
    for ky, dy in parity_taps(py):
        for kx, dx in parity_taps(px):
            k2[:, dy, dx] = w[:, ky, kx].transpose(-1, -2)
    return F.conv2d(F.pad(g, (0, 1, 0, 1)), oihw(k2), None, 1, 0, 1, n_draws)


def dgrad3x3_plain(g: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """The 3×3 input-gradient kernel's function, ``(B, S·Ci, side, side)``
    from ``g`` ``(B, S·Co, side/stride, side/stride)``: at stride 1 a 3×3
    conv of ``g`` with padding 1 and the taps rotated 180° and transposed, at
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


# Each kind's fit tests (what its kernel computes, beyond plain f32 tensors)
# and calls (the output and the launch's arguments before the stream)


def _fits5x5(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> bool:
    return (
        w.shape[3] == GROUP_CHANNELS
        and w.shape[4] % N_TILE == 0
        and x.dim() == 4
        and x.shape[0] > 0
        and x.shape[1:] == (w.shape[0] * GROUP_CHANNELS, INPUT_SIDE, INPUT_SIDE)
        and b.shape == (w.shape[0], w.shape[4])
        and (x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last))
    )


def _fwd5x5(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int):
    n_draws, hidden, nhwc = w.shape[0], w.shape[4], not x.is_contiguous()
    out = torch.empty((x.shape[0], n_draws * hidden, OUTPUT_SIDE, OUTPUT_SIDE), device=x.device,
                      memory_format=torch.channels_last if nhwc else torch.contiguous_format)
    return out, (x, w, b, out, x.shape[0], n_draws, hidden, int(nhwc))


def _fits_dgrad5x5(g: torch.Tensor, w: torch.Tensor, stride: int) -> bool:
    return (
        w.shape[3] == GROUP_CHANNELS
        and w.shape[4] % N_TILE == 0
        and g.dim() == 4
        and g.shape[0] > 0
        and g.shape[1:] == (w.shape[0] * w.shape[4], OUTPUT_SIDE, OUTPUT_SIDE)
        and (g.is_contiguous() or g.is_contiguous(memory_format=torch.channels_last))
    )


def _dgrad5x5(g: torch.Tensor, w: torch.Tensor, stride: int):
    n_draws, hidden, nhwc = w.shape[0], w.shape[4], not g.is_contiguous()
    dx = torch.empty((g.shape[0], n_draws * GROUP_CHANNELS, INPUT_SIDE, INPUT_SIDE), device=g.device,
                     memory_format=torch.channels_last if nhwc else torch.contiguous_format)
    return dx, (g, w, dx, g.shape[0], n_draws, hidden, int(nhwc), build.sm_count(g.device))


def _layout(x: torch.Tensor) -> torch.memory_format:
    """The memory format of an NCHW or channels-last activation."""
    return torch.contiguous_format if x.is_contiguous() else torch.channels_last


def _fits3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> bool:
    n_draws, _, _, c_in, c_out = w.shape
    side = SHAPES3X3.get((c_in, c_out, stride))
    return (side is not None and x.dim() == 4 and x.shape[0] > 0 and x.shape[1:] == (n_draws * c_in, side, side)
            and b.shape == (n_draws, c_out) and x.is_contiguous())


def _fwd3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int):
    n_draws, _, _, c_in, c_out = w.shape
    side = SHAPES3X3[(c_in, c_out, stride)]
    out = torch.empty((x.shape[0], n_draws * c_out, side // stride, side // stride), device=x.device)
    return out, (x, w, b, out, x.shape[0], n_draws, c_in, c_out, stride, side)


def _fits_dgrad3x3(g: torch.Tensor, w: torch.Tensor, stride: int) -> bool:
    side = SHAPES3X3.get((w.shape[3], w.shape[4], stride))
    return (side is not None and g.dim() == 4 and g.shape[0] > 0
            and g.shape[1:] == (w.shape[0] * w.shape[4], side // stride, side // stride) and g.is_contiguous())


def _dgrad3x3(g: torch.Tensor, w: torch.Tensor, stride: int):
    n_draws, _, _, c_in, c_out = w.shape
    side = SHAPES3X3[(c_in, c_out, stride)]
    dx = torch.empty((g.shape[0], n_draws * c_in, side, side), device=g.device)
    return dx, (g, w, dx, g.shape[0], n_draws, c_in, c_out, stride, side)


class Mode(NamedTuple):
    """One entry point of a kind, on operands (x, w, b) or (g, w): ``fits(*operands,
    stride)``, whether its kernel computes them (the first operand's layout
    included); ``call(*operands, stride)``, the output and the launch's
    arguments; ``plain(*operands, stride, padding)``, its function on the CPU;
    the input gradient's ``layout(x)``, the memory format it reads ``g`` in for
    the input ``x`` (``g`` is copied into it only where it differs)."""

    fits: Callable[..., bool]
    call: Callable
    plain: Callable[..., torch.Tensor]
    argtypes: tuple
    layout: Optional[Callable[[torch.Tensor], torch.memory_format]] = None


class Kind(NamedTuple):
    """A grouped conv that hand-written kernels compute: the library
    ``csrc/<name>.cu``, its entry points ``<name>_fwd`` and ``<name>_dgrad``,
    counted in ``<name>.fwd`` and ``<name>.dgrad``."""

    name: str
    inputs: str  # what the kernels take, for the wrappers' errors
    fwd: Mode
    dgrad: Mode


_P, _I = ctypes.c_void_p, ctypes.c_int
_CONV5X5 = Kind(
    "grouped_conv",
    f"x (B>0, S·{GROUP_CHANNELS}, {INPUT_SIDE}, {INPUT_SIDE}) NCHW or channels-last, w (S, 5, 5, "
    f"{GROUP_CHANNELS}, Co) with Co a multiple of {N_TILE} and b (S, Co), the last two contiguous",
    Mode(_fits5x5, _fwd5x5, grouped_conv_plain, (_P,) * 4 + (_I,) * 4 + (_P,)),
    Mode(_fits_dgrad5x5, _dgrad5x5, dgrad5x5_plain, (_P,) * 3 + (_I,) * 5 + (_P,), _layout))
_CONV3X3 = Kind(
    "grouped_conv3x3",
    f"contiguous NCHW activations (B>0, S·C, side, side), w (S, 3, 3, Ci, Co) and b (S, Co), with "
    f"(Ci, Co, stride) -> the input's side one of {SHAPES3X3}",
    Mode(_fits3x3, _fwd3x3, grouped_conv_plain, (_P,) * 4 + (_I,) * 6 + (_P,)),
    Mode(_fits_dgrad3x3, _dgrad3x3, lambda g, w, stride, padding: dgrad3x3_plain(g, w, stride),
         (_P,) * 3 + (_I,) * 6 + (_P,), lambda x: torch.contiguous_format))
KINDS = {(5, 1, 0): _CONV5X5, (3, 1, 1): _CONV3X3, (3, 2, 1): _CONV3X3}  # (k, stride, padding) -> kind
build.LAUNCH_COUNTERS.update({f"{kind.name}.{mode}": f"{kind.name}.{mode}" for kind in KINDS.values()
                              for mode in ("fwd", "dgrad")})


def _kind(w: torch.Tensor, stride: int, padding: int) -> Optional[Kind]:
    """The kind of a conv with these stacked weights, stride and padding, if a kernel computes it."""
    if w.dim() != 5 or w.shape[1] != w.shape[2]:
        return None
    return KINDS.get((w.shape[1], stride, padding))


def fits(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1, padding: int = 0) -> bool:
    """Whether a kernel would compute this grouped conv were the tensors on
    the card: not under :func:`.utils.device.bf16_products`, plain f32
    tensors (not the wrappers of a ``torch.func`` transform), a kind of
    :data:`KINDS` and the shapes and layouts its forward fits."""
    kind = _kind(w, stride, padding)
    return (kind is not None and not bf16_products() and all(plain_f32(t) for t in (x, w, b))
            and kind.fwd.fits(x, w, b, stride))


def takes(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1, padding: int = 0) -> bool:
    """Whether a kernel computes this grouped conv: CUDA tensors it would compute (:func:`fits`)."""
    return x.device.type == "cuda" and fits(x, w, b, stride, padding)


def _run(mode_name: str, operands: tuple, stride: int, padding: int) -> torch.Tensor:
    """The kernel of mode ``mode_name`` of the operands' kind for CUDA
    tensors (one launch, or raises on what it does not take), its plain
    function for CPU tensors."""
    w = operands[1]
    kind = _kind(w, stride, padding)
    if kind is None:
        raise ValueError(f"no grouped-conv kernel computes the {mode_name} of weights {tuple(w.shape)} at stride "
                         f"{stride}, padding {padding}")
    mode = getattr(kind, mode_name)
    on_card = build.check(kind.name, operands, contiguous=False)
    if not (all(plain_f32(t) for t in operands) and mode.fits(*operands, stride)
            and all(t.is_contiguous() for t in operands[1:])):
        if any(t.dtype != torch.float32 for t in operands):
            raise TypeError(f"the {kind.name} kernels take float32, got {[t.dtype for t in operands]}")
        raise ValueError(f"the {kind.name} kernels take {kind.inputs}; got {[tuple(t.shape) for t in operands]}, "
                         f"strides {[t.stride() for t in operands]}, stride {stride}")
    if not on_card:
        return mode.plain(*operands, stride, padding)
    out, args = mode.call(*operands, stride)
    entry = build.bind(f"{kind.name}.cu", f"{kind.name}_{mode_name}", mode.argtypes)
    build.launch(f"{kind.name}.{mode_name}", entry, out.device, *args)
    return out


def grouped_conv_fwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    """The forward (B, S·Co, out side, out side), in the layout the kind
    gives: the kind's kernel for CUDA tensors, :func:`grouped_conv_plain` for
    CPU tensors. One launch, counted in ``<kind>.fwd``."""
    return _run("fwd", (x, w, b), stride, padding)


def grouped_conv_dgrad(g: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """The input gradient (B, S·Ci, side, side) from the output gradient
    ``g``: the kind's dgrad kernel for CUDA tensors, its plain function for
    CPU tensors. One launch, counted in ``<kind>.dgrad``."""
    return _run("dgrad", (g, w), stride, padding)


class GroupedConv(torch.autograd.Function):
    """:func:`grouped_conv_fwd`, with :func:`grouped_conv_dgrad` for the input
    gradient (on ``g`` in the memory format the kind's dgrad ``layout``
    gives) and the library's weight and bias gradients
    (``aten.convolution_backward``), each computed only where asked for."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return grouped_conv_fwd(x, w, b, stride, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding = ctx.stride, ctx.padding
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        g = g.contiguous(memory_format=_kind(w, stride, padding).dgrad.layout(x))
        dx = grouped_conv_dgrad(g, w, stride, padding) if need_x else None
        dw = db = None
        if need_w or need_b:
            n_draws, kh, kw, c_in, c_out = w.shape
            _, dw, db = torch.ops.aten.convolution_backward(
                g, x, oihw(w), [n_draws * c_out], [stride, stride], [padding, padding], [1, 1], False, [0, 0],
                n_draws, [False, need_w, need_b])
            if dw is not None:
                dw = dw.reshape(n_draws, c_out, c_in, kh, kw).permute(0, 3, 4, 2, 1)
            if db is not None:
                db = db.reshape(n_draws, c_out)
        return dx, dw, db, None, None


def grouped_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
                 padding: int = 0) -> torch.Tensor:
    """The grouped conv of ``x`` (B, S·Ci, side, side) with ``w`` (S, k, k,
    Ci, Co) and ``b`` (S, Co) at ``stride`` and ``padding``, of a kind of
    :data:`KINDS`: (B, S·Co, out side, out side), differentiable in all three."""
    return GroupedConv.apply(x, w, b, stride, padding)
