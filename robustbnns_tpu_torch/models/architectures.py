"""The four reference architectures, a Bayesian ResNet-20 and a Bayesian
CCT-7/3×1, as ``init``/``apply`` functions (port of
``robustbnns_tpu/models/architectures.py``).

* ``fc``   — Flatten -> Linear(in, h) -> act -> Linear(h, out)
* ``fc2``  — Flatten -> Linear(in, h) -> act -> Linear(h, h) -> act -> Linear(h, out)
* ``conv`` — Conv(C->32, k5, valid) -> act -> MaxPool(2) -> Conv(32->h, k5, valid)
  -> act -> MaxPool(2, stride 1) -> Flatten -> Linear(h/16·input_size, out),
  MNIST/Fashion-MNIST only (28 -> 24 -> 12 -> 8 -> 7)
* ``conv2``— the same trunk with a real, trained head (the JAX package's fix of
  the reference's fresh ``nn.Linear`` on every call, ``model_nn.py:121``)
* ``resnet20`` — He et al.'s CIFAR-10 ResNet-20 (arXiv:1512.03385, sec. 4.2;
  no JAX counterpart): a residual trunk of 3×3 convolutions of widths h, 2h
  and 4h, then global average pooling and a dense head (:func:`_resnet_apply`)
* ``cct7`` — Hassani et al.'s Compact Convolutional Transformer CCT-7/3×1
  (arXiv:2104.05704; no JAX counterpart): a 3×3 conv tokenizer, 7 pre-norm
  transformer encoder layers of width h with 4 heads and an MLP of 2h,
  sequence pooling and a dense head (:func:`_cct_apply`)

(reference ``model_nn.py:77-121``). Inputs are NHWC and flattened in (h, w, c)
order, dense weights are ``(I, O)`` and conv weights HWIO ``(k, k, C_in,
C_out)``, so a JAX checkpoint gives the same logits here; the convs permute to
OIHW only inside ``apply``. Initialization is torch's ``nn.Linear`` /
``nn.Conv2d`` default, ``U(-1/sqrt(fan_in), +1/sqrt(fan_in))`` for weights and
biases, with ``fan_in = C_in·k·k`` for a conv. ``apply`` also takes a stacked
parameter tree (a leading sample axis S on every leaf) and then returns
``(S, batch, out)``: the conv trunk runs the S draws as one convolution with
S·32 output channels, then one grouped convolution (``groups=S``), with no loop
over draws (``resnet20``: the first conv so, every later one grouped;
``cct7``: the first conv so, then every product batched over the draws). With
stacked parameters the input may carry the leading axis too,
``(S, batch, h, w, c)``, one batch per draw (an ensemble's members, each on its
own shuffle): the first convolution then groups by draw as well.

Under ``ROBUSTBNNS_BF16=1`` (or a sampler's ``bf16_scope``,
:func:`.utils.device.bf16_products`) the products take bf16 operands as in the
JAX package (``architectures.py:96-173``): a dense layer multiplies the
bf16-rounded input and weights with f32 sums into an f32 result and adds the
bias in f32 (:func:`bf16_matmul`); a conv runs wholly in bf16, its output
included, then is upcast and gets its bias in f32. ``cct7`` takes every
other product (attention's ``q·kᵀ`` and ``p·v``, the sequence pooling's)
through :func:`bf16_matmul` too.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from robustbnns_tpu_torch.ops.attention import attention
from robustbnns_tpu_torch.ops.grouped_conv import grouped_conv, oihw, takes
from robustbnns_tpu_torch.utils.device import bf16_products
from robustbnns_tpu_torch.utils.pytree import Params, map_params
from robustbnns_tpu_torch.utils.timing import count, span

ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "relu": F.relu,
    "leaky": lambda x: F.leaky_relu(x, negative_slope=0.01),  # torch default slope
    "sigm": torch.sigmoid,
    "tanh": torch.tanh,
}


class Architecture(NamedTuple):
    """A network as functions: ``params = init(generator)``, ``logits = apply(params, x)``."""

    init: Callable[..., Params]
    apply: Callable[[Params, torch.Tensor], torch.Tensor]
    name: str
    input_shape: tuple  # NHWC, without the batch dim
    output_size: int
    hidden_size: int
    activation: str
    # ((fan_in, out), ...) per layer: a dense layer's (I, O); a conv's im2col
    # product (k·k·C_in, C_out)
    dims: tuple


def _uniform_fan_in(generator, shape, fan_in, device):
    bound = 1.0 / math.sqrt(fan_in)
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u * (2 * bound) - bound


class _Bf16Matmul(torch.autograd.Function):
    """``a @ b`` on the card through cuBLAS's bf16 GEMM with an f32 output
    (``aten::mm.dtype`` / ``bmm.dtype``): bf16 operands, f32 sums. The
    backward does the same with the cotangent rounded to bf16, and rounds
    each gradient to bf16 as the cast back from a bf16 operand does in JAX."""

    @staticmethod
    def forward(ctx, a, b):
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a16, b16)
        ctx.shapes = a.shape, b.shape
        return _mm_f32(a16, b16)

    @staticmethod
    def backward(ctx, g):
        a16, b16 = ctx.saved_tensors
        a_shape, b_shape = ctx.shapes
        g16 = g.to(torch.bfloat16)
        ga = gb = None
        if ctx.needs_input_grad[0]:  # summed over broadcast axes in f32, then rounded once
            ga = _mm_f32(g16, b16.transpose(-1, -2)).sum_to_size(a_shape).to(torch.bfloat16).float()
        if ctx.needs_input_grad[1]:
            gb = _mm_f32(a16.transpose(-1, -2), g16).sum_to_size(b_shape).to(torch.bfloat16).float()
        return ga, gb


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 CUDA tensors (broadcast like ``torch.matmul``, at
    least 2-D each) into f32. Raises where this torch has no f32-output bf16
    GEMM on the card: there is no second route."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    try:
        if not lead:
            return torch.mm(a, b, out_dtype=torch.float32)
        a3 = a.expand(lead + a.shape[-2:]).reshape(-1, *a.shape[-2:])
        b3 = b.expand(lead + b.shape[-2:]).reshape(-1, *b.shape[-2:])
        return torch.bmm(a3, b3, out_dtype=torch.float32).reshape(lead + (a.shape[-2], b.shape[-1]))
    except (TypeError, NotImplementedError) as e:  # no out_dtype argument, or no kernel for it
        raise RuntimeError(
            f"ROBUSTBNNS_BF16 needs torch.mm/bmm(..., out_dtype=torch.float32) on bf16 CUDA tensors, "
            f"which torch {torch.__version__} refused: {e}"
        ) from e


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (``torch.matmul``'s broadcasting, both at least 2-D) with
    both operands rounded to bf16, the products and sums in f32 and an f32
    result: JAX's ``jnp.dot(a.astype(bf16), b.astype(bf16),
    preferred_element_type=f32)``. On the CPU the rounded operands are
    multiplied in f32 (a product of two bf16 values is exact in f32), and
    autograd rounds each gradient to bf16 at the cast, as JAX does; on the
    card :class:`_Bf16Matmul`."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float())
    return _Bf16Matmul.apply(a, b)


def _product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul(a, b)``; under :func:`.utils.device.bf16_products`, :func:`bf16_matmul`."""
    return bf16_matmul(a, b) if bf16_products() else torch.matmul(a, b)


def _dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``x @ w + b``; with stacked ``w`` (S, I, O) and ``b`` (S, O) it gives (S, B, O).
    Under :func:`.utils.device.bf16_products`, :func:`bf16_matmul`."""
    return _product(x, p["w"]) + p["b"].unsqueeze(-2)


def _conv2d(h: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], groups: int, stride: int = 1,
            padding: int = 0) -> torch.Tensor:
    """``F.conv2d`` (OIHW; VALID and stride 1 unless asked; ``b`` None for
    no bias); under :func:`.utils.device.bf16_products` wholly in bf16,
    output included, then upcast, the bias added in f32 (JAX
    ``architectures.py:103-111``)."""
    if bf16_products():
        y = F.conv2d(h.to(torch.bfloat16), w.to(torch.bfloat16), None, stride, padding, 1, groups).float()
        return y if b is None else y + b[:, None, None]
    return F.conv2d(h, w, b, stride, padding, 1, groups)


def _grouped_conv2d(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
                    padding: int = 0, library_counter: str | None = None) -> torch.Tensor:
    """A conv grouped by draw, group s with draw s's stacked HWIO weights
    ``w[s]``: where :func:`.ops.grouped_conv.takes` says a hand-written
    kernel computes it (on the card in exact f32: the conv trunk's second
    conv, ResNet-20's residual 3×3 convs), :func:`.ops.grouped_conv.grouped_conv`
    on the stacked weights as they are. Otherwise (the CPU, bf16 products,
    other shapes, strides or padding, ``torch.func`` transforms)
    :func:`_conv2d`, counted in ``library_counter`` where one is given."""
    if takes(h, w, b, stride, padding):
        return grouped_conv(h, w.contiguous(), b.contiguous(), stride, padding)
    if library_counter is not None:
        count(library_counter)
    return _conv2d(h, oihw(w), b.reshape(-1), w.shape[0], stride, padding)


def _draws_as_channels(x: torch.Tensor, n_draws: int):
    """The trunks' first input as NCHW and the first conv's groups: a shared
    input ``(batch, h, w, c)`` as it is (one group); inputs per draw ``(S,
    batch, h, w, c)`` side by side as S·c channels, one group a draw."""
    if x.dim() == 5:
        return x.permute(1, 0, 4, 2, 3).reshape(x.shape[1], -1, x.shape[2], x.shape[3]), n_draws
    return x.permute(0, 3, 1, 2), 1


def _conv_trunk_apply(act, params: Params, x: torch.Tensor) -> torch.Tensor:
    """The conv trunk and head on stacked parameters: ``(S, batch, out)``.

    conv5 VALID -> act -> max-pool 2/2 -> conv5 VALID -> act -> max-pool 2/1 ->
    flatten in (h, w, c) order -> dense. A shared input ``(batch, h, w, c)``
    goes through the first conv once with S·32 output channels; inputs per
    draw ``(S, batch, h, w, c)`` sit side by side as S·c channels of a conv
    grouped by draw. The second conv runs grouped, group s on draw s's 32
    channels.
    """
    n_draws = params[0]["w"].shape[0]
    with span("conv_trunk"):
        h, groups = _draws_as_channels(x, n_draws)
        h = _conv2d(h, oihw(params[0]["w"]), params[0]["b"].reshape(-1), groups)
        h = F.max_pool2d(act(h), 2, 2)
        h = _grouped_conv2d(h, params[1]["w"], params[1]["b"])
        h = F.max_pool2d(act(h), 2, 1)  # (B, S·hidden, h4, w4)
        batch, _, h4, w4 = h.shape
        h = h.reshape(batch, n_draws, -1, h4, w4).permute(1, 0, 3, 4, 2).reshape(n_draws, batch, -1)
        return _dense(h, params[2])


RESNET_STAGES, RESNET_BLOCKS = 3, 3  # He et al.'s n = 3: 6n + 2 = 20 weighted layers


def _resnet_shapes(c_in: int, width: int, classes: int) -> list:
    """ResNet-20's weight shapes in order: the first 3×3 conv (c_in -> width),
    then each stage's blocks, two 3×3 convs a block (HWIO, widths width,
    2·width, 4·width), then the head (4·width, classes)."""
    shapes, c = [(3, 3, c_in, width)], width
    for stage in range(RESNET_STAGES):
        out = width << stage
        for _ in range(RESNET_BLOCKS):
            shapes += [(3, 3, c, out), (3, 3, out, out)]
            c = out
    return shapes + [(c, classes)]


def _option_a(h: torch.Tensor, n_draws: int, out_channels: int) -> torch.Tensor:
    """He et al.'s option-A shortcut where a stage halves the sides and
    widens the channels: every other pixel (``h[:, :, ::2, ::2]``), and each
    draw's own channels between zeros, a quarter of the new width on each
    side (8 + 16 + 8 for 16 -> 32; the paper leaves the place open)."""
    h = h[:, :, ::2, ::2]
    batch, _, height, width = h.shape
    h = h.reshape(batch, n_draws, -1, height, width)
    pad = (out_channels - h.shape[2]) // 2
    return F.pad(h, (0, 0, 0, 0, pad, pad)).reshape(batch, -1, height, width)


def _resnet_apply(act, params: Params, x: torch.Tensor) -> torch.Tensor:
    """ResNet-20 on stacked parameters: ``(S, batch, out)``.

    ``h = act(conv3x3(x) + b)``; three stages of three basic blocks, ``y =
    act(conv3x3(h; stride s) + b1)``, ``h = act(conv3x3(y) + b2 +
    shortcut(h))``, with s = 2 in the first block of stages 2 and 3 and the
    shortcut the identity or, there, :func:`_option_a`; global average
    pooling; ``logits = h·W + b``. Every conv pads by 1.

    Departures from He et al., for a posterior over the weights: BatchNorm
    in its inference form, a per-channel affine map, folded into each conv's
    weight and bias (so no batch statistics); no per-pixel mean subtracted
    (inputs in [0, 1], as the attacks clamp them); torch's default init.

    A shared input goes through the first conv once with S·width output
    channels, on ``F.conv2d``; inputs per draw group by draw there too
    (:func:`_draws_as_channels`). Every later conv is grouped by draw
    (:func:`_grouped_conv2d`): on the card in exact f32 at width 16 on 32×32
    inputs, the hand-written 3×3 kernel of :mod:`.ops.grouped_conv`, forward
    and input gradient; otherwise ``F.conv2d``. The trunk runs in contiguous
    NCHW, which the kernel reads (cuDNN's grouped engine, too, took
    channels-last activations in three times the kernels). Counted:
    ``resnet.forwards``, one a forward, and ``resnet.cudnn_convs``, the
    convs that ``F.conv2d`` ran (1 on the card, 19 on the CPU, under bf16
    products or inside ``torch.func`` transforms); spans ``resnet.stage1``
    .. ``resnet.stage3`` inside ``conv_trunk``."""
    n_draws = params[0]["w"].shape[0]
    count("resnet.forwards")
    with span("conv_trunk"):
        h, groups = _draws_as_channels(x, n_draws)
        h = act(_conv2d(h.contiguous(), oihw(params[0]["w"]), params[0]["b"].reshape(-1), groups, 1, 1))
        count("resnet.cudnn_convs")
        layer = 1
        for stage in range(RESNET_STAGES):
            with span(f"resnet.stage{stage + 1}"):
                for block in range(RESNET_BLOCKS):
                    stride = 2 if stage and not block else 1
                    w = params[layer]["w"]
                    y = act(_grouped_conv2d(h, w, params[layer]["b"], stride, 1, "resnet.cudnn_convs"))
                    shortcut = h if stride == 1 else _option_a(h, n_draws, w.shape[-1])
                    h = act(_grouped_conv2d(y, params[layer + 1]["w"], params[layer + 1]["b"], 1, 1,
                                            "resnet.cudnn_convs") + shortcut)
                    layer += 2
        h = h.mean(dim=(2, 3))  # global average pooling: (B, S·4·width)
        return _dense(h.reshape(h.shape[0], n_draws, -1).transpose(0, 1), params[-1])


CCT_LAYERS, CCT_HEADS, CCT_MLP_RATIO = 7, 4, 2  # CCT-7/3×1: 7 encoder layers, 4 heads, MLP 2× the width
LAYER_NORM_EPS = 1e-5  # torch's and CCT's default


def _cct_layers(c_in: int, width: int, tokens: int, classes: int) -> list:
    """CCT's 39 layer dicts as ``(w shape, b shape, fan-in, is a LayerNorm)``:
    the tokenizer (conv HWIO ``(3, 3, c_in, width)``, no bias, so the
    positional table P ``(tokens, width)`` takes ``"b"``); per encoder layer
    LN_pre, attention (``w`` ``[W_q|W_k|W_v|W_o]`` ``(width, 4·width)``, ``b``
    W_o's bias), LN_1, the MLP's two dense layers; then LN_f, the sequence
    pooling's gate ``(width, 1)`` and the head. A LayerNorm's ``w`` is its
    scale γ and ``b`` its shift β, at fan-in 1."""
    mlp = CCT_MLP_RATIO * width
    norm = ((width,), (width,), 1, True)
    layers = [((3, 3, c_in, width), (tokens, width), 9 * c_in, False)]
    for _ in range(CCT_LAYERS):
        layers += [norm, ((width, 4 * width), (width,), width, False), norm,
                   ((width, mlp), (mlp,), width, False), ((mlp, width), (width,), mlp, False)]
    return layers + [norm, ((width, 1), (1,), width, False), ((width, classes), (classes,), width, False)]


def _layer_norm(z: torch.Tensor, p: dict) -> torch.Tensor:
    """LayerNorm over the last axis of ``z`` ``(S, N, d)`` with each draw's
    own scale ``w`` and shift ``b`` ``(S, d)``."""
    return torch.addcmul(p["b"][:, None], F.layer_norm(z, z.shape[-1:], eps=LAYER_NORM_EPS), p["w"][:, None])


def _self_attention(z: torch.Tensor, p: dict, n_seq: int) -> torch.Tensor:
    """Multi-head self-attention of ``z`` ``(S, N, d)``, N = batch·T tokens of
    ``n_seq`` = S·batch sequences: ``q, k, v = z·[W_q|W_k|W_v]`` (no bias),
    :func:`.ops.attention.attention` over the S·batch·heads sequences, then
    ``·W_o + b_o``. The heads are views of the products, ``(S·batch, heads,
    T, d/heads)``, never copies."""
    n_draws, _, width = z.shape
    head = width // CCT_HEADS
    qkv = _product(z, p["w"][..., :3 * width]).view(n_seq, -1, 3, CCT_HEADS, head)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    a = attention(q, k, v, head ** -0.5, _product)  # (S·batch, heads, T, head)
    a = a.transpose(1, 2).reshape(n_draws, -1, width)
    return _product(a, p["w"][..., 3 * width:]) + p["b"][:, None]


def _cct_apply(act, params: Params, x: torch.Tensor) -> torch.Tensor:
    """CCT-7/3×1 on stacked parameters: ``(S, batch, out)``.

    Tokenizer: ``t = maxpool3x3/2,pad1(act(conv3x3(x)))`` (stride 1, pad 1,
    no bias), the (h, w) pixels in row-major order as T tokens of width d,
    ``z = t + P``. Each of 7 layers: ``z = LN_1(z + MHSA(LN_pre(z)))``, then
    ``z = z + W_2·gelu(W_1·z + b_1) + b_2`` (GELU in its erf form). Head:
    ``z = LN_f(z)``, ``p = softmax_T(z·w_g + b_g)``, ``logits = (Σ_t p_t
    z_t)·W + b``. Dropout and stochastic depth are train-time only.

    A shared input goes through the tokenizer's conv once with S·d output
    channels on ``F.conv2d`` (inputs per draw group by draw,
    :func:`_draws_as_channels`); then the tokens of all draws sit in one
    ``(S, batch·T, d)`` tensor, each dense product one batched matmul over
    the draws, each LayerNorm with its draw's own scale and shift, and the
    attention over S·batch·heads sequences at once. Counted:
    ``cct.forwards``, one a forward; the attention op counts its routes.
    Inside ``conv_trunk``."""
    n_draws, width = params[0]["w"].shape[0], params[0]["w"].shape[-1]
    count("cct.forwards")
    with span("conv_trunk"):
        h, groups = _draws_as_channels(x, n_draws)
        h = F.max_pool2d(act(_conv2d(h.contiguous(), oihw(params[0]["w"]), None, groups, 1, 1)), 3, 2, 1)
        batch, _, side_h, side_w = h.shape
        tokens = side_h * side_w
        z = h.reshape(batch, n_draws, width, tokens).permute(1, 0, 3, 2) + params[0]["b"][:, None]
        z = z.reshape(n_draws, batch * tokens, width)
        for layer in range(CCT_LAYERS):
            ln_pre, attn, ln_1, mlp_1, mlp_2 = params[1 + 5 * layer:6 + 5 * layer]
            z = _layer_norm(z + _self_attention(_layer_norm(z, ln_pre), attn, n_draws * batch), ln_1)
            z = z + _dense(F.gelu(_dense(z, mlp_1)), mlp_2)
        z = _layer_norm(z, params[-3])
        pool = torch.softmax(_dense(z, params[-2]).reshape(n_draws * batch, 1, tokens), dim=-1)
        v = _product(pool, z.reshape(n_draws * batch, tokens, width))  # Σ_t p_t z_t
        return _dense(v.reshape(n_draws, batch, width), params[-1])


def _normalize_input_shape(input_shape: Sequence[int]) -> tuple:
    """Accept reference-style CHW shapes and return HWC (``architectures.py:136-148``)."""
    s = tuple(int(d) for d in input_shape)
    if len(s) != 3:
        raise ValueError(f"input_shape must be rank 3, got {s}")
    if s[0] in (1, 3) and s[2] not in (1, 3):
        return (s[1], s[2], s[0])
    return s


def build_architecture(
    architecture: str,
    activation: str,
    input_shape: Sequence[int],
    output_size: int,
    hidden_size: int,
    dataset_name: str = "",
) -> Architecture:
    """Build one of the four reference architectures (``fc``, ``fc2``,
    ``conv``, ``conv2``), ``resnet20`` or ``cct7``.

    Raises on non-power-of-two or < 16 hidden sizes (reference
    ``model_nn.py:39-40``), on ``conv`` with a dataset other than MNIST or
    Fashion-MNIST (``model_nn.py:95``), where ``conv``'s reference head
    dimension, (hidden/16)·input_size, differs from what its trunk produces,
    and on ``resnet20`` inputs whose sides do not divide by 4 (its two
    stride-2 stages). ``resnet20``'s ``hidden_size`` is its first stage's
    width (16 as published); ``cct7``'s is its embedding width (256 as
    published), the heads' width a quarter of it, and its ``activation`` the
    tokenizer's (ReLU as published). ``cct7``'s LayerNorms start at scale 1
    and shift 0; every other layer takes torch's default init, the
    positional table P at the tokenizer conv's fan-in.
    """
    if hidden_size < 16 or (hidden_size & (hidden_size - 1)) != 0:
        raise ValueError("hidden size should be a power of 2, greater than 16.")
    if activation not in ACTIVATIONS:
        raise ValueError(f"Wrong activation name {activation!r}.")
    hwc = _normalize_input_shape(input_shape)
    h_in, w_in, c_in = hwc
    input_size = h_in * w_in * c_in
    act = ACTIVATIONS[activation]
    trunk = {"conv": _conv_trunk_apply, "conv2": _conv_trunk_apply, "resnet20": _resnet_apply,
             "cct7": _cct_apply}.get(architecture)

    if architecture == "fc":
        dims = ((input_size, hidden_size), (hidden_size, output_size))
        w_shapes = dims
    elif architecture == "fc2":
        dims = (
            (input_size, hidden_size),
            (hidden_size, hidden_size),
            (hidden_size, output_size),
        )
        w_shapes = dims
    elif architecture == "resnet20":
        if h_in % 4 or w_in % 4:
            raise ValueError(f"resnet20 halves the input's sides twice: {hwc} does not divide by 4")
        w_shapes = tuple(_resnet_shapes(c_in, hidden_size, output_size))
        dims = tuple((math.prod(shape[:-1]), shape[-1]) for shape in w_shapes)
    elif architecture == "cct7":
        tokens = ((h_in + 1) // 2) * ((w_in + 1) // 2)  # after the max-pool 3/2, pad 1
        layers = _cct_layers(c_in, hidden_size, tokens, output_size)
        dims = tuple((fan_in, w[-1]) for w, _, fan_in, _ in layers)
    elif trunk is not None:
        if architecture == "conv" and dataset_name not in ("mnist", "fashion_mnist"):
            raise NotImplementedError("conv supports mnist/fashion_mnist only (reference model_nn.py:95)")
        # conv5 VALID -> pool 2/2 -> conv5 VALID -> pool 2/1
        h4, w4 = (h_in - 4) // 2 - 5, (w_in - 4) // 2 - 5
        if h4 < 1 or w4 < 1:
            raise ValueError(f"input {hwc} is too small for the conv trunk")
        flat_dim = h4 * w4 * hidden_size
        if architecture == "conv" and (hidden_size // 16) * input_size != flat_dim:
            raise ValueError(
                f"conv flatten mismatch: reference head expects {(hidden_size // 16) * input_size}, "
                f"trunk produces {flat_dim} (input {hwc})"
            )
        dims = ((25 * c_in, 32), (25 * 32, hidden_size), (flat_dim, output_size))
        w_shapes = ((5, 5, c_in, 32), (5, 5, 32, hidden_size), (flat_dim, output_size))
    else:
        raise NotImplementedError(f"unknown architecture {architecture!r}")

    if architecture != "cct7":
        layers = [(shape, (o,), fan_in, False) for shape, (fan_in, o) in zip(w_shapes, dims)]

    def init(generator: torch.Generator) -> Params:
        """torch-default init on the generator's device, layer by layer (w,
        then b); a LayerNorm's scale 1 and shift 0."""
        device = generator.device
        return tuple(
            {"w": torch.ones(w, device=device), "b": torch.zeros(b, device=device)} if norm else
            {"w": _uniform_fan_in(generator, w, fan_in, device), "b": _uniform_fan_in(generator, b, fan_in, device)}
            for w, b, fan_in, norm in layers
        )

    def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
        if trunk is not None:
            if params[0]["w"].dim() == 5:  # a leading sample axis
                return trunk(act, params, x)
            return trunk(act, map_params(lambda v: v[None], params), x)[0]
        h = x.flatten(-3) if x.dim() == 5 else x.reshape(x.shape[0], -1)
        for p in params[:-1]:
            h = act(_dense(h, p))
        return _dense(h, params[-1])

    return Architecture(
        init=init,
        apply=apply,
        name=architecture,
        input_shape=hwc,
        output_size=int(output_size),
        hidden_size=int(hidden_size),
        activation=activation,
        dims=dims,
    )
