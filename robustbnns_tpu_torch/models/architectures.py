"""The four reference architectures as ``init``/``apply`` functions (port of
``robustbnns_tpu/models/architectures.py``).

* ``fc``   — Flatten -> Linear(in, h) -> act -> Linear(h, out)
* ``fc2``  — Flatten -> Linear(in, h) -> act -> Linear(h, h) -> act -> Linear(h, out)
* ``conv`` — Conv(C->32, k5, valid) -> act -> MaxPool(2) -> Conv(32->h, k5, valid)
  -> act -> MaxPool(2, stride 1) -> Flatten -> Linear(h/16·input_size, out),
  MNIST/Fashion-MNIST only (28 -> 24 -> 12 -> 8 -> 7)
* ``conv2``— the same trunk with a real, trained head (the JAX package's fix of
  the reference's fresh ``nn.Linear`` on every call, ``model_nn.py:121``)

(reference ``model_nn.py:77-121``). Inputs are NHWC and flattened in (h, w, c)
order, dense weights are ``(I, O)`` and conv weights HWIO ``(5, 5, C_in,
C_out)``, so a JAX checkpoint gives the same logits here; the convs permute to
OIHW only inside ``apply``. Initialization is torch's ``nn.Linear`` /
``nn.Conv2d`` default, ``U(-1/sqrt(fan_in), +1/sqrt(fan_in))`` for weights and
biases, with ``fan_in = C_in·25`` for a conv. ``apply`` also takes a stacked
parameter tree (a leading sample axis S on every leaf) and then returns
``(S, batch, out)``: the conv trunk runs the S draws as one convolution with
S·32 output channels, then one grouped convolution (``groups=S``), with no loop
over draws. With stacked parameters the input may carry the leading axis too,
``(S, batch, h, w, c)``, one batch per draw (an ensemble's members, each on its
own shuffle): the first convolution then groups by draw as well.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from robustbnns_tpu_torch.utils.pytree import Params, map_params

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
    # product (25·C_in, C_out)
    dims: tuple


def _uniform_fan_in(generator, shape, fan_in, device):
    bound = 1.0 / math.sqrt(fan_in)
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u * (2 * bound) - bound


def _dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``x @ w + b``; with stacked ``w`` (S, I, O) and ``b`` (S, O) it gives (S, B, O)."""
    return torch.matmul(x, p["w"]) + p["b"].unsqueeze(-2)


def _oihw(w: torch.Tensor) -> torch.Tensor:
    """Stacked HWIO conv weights (S, kh, kw, I, O) as ``F.conv2d``'s (S·O, I, kh, kw)."""
    return w.permute(0, 4, 3, 1, 2).reshape(-1, w.shape[3], w.shape[1], w.shape[2])


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
    if x.dim() == 5:
        h, groups = x.permute(1, 0, 4, 2, 3).reshape(x.shape[1], -1, x.shape[2], x.shape[3]), n_draws
    else:
        h, groups = x.permute(0, 3, 1, 2), 1  # NHWC -> NCHW
    h = F.conv2d(h, _oihw(params[0]["w"]), params[0]["b"].reshape(-1), groups=groups)
    h = F.max_pool2d(act(h), 2, 2)
    h = F.conv2d(h, _oihw(params[1]["w"]), params[1]["b"].reshape(-1), groups=n_draws)
    h = F.max_pool2d(act(h), 2, 1)  # (B, S·hidden, h4, w4)
    batch, _, h4, w4 = h.shape
    h = h.reshape(batch, n_draws, -1, h4, w4).permute(1, 0, 3, 4, 2).reshape(n_draws, batch, -1)
    return _dense(h, params[2])


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
    """Build one of the four reference architectures.

    Raises on non-power-of-two or < 16 hidden sizes (reference
    ``model_nn.py:39-40``), on ``conv`` with a dataset other than MNIST or
    Fashion-MNIST (``model_nn.py:95``), and where ``conv``'s reference head
    dimension, (hidden/16)·input_size, differs from what its trunk produces.
    """
    if hidden_size < 16 or (hidden_size & (hidden_size - 1)) != 0:
        raise ValueError("hidden size should be a power of 2, greater than 16.")
    if activation not in ACTIVATIONS:
        raise ValueError(f"Wrong activation name {activation!r}.")
    hwc = _normalize_input_shape(input_shape)
    h_in, w_in, c_in = hwc
    input_size = h_in * w_in * c_in
    act = ACTIVATIONS[activation]
    conv = architecture in ("conv", "conv2")

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
    elif conv:
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

    def init(generator: torch.Generator) -> Params:
        """torch-default init on the generator's device, layer by layer (w, then b)."""
        device = generator.device
        return tuple(
            {
                "w": _uniform_fan_in(generator, shape, fan_in, device),
                "b": _uniform_fan_in(generator, (o,), fan_in, device),
            }
            for shape, (fan_in, o) in zip(w_shapes, dims)
        )

    def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
        if conv:
            if params[0]["w"].dim() == 5:  # a leading sample axis
                return _conv_trunk_apply(act, params, x)
            return _conv_trunk_apply(act, map_params(lambda v: v[None], params), x)[0]
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
