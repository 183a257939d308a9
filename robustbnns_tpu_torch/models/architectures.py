"""The dense reference architectures as ``init``/``apply`` functions (port of
``robustbnns_tpu/models/architectures.py``, the slice's part).

* ``fc``  — Flatten -> Linear(in, h) -> act -> Linear(h, out)
* ``fc2`` — Flatten -> Linear(in, h) -> act -> Linear(h, h) -> act -> Linear(h, out)

(reference ``model_nn.py:77-91``). Inputs are NHWC and flattened in (h, w, c)
order, weights are ``(I, O)``, so a JAX checkpoint gives the same logits here.
Initialization is torch's ``nn.Linear`` default, ``U(-1/sqrt(fan_in),
+1/sqrt(fan_in))`` for weights and biases. ``apply`` also takes a stacked
parameter tree (a leading sample axis on every leaf) and then returns
``(S, batch, out)``. ``conv``/``conv2`` wait for a later slice.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from robustbnns_tpu_torch.utils.pytree import Params

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
    dims: tuple  # ((in, out), ...) of the dense layers


def _uniform_fan_in(generator, shape, fan_in, device):
    bound = 1.0 / math.sqrt(fan_in)
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return u * (2 * bound) - bound


def _dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """``x @ w + b``; with stacked ``w`` (S, I, O) and ``b`` (S, O) it gives (S, B, O)."""
    return torch.matmul(x, p["w"]) + p["b"].unsqueeze(-2)


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
    """Build ``fc`` or ``fc2`` (reference ``model_nn.py:39-40`` size rules)."""
    if hidden_size < 16 or (hidden_size & (hidden_size - 1)) != 0:
        raise ValueError("hidden size should be a power of 2, greater than 16.")
    if activation not in ACTIVATIONS:
        raise ValueError(f"Wrong activation name {activation!r}.")
    hwc = _normalize_input_shape(input_shape)
    input_size = hwc[0] * hwc[1] * hwc[2]
    act = ACTIVATIONS[activation]

    if architecture == "fc":
        dims = ((input_size, hidden_size), (hidden_size, output_size))
    elif architecture == "fc2":
        dims = (
            (input_size, hidden_size),
            (hidden_size, hidden_size),
            (hidden_size, output_size),
        )
    elif architecture in ("conv", "conv2"):
        raise NotImplementedError(
            f"architecture {architecture!r} is not ported yet: conv/conv2 come in "
            "the conv-architectures slice (ROADMAP.md)"
        )
    else:
        raise NotImplementedError(f"unknown architecture {architecture!r}")

    def init(generator: torch.Generator) -> Params:
        """torch-default init on the generator's device, layer by layer (w, then b)."""
        device = generator.device
        return tuple(
            {
                "w": _uniform_fan_in(generator, (i, o), i, device),
                "b": _uniform_fan_in(generator, (o,), i, device),
            }
            for i, o in dims
        )

    def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape(x.shape[0], -1)
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
