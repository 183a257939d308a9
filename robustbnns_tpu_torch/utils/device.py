"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A request for
``cuda`` on a machine without a card raises: nothing falls back to the CPU.
Every entry point resolves its device here, so every one runs exact f32 and
reproducibly.

The one opt-in to reduced precision of the dense and conv products is decided
here too (:func:`bf16_products`): ``ROBUSTBNNS_BF16=1``, read at each call as
the JAX package reads it per trace (``models/architectures.py:151-163``), or
an open :func:`bf16_scope`, which the samplers open around each potential
evaluation under ``precision="default"``. Neither touches the TF32 flags.
"""
from __future__ import annotations

import contextlib
import os

import torch

_bf16_scopes = 0  # open bf16_scope contexts in this process


def resolve_device(device="cuda") -> torch.device:
    """Turn a device name into a ``torch.device``, refusing a missing card, and
    make the process's products exact and reproducible (:func:`exact_f32`)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!s}: use 'cuda' or 'cpu'")
    exact_f32()
    return device


def exact_f32() -> None:
    """Keep float32 products exact and reproducible on the card: no TF32 in
    matmuls or cuDNN (``torch.backends.cudnn.allow_tf32`` defaults to True),
    and only cuDNN's deterministic algorithms. Without the last, the weight
    gradient of a grouped convolution (an ensemble's or a stacked posterior's
    conv trunk) sums in another order from run to run, so a training from one
    seed gives other weights each time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def bf16_products() -> bool:
    """Whether dense and conv products take bf16 operands: ``ROBUSTBNNS_BF16=1``
    or an open :func:`bf16_scope`. Read at every product, never cached."""
    return _bf16_scopes > 0 or os.environ.get("ROBUSTBNNS_BF16") == "1"


def plain_f32(t: torch.Tensor) -> bool:
    """Whether ``t`` is a plain f32 tensor: not another dtype, and not the
    wrapper of a ``torch.func`` transform, whose data a kernel cannot read."""
    return t.dtype == torch.float32 and not torch._C._functorch.is_functorch_wrapped_tensor(t)


@contextlib.contextmanager
def bf16_scope(enabled: bool = True):
    """Run the block's dense and conv products on bf16 operands (with
    ``enabled``), as ``jax.default_matmul_precision("default")`` does on the
    TPU for a sampler's potential. Only the products of
    :mod:`.models.architectures` read it: a custom potential's own
    ``torch.matmul`` stays exact f32."""
    global _bf16_scopes
    if not enabled:
        yield
        return
    _bf16_scopes += 1
    try:
        yield
    finally:
        _bf16_scopes -= 1
