"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU. A request for
``cuda`` on a machine without a card raises: nothing falls back to the CPU.
Every entry point resolves its device here, so every one runs exact f32.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Turn a device name into a ``torch.device``, refusing a missing card, and
    turn TF32 off (:func:`exact_f32`) for the process."""
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
    """Keep float32 products exact on the card: no TF32 in matmuls or cuDNN
    (``torch.backends.cudnn.allow_tf32`` defaults to True)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
