"""Scaled dot-product attention over many sequences: ``softmax(q·kᵀ·scale)·v``
for ``q``, ``k``, ``v`` ``(N, heads, T, d_h)``, with its input gradient.

One place decides the route (:func:`takes`):

- the fused route, for plain f32 CUDA tensors outside bf16 products and
  outside ``torch.func`` transforms: ``F.scaled_dot_product_attention`` held
  to PyTorch's memory-efficient backend (``SDPBackend.EFFICIENT_ATTENTION``,
  its CUTLASS kernels ``fmha_cutlassF_*`` forward and ``fmha_cutlassB_*``
  input gradient), which raises rather than fall back to another backend.
  It keeps no T×T probabilities for the backward, only each row's
  log-sum-exp. In f32 on the H100 that backend takes its products on the
  tensor cores with each f32 operand split into two TF32 parts, three
  products a pair (CUTLASS's ``OpMultiplyAddFastF32``): f32 sums of nearly
  f32 products, not a TF32 product;
- the plain route everywhere else (the CPU, bf16 products, the wrapped
  tensors of ``torch.func``): :func:`attention_plain`, the same function in
  torch ops, with the caller's matmul (under bf16 products,
  :func:`.models.architectures.bf16_matmul`).

The attention of ``cct7``'s encoder is this op's one caller, so the span
around each call and the counters of its routes carry that name: span
``cct.attention``, counters ``cct.attention`` (a fused-route call) and
``cct.plain_attention`` (a plain-route call).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from robustbnns_tpu_torch.utils.device import bf16_products, plain_f32
from robustbnns_tpu_torch.utils.timing import count, span


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the fused route computes this call: plain f32 CUDA tensors
    (not the wrappers of a ``torch.func`` transform), not under
    :func:`.utils.device.bf16_products`."""
    return q.device.type == "cuda" and not bf16_products() and all(plain_f32(t) for t in (q, k, v))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    matmul: Callable = torch.matmul) -> torch.Tensor:
    """``softmax(q·kᵀ·scale)·v`` in torch ops, its products by ``matmul``."""
    return matmul(torch.softmax(matmul(q, k.transpose(-1, -2)) * scale, dim=-1), v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              matmul: Callable = torch.matmul) -> torch.Tensor:
    """``softmax(q·kᵀ·scale)·v`` ``(N, heads, T, d_h)``, differentiable in all
    three: the fused route where :func:`takes` says so, else
    :func:`attention_plain` with ``matmul``. Each call is one span
    ``cct.attention`` and counts its route."""
    with span("cct.attention"):
        if takes(q, k, v):
            count("cct.attention")
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(q, k, v, scale=scale)
        count("cct.plain_attention")
        return attention_plain(q, k, v, scale, matmul)
