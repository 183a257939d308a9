"""The posterior draws of the program, worked out again from the seeds the
benchmark hands it (a frozen copy of the rules, in plain PyTorch).

* ``draw_seed``: a fresh int32 seed from a CPU ``torch.Generator``,
  ``randint(0, 2**31 - 1)``, which the attack loop draws once per forward.
* Fused path (``fc``/``fc2``): layer ``l`` of a forward with seed ``s`` draws
  with seed ``(s + l * 1000003) mod 2**32``; ``eps[j, i, o]`` is Philox4x32-10
  with key ``(seed, 0)`` and counter ``(o >> 2, i, j, 0)``, each word's top 23
  bits spliced into a float in [1, 2), a Box-Muller pair from two words, the
  bias at row ``i = I``.
* Unfused path: one CUDA (or CPU) generator seeded with ``s``, one
  ``torch.randn((S,) + shape)`` a leaf, layer by layer, ``b`` before ``w``.
* SVI epochs: one generator; ``randperm(n)``, then per step the ELBO draw
  (one ``randn(shape)`` a leaf) and the accuracy draws (``randn((A,) +
  shape)`` a leaf), in that order.

Imports torch alone.
"""
from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
SEED_HIGH = 2**31 - 1
LAYER_SEED_STRIDE = 1000003
TWO_PI_F32 = float(np.float32(6.283185307179586))


def draw_seed(state: torch.Tensor) -> int:
    """The seed a forward draws from a CPU generator whose state was ``state``."""
    generator = torch.Generator()
    generator.set_state(state)
    return int(torch.randint(0, SEED_HIGH, (), generator=generator))


def layer_seed(seed: int, layer: int) -> int:
    return (int(seed) + layer * LAYER_SEED_STRIDE) & MASK


def _philox(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors that hold uint32 words."""
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & MASK
            k1 = (k1 + 0xBB67AE85) & MASK
        p0 = c0 * 0xD2511F53
        p1 = c2 * 0xCD9E8D57
        c0, c1, c2, c3 = (
            ((p1 >> 32) & MASK) ^ c1 ^ k0,
            p1 & MASK,
            ((p0 >> 32) & MASK) ^ c3 ^ k1,
            p0 & MASK,
        )
    return c0, c1, c2, c3


def _unit(r: torch.Tensor) -> torch.Tensor:
    return ((r >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)


def _box_muller(a, b):
    rad = torch.sqrt(-2.0 * torch.log(2.0 - _unit(a)))
    theta = TWO_PI_F32 * (_unit(b) - 1.0)
    return rad * torch.cos(theta), rad * torch.sin(theta)


def fused_noise(seed: int, samples: range, n_rows: int, o_dim: int, device) -> torch.Tensor:
    """``eps[j, i, o]`` for ``j`` in ``samples`` and ``i < n_rows``: (len(samples), n_rows, O), f32."""
    quads = -(-o_dim // 4)
    shape = (len(samples), n_rows, quads)
    ar = lambda start, n: torch.arange(start, start + n, dtype=torch.int64, device=device)  # noqa: E731
    c0 = ar(0, quads).view(1, 1, -1).expand(shape)
    c1 = ar(0, n_rows).view(1, -1, 1).expand(shape)
    c2 = ar(samples.start, len(samples)).view(-1, 1, 1).expand(shape)
    c3 = torch.zeros(shape, dtype=torch.int64, device=device)
    r0, r1, r2, r3 = _philox(c0, c1, c2, c3, int(seed) & MASK, 0)
    z0, z1 = _box_muller(r0, r1)
    z2, z3 = _box_muller(r2, r3)
    return torch.stack([z0, z1, z2, z3], dim=-1).reshape(len(samples), n_rows, 4 * quads)[..., :o_dim]


def leaf_order(layers: list) -> list:
    """``(layer, key)`` of every leaf in the program's tree order: ``b`` before ``w``."""
    return [(li, k) for li, layer in enumerate(layers) for k in sorted(layer)]


def randn_tree(generator: torch.Generator, layers: list, lead: tuple = ()) -> list:
    """One ``randn(lead + shape)`` a leaf in tree order, as dicts like ``layers``."""
    out = [dict() for _ in layers]
    for li, k in leaf_order(layers):
        out[li][k] = torch.randn(lead + tuple(layers[li][k].shape), generator=generator,
                                 device=generator.device, dtype=torch.float32)
    return out


def unfused_noise(seed: int, layers: list, n_samples: int, device) -> list:
    """The S draws' noise of an unfused forward with seed ``seed``."""
    return randn_tree(torch.Generator(device=device).manual_seed(int(seed)), layers, (n_samples,))
