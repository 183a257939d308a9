"""PRNG discipline (port of ``robustbnns_tpu/utils/prng.py``).

JAX keys become explicit ``torch.Generator`` objects. The two idioms of the
reference map as in the JAX package:

* *seeded posterior draws* (``forward(..., seeds=[0..S-1])``,
  reference ``model_bnn.py:222-226,376``) -> :func:`keys_from_seeds` builds one
  fresh generator per integer seed, so seed ``i`` always selects the same draw;
* *fresh draws per call* (reference ``adversarialAttacks.py:97``) -> the caller
  threads one CPU generator through the calls, and each call draws its own
  seeds from it with :func:`draw_seed`.

Drawing a seed from a CPU generator never waits for the card, so a PGD
iteration can pick its fresh draws without synchronising with the device.
"""
from __future__ import annotations

from typing import Sequence

import torch

_SEED_HIGH = 2**31 - 1  # same range as the JAX package's randint seeds


def key_from_seed(seed: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` deterministically derived from an integer seed."""
    return torch.Generator(device=device).manual_seed(int(seed))


def keys_from_seeds(seeds: Sequence[int], device="cpu") -> list[torch.Generator]:
    """One fresh generator per integer seed: the seed *is* the draw's identity."""
    return [key_from_seed(s, device) for s in seeds]


def draw_seed(generator: torch.Generator) -> int:
    """A fresh int32 seed from a CPU generator (no device synchronisation)."""
    return int(torch.randint(0, _SEED_HIGH, (), generator=generator))
