"""Inputs and weights made from the run's seed, on the run's device.

Every random stream is its own ``torch.Generator``, seeded from the run's
seed and a tag (:func:`sub_seed`), so one seed gives the same images,
labels and posterior whatever else the run draws. Each leaf is its own
allocation: the program's kernels take 16-byte aligned tensors.
"""
from __future__ import annotations

import hashlib
import math

import torch

from benchmark import work


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed for the stream ``tags`` of the run seeded with ``seed``."""
    digest = hashlib.sha256(":".join(str(t) for t in (int(seed), *tags)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))


def seeded_posterior(config: dict, gen: torch.Generator):
    """``loc`` from torch's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    and ``rho`` with ``softplus(rho)`` the configuration's share of that
    bound, layer by layer. Returns ``(loc, rho)`` as lists of ``{"b", "w"}``."""
    share = config["posterior"]["softplus_rho_of_bound"]
    loc, rho = [], []
    for layer in work.arch(config).param_shapes(config):
        bound = 1.0 / math.sqrt(layer["fan_in"])
        rho_value = math.log(math.expm1(share * bound))
        loc.append({k: (torch.rand(layer[k], generator=gen, device=gen.device) * 2 - 1) * bound for k in ("b", "w")})
        rho.append({k: torch.full(layer[k], rho_value, device=gen.device) for k in ("b", "w")})
    return loc, rho


def normal_posterior(config: dict, gen: torch.Generator):
    """``loc, rho ~ N(0, 1)``, the reference's SVI init (``model_bnn.py:125-126``)."""
    shapes = work.arch(config).param_shapes(config)
    return tuple([{k: torch.randn(layer[k], generator=gen, device=gen.device) for k in ("b", "w")}
                  for layer in shapes] for _ in range(2))


def images(config: dict, gen: torch.Generator, lead: tuple) -> torch.Tensor:
    """MNIST-shaped images ``lead + (h, w, c)`` with pixels U[0, 1)."""
    return torch.rand(tuple(lead) + tuple(config["input_shape"]), generator=gen, device=gen.device)


def labels(config: dict, gen: torch.Generator, lead: tuple) -> torch.Tensor:
    return torch.randint(0, config["output_size"], tuple(lead), generator=gen, device=gen.device)
