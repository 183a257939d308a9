"""Mean-field Gaussian posterior (port of ``robustbnns_tpu/inference/svi.py``,
the slice's part).

``q(w) = N(loc, softplus(rho)^2)`` per scalar (reference guide
``model_bnn.py:127``). The ELBO and the epoch loop come with the SVI-training
slice, together with the dparams kernels they need (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from robustbnns_tpu_torch.utils.pytree import Params, map_params, normal_like_tree


class MeanFieldPosterior(NamedTuple):
    """Variational parameters: two trees shaped like the network's parameters."""

    loc: Params
    rho: Params


def init_meanfield(generator: torch.Generator, params_template: Params) -> MeanFieldPosterior:
    """``loc, rho ~ N(0, 1)`` — the reference's ``randn_like`` init (``model_bnn.py:125-126``)."""
    return MeanFieldPosterior(
        loc=normal_like_tree(generator, params_template),
        rho=normal_like_tree(generator, params_template),
    )


def meanfield_scale(posterior: MeanFieldPosterior) -> Params:
    return map_params(F.softplus, posterior.rho)


def sample_meanfield_eps(posterior: MeanFieldPosterior, eps: Params) -> Params:
    """The reparameterized draw ``w = loc + softplus(rho)·eps`` for a given ``eps``.

    ``eps`` leaves may carry a leading sample axis; the draw then does too.
    """
    return map_params(
        lambda m, r, e: m + F.softplus(r) * e, posterior.loc, posterior.rho, eps
    )


def sample_meanfield(posterior: MeanFieldPosterior, generator: torch.Generator) -> Params:
    """One reparameterized weight draw with ``eps`` from ``generator``."""
    return sample_meanfield_eps(posterior, normal_like_tree(generator, posterior.loc))
