"""Hamiltonian Monte Carlo on a flat position vector (port of
``robustbnns_tpu/inference/hmc.py``).

Replaces Pyro's ``HMC`` kernel and its ``MCMC`` runner (reference
``model_bnn.py:269-277``) as the JAX package does:

* positions are one flat vector (:func:`.utils.pytree.flatten_tree_to_vector`),
  so a leapfrog half step is one vector op;
* the potential's value and gradient come from one forward and one backward
  (:class:`_Potential`): a transition costs ``num_steps + 1`` of them, the
  value at the start and at the end of the trajectory coming with the
  gradient there; a step-size search costs one per trial step;
* warmup adapts the step size by dual averaging toward ``target_accept`` and a
  diagonal mass matrix by Stan's windowed scheme (init buffer, Welford
  window, mass switch with a step-size search under the new metric, term
  buffer), as Pyro's defaults do;
* chains are a leading axis of ``q`` with adaptation state per chain: C
  chains are one batched forward and backward per evaluation. A potential
  takes ``q`` of shape ``(..., D)`` and returns one value per chain, shape
  ``(...)``;
* the posterior is a stacked ``(S, D)`` tensor, not the reference's N
  deep-copied modules (``model_bnn.py:279-294``).

The JAX package runs each chunk of transitions as one ``lax.scan``; here a
chunk is a Python loop that never reads a device value on the host: the
accept/reject is a ``torch.where``, the dual-averaging and Welford state and
the step size are device tensors. The host waits for the card only in a
step-size search (once per doubling or halving, at most 60 times), in the
env-gated heartbeat, and once per batch of :func:`hmc_train_batched` where it
reports.

Every random draw can be injected (see :class:`GeneratorDraws` for the
methods a draws object has), so a test can replay the JAX package's threefry
draws; otherwise they come from one ``torch.Generator`` on the chain's device
seeded with ``seed``.

Reference quirk, reproduced by :func:`hmc_train_batched` (``mode='faithful'``):
the reference calls ``mcmc.run`` once per 5000-image batch, each run replacing
the previous samples, so ``mcmc.get_samples(n_samples)`` resamples **with
replacement** from only the last batch's ``n_samples // num_batches + 1``
draws. ``mode='full'`` runs one chain on all the data.

Precision: ``"high"`` and ``"highest"`` both run exact f32 with TF32 off (at
least as exact as the JAX package's bf16_3x ``"high"``). ``"default"`` is the
opt-in to single-pass bf16: every potential and gradient evaluation runs
inside :func:`.utils.device.bf16_scope`, so each dense and conv product of
the architectures (``models/bnn.py`` ``bnn_potential``) takes bf16 operands
with f32 sums, as ``jax.default_matmul_precision("default")`` makes them on
the TPU. Unlike JAX's global context, the scope reaches only those products:
a custom potential's own ``torch.matmul`` stays exact f32. No sampler
defaults to it (``ROBUSTBNNS_MCMC_PRECISION`` may ask for it): it froze
adaptation in the JAX record (PERFORMANCE.md round 3).
"""
from __future__ import annotations

import math
import os
import sys
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from robustbnns_tpu_torch.parallel.mesh import reduce_sum
from robustbnns_tpu_torch.utils.device import bf16_scope, exact_f32

_LOG_HALF = math.log(0.5)
_F32 = np.float32


def _default_mcmc_precision() -> str:
    """The sampler's precision, overridable per process with
    ``ROBUSTBNNS_MCMC_PRECISION`` (read at import time), validated as in the
    JAX package."""
    val = os.environ.get("ROBUSTBNNS_MCMC_PRECISION", "high")
    if val not in ("default", "high", "highest"):
        raise ValueError(
            f"ROBUSTBNNS_MCMC_PRECISION={val!r}: expected one of "
            "'default' (1-pass bf16), 'high' (bf16_3x), 'highest' (f32)"
        )
    return val


MCMC_PRECISION_DEFAULT = _default_mcmc_precision()


class HMCConfig(NamedTuple):
    """Sampler knobs (reference defaults: ``model_bnn.py:73``, Pyro HMC)."""

    num_samples: int
    warmup: int
    step_size: float = 0.005
    num_steps: int = 10
    adapt_step_size: bool = True
    adapt_mass_matrix: bool = True
    target_accept: float = 0.8
    num_chains: int = 1
    precision: str = MCMC_PRECISION_DEFAULT


class HMCInfo(NamedTuple):
    accept_prob: torch.Tensor  # (S,) or (C, S): MH accept probability per draw
    step_size: torch.Tensor  # () or (C,): final (possibly adapted) step size
    inv_mass: torch.Tensor  # (D,) or (C, D): final diagonal inverse mass
    evaluations: int = 0  # value-and-gradient evaluations of the run (C chains count once)


def check_sampler(sampler: str) -> None:
    """Refuse a sampler other than ``hmc`` and ``nuts``."""
    if sampler not in ("hmc", "nuts"):
        raise ValueError(f"unknown sampler {sampler!r}")


def check_precision(precision: str) -> None:
    """Refuse a precision other than ``default`` (bf16 products), ``high``
    and ``highest`` (both exact f32)."""
    if precision not in ("default", "high", "highest"):
        raise ValueError(f"unknown precision {precision!r}")


class GeneratorDraws:
    """A chain's random draws from one ``torch.Generator`` on its device.

    An injected draws object has the methods its sampler calls, each in the
    order the sampler needs the draw: ``search_normal(q)`` (a standard normal
    shaped like ``q`` for each step-size search), ``momentum(q)`` (each
    transition's standard normal, before the ``1/sqrt(inv_mass)`` scaling),
    ``uniform(q)`` (each HMC transition's uniform, shaped like
    ``q.shape[:-1]``) and ``resample(n, high)`` (the faithful resample's ``n``
    indices in ``[0, high)``); NUTS (:mod:`.nuts`) asks, per doubling, for
    ``direction(q)`` (right iff below 0.5) and ``merge(q)``, and per leaf for
    ``multinomial(q)``, each a uniform like ``uniform``'s.
    """

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _normal(self, like: torch.Tensor) -> torch.Tensor:
        g = self.generator
        return torch.randn(like.shape, generator=g, device=g.device, dtype=like.dtype)

    def search_normal(self, like: torch.Tensor) -> torch.Tensor:
        return self._normal(like)

    def momentum(self, like: torch.Tensor) -> torch.Tensor:
        return self._normal(like)

    def uniform(self, like: torch.Tensor) -> torch.Tensor:
        g = self.generator
        return torch.rand(like.shape[:-1], generator=g, device=g.device, dtype=like.dtype)

    direction = merge = multinomial = uniform

    def resample(self, n: int, high: int) -> torch.Tensor:
        g = self.generator
        return torch.randint(0, high, (n,), generator=g, device=g.device)


def _seeded_draws(seed, device) -> GeneratorDraws:
    return GeneratorDraws(torch.Generator(device=device).manual_seed(int(seed)))


class ChainDraws:
    """The draws of a batched chain whose chain c draws from its own draws
    object ``per_chain[c]``: each draw is the chains' draws stacked on the
    chain axis, so a chain's numbers do not depend on the chains beside it
    (the JAX package's per-chain keys). Serves :func:`hmc_sample`."""

    def __init__(self, per_chain):
        self.per_chain = list(per_chain)

    def _stack(self, name: str, like: torch.Tensor) -> torch.Tensor:
        return torch.stack([getattr(d, name)(like[c]) for c, d in enumerate(self.per_chain)])

    def search_normal(self, like):
        return self._stack("search_normal", like)

    def momentum(self, like):
        return self._stack("momentum", like)

    def uniform(self, like):
        return self._stack("uniform", like)


class _Potential:
    """``U(q)`` and ``∇U(q)`` from one forward and one backward, counted.

    The graph of an evaluation is freed when it returns (no ``retain_graph``).
    With ``mesh``, ``data`` is this rank's rows and both are summed over the
    mesh's ``data`` axis in one all-reduce, so every rank holds the same
    values (:mod:`.parallel.mesh`). With ``bf16``, the forward and the
    backward run inside :func:`.utils.device.bf16_scope`.
    """

    def __init__(self, potential_fn: Callable, data: tuple = (), mesh=None, bf16: bool = False):
        self.fn, self.data, self.mesh, self.evaluations = potential_fn, tuple(data), mesh, 0
        self.bf16 = bf16

    def __call__(self, q: torch.Tensor):
        self.evaluations += 1
        q = q.detach().requires_grad_(True)
        with torch.enable_grad(), bf16_scope(self.bf16):
            u = self.fn(q, *self.data)
            if u.shape != q.shape[:-1]:
                raise ValueError(
                    f"the potential returned shape {tuple(u.shape)} for q of shape "
                    f"{tuple(q.shape)}: it must reduce over the last axis only"
                )
            (g,) = torch.autograd.grad(u.sum(), q)
        if self.mesh is None:
            return u.detach(), g
        u, g = reduce_sum([u.detach(), g], self.mesh)
        return u, g


def _kinetic(p, inv_mass):
    return 0.5 * (p * p * inv_mass).sum(-1)


def _per_chain(step_size, q: torch.Tensor) -> torch.Tensor:
    """A step size as a tensor of one value per chain."""
    if torch.is_tensor(step_size):
        return step_size
    return q.new_full(q.shape[:-1], float(step_size))


def _integrate(value_and_grad, q, p, g, step_size, inv_mass, num_steps):
    """``num_steps`` velocity-Verlet steps from ``(q, p)``, where ``g`` is
    ∇U(q). Returns the end's ``q``, ``p``, ``U`` and ∇U."""
    eps = step_size[..., None]
    half, drift = 0.5 * eps, eps * inv_mass
    p = p - half * g
    for _ in range(num_steps - 1):
        q = q + drift * p
        _, g = value_and_grad(q)
        p = p - eps * g
    q = q + drift * p
    u, g = value_and_grad(q)
    p = p - half * g
    return q, p, u, g


def _leapfrog(potential_fn, q, p, step_size, inv_mass, num_steps):
    """Velocity-Verlet integration of Hamilton's equations (JAX ``hmc.py:121``)."""
    vg = _Potential(potential_fn)
    _, g = vg(q)
    q, p, _, _ = _integrate(vg, q, p, g, _per_chain(step_size, q), inv_mass, num_steps)
    return q, p


def _hmc_transition(vg, q, step_size, inv_mass, num_steps, z, uniform, trace=None):
    """One HMC transition (JAX ``hmc.py:144``, which draws ``z`` and
    ``uniform`` from a key): momentum ``z / sqrt(inv_mass)``, a trajectory,
    and the Metropolis test against ``uniform``. A non-finite Hamiltonian at
    the end counts as a rejection. ``vg`` is a :class:`_Potential`; the
    transition costs ``num_steps + 1`` of its evaluations. Returns ``(q,
    accept_prob)``."""
    p = z / torch.sqrt(inv_mass)
    u0, g0 = vg(q)
    h0 = u0 + _kinetic(p, inv_mass)
    q_new, p_new, u1, _ = _integrate(vg, q, p, g0, step_size, inv_mass, num_steps)
    h1 = u1 + _kinetic(p_new, inv_mass)
    log_accept = torch.where(torch.isfinite(h1), h0 - h1, -math.inf)
    accept_prob = torch.clamp(torch.exp(log_accept), max=1.0)
    if trace is not None:
        trace.append(("transition", uniform, accept_prob))
    accept = uniform < accept_prob
    return torch.where(accept[..., None], q_new, q), accept_prob


def _find_reasonable_step_size(vg, q, z, eps0, inv_mass, trace=None):
    """Stan/Pyro's heuristic: scale ``eps`` by 2 until the one-step leapfrog
    acceptance crosses 1/2 (at most 60 times), then clip to [1e-10, 1e3].

    ``vg`` is a :class:`_Potential`, ``z`` the standard normal of the
    momentum. The value and gradient at ``q`` are computed once; each trial
    step costs one evaluation, at its end, and the host reads one flag per
    trial. With several chains each chain stops on its own, as under ``vmap``.
    """
    p = z / torch.sqrt(inv_mass)
    u0, g0 = vg(q)
    h0 = u0 + _kinetic(p, inv_mass)

    def log_accept(eps):
        e = eps[..., None]
        p1 = p - 0.5 * e * g0
        q1 = q + e * inv_mass * p1
        u1, g1 = vg(q1)
        p1 = p1 - 0.5 * e * g1
        la = h0 - (u1 + _kinetic(p1, inv_mass))
        if trace is not None:
            trace.append(("search", la))
        return torch.where(torch.isfinite(la), la, -math.inf)

    eps = _per_chain(eps0, q)
    la = log_accept(eps)
    direction = torch.where(la > _LOG_HALF, 1.0, -1.0).to(la.dtype)
    it = torch.zeros_like(la)
    while True:
        active = (direction * la > direction * _LOG_HALF) & (it < 60)
        if not bool(active.any()):  # the search's one host read per trial
            break
        eps = torch.where(active, eps * torch.exp2(direction), eps)
        it = it + active
        la = log_accept(eps)
    return torch.clamp(eps, 1e-10, 1e3)


def map_warm_start(potential_fn, init_q, data: tuple = (), *, steps: int = 200, lr: float = 1e-2):
    """Adam descent on the potential to a high-density start point (JAX
    ``hmc.py:201``): optax's Adam defaults (b1 0.9, b2 0.999, eps 1e-8), exact
    f32. Returns the end point and the potential before each step."""
    exact_f32()
    vg = _Potential(potential_fn, data)
    q = init_q.detach().clone().requires_grad_(True)
    optimizer = torch.optim.Adam([q], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    us = []
    for _ in range(steps):
        u, q.grad = vg(q)
        optimizer.step()
        us.append(u)
    return q.detach(), torch.stack(us)


def _dual_averaging_update(state, accept_prob, target, t):
    """Nesterov dual averaging on log step size (Stan/Pyro scheme). ``t`` is
    the host's iteration index; its scalars are computed in float32 as the
    JAX package's traced counter does."""
    log_eps, log_eps_bar, h_bar, mu = state
    t = _F32(t) + _F32(1.0)
    kappa, gamma, t0 = _F32(0.75), _F32(0.05), _F32(10.0)
    eta = _F32(1.0) / (t + t0)
    h_bar = float(_F32(1.0) - eta) * h_bar + float(eta) * (target - accept_prob)
    log_eps = mu - float(np.sqrt(t) / gamma) * h_bar
    w = t ** (-kappa)
    log_eps_bar = float(w) * log_eps + float(_F32(1.0) - w) * log_eps_bar
    return (log_eps, log_eps_bar, h_bar, mu)


def _fresh_dual_averaging(eps):
    """(log eps, log eps-bar, h-bar, mu) at the start of an adaptation window."""
    log_eps = torch.log(eps)
    return (log_eps, log_eps.clone(), torch.zeros_like(eps), torch.log(10.0 * eps))


def _welford_start(q):
    return (torch.zeros_like(q), torch.zeros_like(q), 0.0)


def _welford_update(wf, q):
    mean, m2, count = wf
    count = count + 1.0
    delta = q - mean
    mean = mean + delta / count
    return (mean, m2 + delta * (q - mean), count)


def _hmc_init(vg, init_q, draws, step_size, adapt_step_size, trace=None):
    """The warmup's starting carry ``(q, dual averaging, Welford, inv_mass)``.
    A step-size search guards against a catastrophically large initial step,
    but never raises the user's: ``eps_init = min(found, step_size)``."""
    inv_mass0 = torch.ones_like(init_q)
    eps_user = _per_chain(step_size, init_q)
    if adapt_step_size:
        found = _find_reasonable_step_size(vg, init_q, draws.search_normal(init_q), eps_user, inv_mass0, trace)
        eps_init = torch.minimum(found, eps_user)
    else:
        eps_init = eps_user
    return (init_q, _fresh_dual_averaging(eps_init), _welford_start(init_q), inv_mass0)


def _hmc_warmup_chunk(vg, draws, carry, it0, chunk_len, step_size, num_steps,
                      adapt_step_size, welford_on, target_accept, trace=None):
    """``chunk_len`` warmup transitions. ``welford_on`` marks the mass window;
    ``it0`` is the dual-averaging iteration index of the first."""
    q, da, wf, inv_mass = carry
    for it in range(it0, it0 + chunk_len):
        eps = torch.exp(da[0]) if adapt_step_size else _per_chain(step_size, q)
        q, accept_prob = _hmc_transition(vg, q, eps, inv_mass, num_steps, draws.momentum(q), draws.uniform(q), trace)
        if adapt_step_size:
            da = _dual_averaging_update(da, accept_prob, target_accept, it)
        if welford_on:
            wf = _welford_update(wf, q)
    return (q, da, wf, inv_mass)


def _mass_switch(vg, q, draws, da, wf, adapt_step_size, trace=None):
    """End of the Welford window: install the estimated diagonal mass, with
    Stan's shrinkage, and re-anchor the step size under it (a search and a
    fresh dual-averaging state). A chain whose window never moved falls back
    to unit mass instead of freezing at the regularization floor."""
    mean, m2, count = wf
    var = m2 / max(count - 1.0, 1.0)
    n = _F32(max(count, 1.0))
    shrink = _F32(5.0) / (n + _F32(5.0)) * _F32(1e-3)
    var = float(n / (n + _F32(5.0))) * var + float(shrink)
    degenerate = (m2.amax(-1) <= 0.0) | (count <= 1.0)
    inv_mass = torch.where(degenerate[..., None], 1.0, var)
    if adapt_step_size:
        eps = _find_reasonable_step_size(vg, q, draws.search_normal(q), torch.exp(da[1]), inv_mass, trace)
        da = _fresh_dual_averaging(eps)
    return da, inv_mass


def _hmc_sample_chunk(vg, draws, q, final_eps, inv_mass, num_steps, samples, accept, start, chunk_len, trace=None):
    """Draws ``start .. start + chunk_len - 1``, written into ``samples``
    ``(..., S, D)`` and ``accept`` ``(..., S)`` on the device."""
    for i in range(start, start + chunk_len):
        q, accept[..., i] = _hmc_transition(vg, q, final_eps, inv_mass, num_steps, draws.momentum(q),
                                        draws.uniform(q), trace)
        samples[..., i, :] = q
    return q


def warmup_phase_lengths(warmup, adapt_step_size, adapt_mass_matrix):
    """(init-buffer, mass-window, term-buffer) split of the warmup budget:
    Stan's (¼, ½, ¼) with both adaptations, one step-size phase without mass
    adaptation, half/half when only the mass adapts."""
    if warmup <= 0 or not adapt_mass_matrix:
        return warmup, 0, 0
    if adapt_step_size:
        w1 = warmup // 4
        w3 = warmup // 4
        return w1, warmup - w1 - w3, w3
    w1 = warmup // 2
    return w1, warmup - w1, 0


def _heartbeat(tag, done, total, sync_leaf):
    """``ROBUSTBNNS_MCMC_HEARTBEAT=1`` prints one stderr line per chunk, synced
    by reading ``sum(sync_leaf)`` on the host; off by default."""
    if os.environ.get("ROBUSTBNNS_MCMC_HEARTBEAT") != "1":
        return
    val = float(sync_leaf.sum())
    print(
        f"[mcmc {time.strftime('%H:%M:%S')}] {tag} {done}/{total} sync={val:.3e}",
        file=sys.stderr, flush=True,
    )


def run_windowed_warmup(warmup_chunk, mass_switch, warm_carry, config, chunk_size):
    """Drive the windowed warmup host-side in bounded chunks.

    ``warmup_chunk(carry, it0, n, welford_on)`` runs ``n`` transitions;
    ``mass_switch(q, da, wf)`` installs the mass and re-anchors eps. Chunks
    never span phase boundaries. The dual-averaging counter runs on across
    the init buffer and the mass window and restarts at 0 only after the mass
    switch, where its state is re-initialised. Returns the final ``(q, da,
    wf, inv_mass)`` carry.
    """
    warmup = config.warmup
    adapt_eps = config.adapt_step_size and warmup > 0
    adapt_mass = config.adapt_mass_matrix and warmup > 0
    chunk = chunk_size or max(warmup, config.num_samples, 1)

    def phase(carry, length, welford_on, it_start=0):
        it = 0
        while it < length:
            n = min(chunk, length - it)
            carry = warmup_chunk(carry, it_start + it, n, welford_on)
            it += n
            _heartbeat("warmup", it_start + it, warmup, carry[0])
        return carry

    w1, w2, w3 = warmup_phase_lengths(warmup, adapt_eps, adapt_mass)
    carry = phase(warm_carry, w1, False)
    if adapt_mass:
        carry = phase(carry, w2, True, it_start=w1)
        q, da, wf, _ = carry
        da, inv_mass = mass_switch(q, da, wf)
        carry = phase((q, da, _welford_start(q), inv_mass), w3, False)
    return carry


def _run_hmc_chain_chunked(vg, init_q, draws, config, chunk_size, trace=None):
    num_samples, warmup = config.num_samples, config.warmup
    adapt_eps = config.adapt_step_size and warmup > 0
    chunk = chunk_size or max(warmup, num_samples, 1)

    warm_carry = _hmc_init(vg, init_q, draws, config.step_size, adapt_eps, trace)

    def warmup_chunk(carry, it0, n, welford_on):
        return _hmc_warmup_chunk(vg, draws, carry, it0, n, config.step_size, config.num_steps,
                                 adapt_eps, welford_on, config.target_accept, trace)

    def mass_switch(q, da, wf):
        return _mass_switch(vg, q, draws, da, wf, adapt_eps, trace)

    q, da, _, inv_mass = run_windowed_warmup(warmup_chunk, mass_switch, warm_carry, config, chunk_size)
    final_eps = torch.exp(da[1]) if adapt_eps else _per_chain(config.step_size, init_q)

    lead = tuple(init_q.shape[:-1])
    samples = init_q.new_empty(lead + (num_samples, init_q.shape[-1]))
    accept = init_q.new_empty(lead + (num_samples,))
    done = 0
    while done < num_samples:
        n = min(chunk, num_samples - done)
        q = _hmc_sample_chunk(vg, draws, q, final_eps, inv_mass, config.num_steps, samples, accept, done, n, trace)
        done += n
        _heartbeat("hmc-sample", done, num_samples, q)
    return samples, HMCInfo(accept, final_eps, inv_mass, vg.evaluations)


def hmc_sample(
    potential_fn: Callable,
    init_position: torch.Tensor,
    seed: Optional[int],
    config: HMCConfig,
    data: Optional[tuple] = None,
    chunk_size: Optional[int] = None,
    *,
    draws=None,
    trace: Optional[list] = None,
    mesh=None,
):
    """Run HMC from a flat position on its device.

    ``potential_fn`` is ``U(q)`` (``data=None``) or ``U(q, *data)``; it takes
    ``q`` of shape ``(..., D)`` and returns ``(...)``. Returns ``(samples,
    info)``: ``samples`` is ``(num_samples, D)`` for one chain given as a
    1-D position, else ``(num_chains, num_samples, D)``, the chains run as
    one batched chain (a 1-D ``init_position`` starts every chain there).
    With ``mesh``, ``data`` is this rank's share of rows whose potential
    terms sum over the mesh's ``data`` axis (:class:`_Potential`).

    The draws come from ``draws`` (see :class:`GeneratorDraws`) or a
    generator on the position's device seeded with ``seed``. ``chunk_size``
    (env default ``ROBUSTBNNS_HMC_CHUNK``) bounds the transitions between two
    heartbeats and changes no result. ``trace``, a list, receives each
    search's log acceptance and each transition's uniform and accept
    probability as device tensors, for tests that check how far a decision
    was from its threshold.
    """
    check_precision(config.precision)
    if chunk_size is None and os.environ.get("ROBUSTBNNS_HMC_CHUNK"):
        chunk_size = int(os.environ["ROBUSTBNNS_HMC_CHUNK"])
    if chunk_size is not None and chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    exact_f32()
    q0 = init_position.detach()
    chains = config.num_chains
    if chains > 1 and q0.dim() == 1:
        q0 = q0.expand(chains, -1).clone()
    if q0.dim() not in (1, 2) or (q0.dim() == 2 and q0.shape[0] != chains):
        raise ValueError(f"init_position of shape {tuple(init_position.shape)} for {chains} chain(s)")
    if draws is None:
        draws = _seeded_draws(seed, q0.device)
    vg = _Potential(potential_fn, () if data is None else data, mesh, bf16=config.precision == "default")
    return _run_hmc_chain_chunked(vg, q0, draws, config, chunk_size, trace)


def hmc_train_batched(
    potential_fn: Callable,  # U(q, x, labels)
    batches,  # iterable of (x, labels)
    init_position: torch.Tensor,
    seed: Optional[int],
    *,
    n_samples: int,
    warmup: int,
    step_size: float = 0.005,
    num_steps: int = 10,
    mode: str = "faithful",
    num_chains: int = 1,
    sampler: str = "hmc",
    verbose: bool = True,
    draws=None,
    history: Optional[dict] = None,
    trace: Optional[list] = None,
    mesh=None,
):
    """The reference's training loop semantics (``model_bnn.py:260-301``).

    ``mode='faithful'``: warmup and sampling once per batch, each run starting
    from the previous run's last position; keep the last batch's
    ``n_samples // num_batches + 1`` draws and resample ``n_samples`` of them
    **with replacement**. ``mode='full'``: one chain on the concatenated
    batches. ``sampler='nuts'`` runs :func:`.nuts.nuts_sample` instead, in
    either mode (JAX ``hmc.py:632-655``); ``num_steps`` is then ignored.

    One draws object (or one generator seeded with ``seed``) serves every
    batch's run and then the resample. ``history``, a dict, gains per run the
    mean accept probability (NUTS: the accept statistic), the mean step size,
    the seconds and the evaluations, and for NUTS the mean leaves per draw and
    the divergences; reading them (and ``verbose``'s line) is the batch's one
    synchronisation with the card. With ``mesh``, ``batches`` hold this
    rank's rows and ``potential_fn`` its share of the potential, summed over
    ``data`` at every evaluation.
    """
    from robustbnns_tpu_torch.inference.nuts import NUTSConfig, nuts_sample

    check_sampler(sampler)
    if mode not in ("faithful", "full"):
        raise ValueError(f"unknown HMC training mode {mode!r}")
    batches = list(batches)
    nuts = sampler == "nuts"
    if draws is None:
        draws = _seeded_draws(seed, init_position.device)

    def config(num_samples):
        if nuts:
            return NUTSConfig(num_samples=num_samples, warmup=warmup, step_size=step_size, num_chains=num_chains)
        return HMCConfig(num_samples=num_samples, warmup=warmup, step_size=step_size,
                         num_steps=num_steps, num_chains=num_chains)

    def run(q, cfg, data):
        t0 = time.perf_counter()
        sample = nuts_sample if nuts else hmc_sample
        samples, info = sample(potential_fn, q, None, cfg, data=data, draws=draws, trace=trace, mesh=mesh)
        if history is None and not verbose:
            return samples, info, {}
        stats = [info.accept_stat if nuts else info.accept_prob, info.step_size]
        if nuts:
            stats += [info.num_leapfrog, info.diverging.sum()]
        stats = dict(zip(("accept", "step_size", "leaves", "divergences"),
                         torch.stack([v.float().mean() for v in stats]).tolist()))
        stats.update(seconds=time.perf_counter() - t0, evaluations=info.evaluations)
        if history is not None:
            for key, v in stats.items():
                history.setdefault(key, []).append(v)
        return samples, info, stats

    if mode == "full":
        xs = torch.cat([b[0] for b in batches])
        ys = torch.cat([b[1] for b in batches])
        samples, info, _ = run(init_position, config(n_samples), (xs, ys))
        return samples, info

    num_batches = len(batches)
    batch_samples = n_samples // num_batches + 1
    cfg = config(batch_samples)
    q = init_position
    samples = info = None
    for i, (x, labels) in enumerate(batches):
        samples, info, stats = run(q, cfg, (x, labels))
        q = samples[-1] if num_chains == 1 else samples[:, -1]
        if verbose:
            line = (f"[{sampler.upper()} batch {i + 1}/{num_batches}] {batch_samples} draws, "
                    f"mean accept {stats['accept']:.2f}, step {stats['step_size']:.2e}")
            if nuts:
                line += f", mean leaves {stats['leaves']:.1f}, divergences {int(stats['divergences'])}"
            print(line)

    # get_samples(n_samples) with fewer stored draws resamples with replacement.
    idx = draws.resample(n_samples, batch_samples)
    out = samples[idx] if num_chains == 1 else samples[:, idx]
    return out, info
