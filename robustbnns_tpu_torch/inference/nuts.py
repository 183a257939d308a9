"""No-U-Turn sampler on a flat position vector (port of
``robustbnns_tpu/inference/nuts.py``).

NUTS adapts the trajectory length per draw: the JAX package's fix for sharp
BNN posteriors that fixed-trajectory HMC (the reference's Pyro kernel,
``model_bnn.py:269-270``) cannot mix. The semantics are those of JAX's
``_nuts_transition``:

* the trajectory doubles up to ``max_depth`` times, each doubling a subtree of
  ``2^depth`` leapfrog leaves in a random direction;
* proposals are multinomial with biased progressive sampling (Stan's scheme):
  within a subtree each leaf replaces the subtree's proposal with probability
  ``exp(logw_leaf − logsumexp so far)``; across subtrees the new subtree's
  proposal replaces the trajectory's with probability
  ``min(1, exp(logw_subtree − logw_trajectory))``;
* the generalized U-turn test runs on every dyadic node of a subtree, from
  level-indexed checkpoints: row ``j`` of two ``(max_depth, D)`` buffers holds
  the first-leaf velocity and momentum prefix-sum of the live node of
  ``2^(j+1)`` leaves, and on the whole trajectory after each successful
  doubling;
* a leaf whose energy error exceeds Stan's 1000 diverges;
* ``accept_stat = Σ min(1, e^{−ΔH}) / n_leaves``, a subtree's acceptance mass
  added at its end;
* each leaf costs exactly one value-and-gradient evaluation
  (:class:`.hmc._Potential`): the gradient is carried along the trajectory and
  at its two edges, plus one evaluation at the root. A draw costs
  ``n_leapfrog + 1`` evaluations.

XLA needed one flat ``while_loop`` with masked full-buffer selects; here the
host drives the loop. The doubling depth and the leaf counter ``i`` are host
integers, so the nodes that open at leaf ``i`` are the rows ``0..tz(i)−1``
(``0..depth−1`` at ``i = 0``) and the nodes that close are the rows
``0..to(i)−1``, where tz and to count trailing zeros and ones: only those
rows are written and reduced. The host reads one device bool per leaf
(:func:`_host_flag`): whether the trajectory stopped. The direction of each
doubling stays on the card: the trajectory's edges are rows of ``(3, D)``
buffers (left, right, scratch) indexed by a device tensor.

Warmup reuses the HMC machinery (:mod:`.hmc`): the step-size search, dual
averaging on the acceptance statistic, and the windowed diagonal mass with
the mass switch. Chains run one after another, each from its own draws, and
stack as ``(C, S, D)``. Every draw can be injected (:class:`.hmc.GeneratorDraws`
lists the methods), so a test can replay the JAX package's threefry draws.
"""
from __future__ import annotations

import math
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from robustbnns_tpu_torch.inference.hmc import (
    MCMC_PRECISION_DEFAULT,
    _heartbeat,
    _hmc_init,
    _kinetic,
    _mass_switch,
    _per_chain,
    _Potential,
    _seeded_draws,
    _dual_averaging_update,
    _welford_update,
    check_precision,
    run_windowed_warmup,
)
from robustbnns_tpu_torch.utils.device import exact_f32

_MAX_DELTA_ENERGY = 1000.0  # Stan's divergence cutoff


class NUTSConfig(NamedTuple):
    """Sampler knobs (Stan/NumPyro defaults, as in the JAX package).
    ``precision`` as :class:`.hmc.HMCConfig`'s: ``"default"`` runs every
    evaluation's dense and conv products on bf16 operands."""

    num_samples: int
    warmup: int
    step_size: float = 0.1
    max_depth: int = 10
    adapt_step_size: bool = True
    adapt_mass_matrix: bool = True
    target_accept: float = 0.8
    num_chains: int = 1
    precision: str = MCMC_PRECISION_DEFAULT


class NUTSInfo(NamedTuple):
    accept_stat: torch.Tensor  # (S,) or (C, S): trajectory-averaged acceptance statistic
    num_leapfrog: torch.Tensor  # (S,) or (C, S) int64: leapfrog leaves per draw
    diverging: torch.Tensor  # (S,) or (C, S) bool
    step_size: torch.Tensor  # () or (C,): final (possibly adapted) step size
    inv_mass: torch.Tensor  # (D,) or (C, D): final diagonal inverse mass
    evaluations: int = 0  # value-and-gradient evaluations of the run, all chains


def _trailing_ones(i: int) -> int:
    """How many tree nodes close at leaf ``i``."""
    return (~i & (i + 1)).bit_length() - 1


def _trailing_zeros(i: int) -> int:
    """How many tree nodes open at leaf ``i > 0``."""
    return (i & -i).bit_length() - 1


def _host_flag(flag: torch.Tensor) -> bool:
    """The transition's one host read of the card per leaf."""
    return bool(flag)


def _nuts_transition(vg, q, eps, inv_mass, max_depth, draws, trace=None):
    """One NUTS draw from ``q`` (JAX ``nuts.py:340-558``): returns ``(q',
    accept_stat, n_leaves, diverging)``, ``n_leaves`` a host integer.

    ``vg`` is a :class:`.hmc._Potential`; ``draws`` gives the momentum's
    standard normal, then per doubling the direction and merge uniforms, then
    per leaf the multinomial uniform. ``trace``, a list, receives every
    U-turn dot product, multinomial, merge and divergence comparison.
    """
    d = q.shape[-1]
    p0 = draws.momentum(q) / torch.sqrt(inv_mass)
    u0, g0 = vg(q)
    h0 = u0 + _kinetic(p0, inv_mass)

    # The trajectory's edges (row 0 left, 1 right, 2 scratch for a failed subtree).
    edge_q, edge_p, edge_g = (torch.stack([v, v, v]) for v in (q, p0, g0))
    psum, q_prop = p0, q  # psum starts with the root leaf's momentum
    logw = u0.new_zeros(())  # the root's weight: H0 − H0 = 0
    sum_acc = u0.new_zeros(())
    turning = diverging = torch.zeros((), dtype=torch.bool, device=q.device)
    ckpt_v = q.new_zeros((max_depth, d))  # row j: the live node of 2^(j+1) leaves
    ckpt_psum = q.new_zeros((max_depth, d))
    n_leaves = 0
    for depth in range(max_depth):
        go_right = draws.direction(q) < 0.5  # JAX's bernoulli(k) is uniform(k) < 0.5
        u_merge = draws.merge(q)
        side = go_right.long().reshape(1)
        signed_eps = torch.where(go_right, 1.0, -1.0).to(q.dtype) * eps
        qc, pc, gc = (e.index_select(0, side)[0] for e in (edge_q, edge_p, edge_g))
        psum_sub, q_prop_sub = torch.zeros_like(q), qc
        logw_sub = u0.new_full((), -math.inf)
        acc_sub = u0.new_zeros(())
        turning_sub = torch.zeros_like(turning)
        n_sub = 1 << depth
        for i in range(n_sub):
            # One velocity-Verlet step, one evaluation: the entering half
            # step uses the carried gradient gc = ∇U(qc).
            u_mult = draws.multinomial(q)
            p_half = pc - 0.5 * signed_eps * gc
            qc = qc + signed_eps * inv_mass * p_half
            u, gc = vg(qc)
            pc = p_half - 0.5 * signed_eps * gc
            vc = inv_mass * pc
            delta = u + _kinetic(pc, inv_mass) - h0
            delta = torch.where(torch.isfinite(delta), delta, math.inf)
            div_leaf = delta > _MAX_DELTA_ENERGY
            logw_leaf = -delta
            acc_sub = acc_sub + torch.clamp(torch.exp(-delta), max=1.0)

            logw_new = torch.logaddexp(logw_sub, logw_leaf)
            log_u, take_at = torch.log(u_mult), logw_leaf - logw_new
            q_prop_sub = torch.where(log_u < take_at, qc, q_prop_sub)
            logw_sub = logw_new
            if trace is not None:
                trace += [("divergence", delta, _MAX_DELTA_ENERGY, _MAX_DELTA_ENERGY, True),
                          # a subtree's first leaf is taken for sure: its threshold is 0 exactly
                          ("multinomial", log_u, take_at, 1.0, i > 0)]

            # Open the nodes whose first leaf is i; their rows take this
            # leaf's velocity and the momentum sum before it.
            n_open = depth if i == 0 else _trailing_zeros(i)
            ckpt_v[:n_open] = vc
            ckpt_psum[:n_open] = psum_sub
            psum_sub = psum_sub + pc
            # Close the nodes whose last leaf is i: rho is Σ p over the node.
            n_close = _trailing_ones(i)
            if n_close:
                rho = psum_sub - ckpt_psum[:n_close]
                dots = torch.cat([(rho * ckpt_v[:n_close]).sum(1), rho @ vc])
                turning_sub = turning_sub | (dots < 0.0).any()
                if trace is not None:
                    norm = torch.linalg.vector_norm
                    scale = norm(rho, dim=1).repeat(2) * torch.cat([norm(ckpt_v[:n_close], dim=1),
                                                                    norm(vc).expand(n_close)])
                    trace.append(("uturn", dots, 0.0, scale, True))
            n_leaves += 1

            stop_sub = turning_sub | div_leaf
            last = i + 1 == n_sub
            if not last and not _host_flag(stop_sub):
                continue
            # The subtree ends: add its acceptance mass, merge it if it
            # neither turned nor diverged, and test the whole trajectory.
            sum_acc = sum_acc + acc_sub
            sub_ok = ~stop_sub
            log_merge, merge_at = torch.log(u_merge), logw_sub - logw
            q_prop = torch.where(sub_ok & (log_merge < merge_at), q_prop_sub, q_prop)
            logw = torch.where(sub_ok, torch.logaddexp(logw, logw_sub), logw)
            row = torch.where(sub_ok, side, 2)
            for edge, v in ((edge_q, qc), (edge_p, pc), (edge_g, gc)):
                edge.index_copy_(0, row, v[None])
            psum = torch.where(sub_ok, psum + psum_sub, psum)
            edge_v = inv_mass * edge_p[:2]
            dots = edge_v @ psum
            turning = turning | turning_sub | (sub_ok & (dots < 0.0).any())
            if trace is not None:
                norm = torch.linalg.vector_norm
                trace += [("merge", log_merge, merge_at, 1.0, sub_ok),
                          ("uturn", dots, 0.0, norm(psum) * norm(edge_v, dim=1), sub_ok)]
            diverging = diverging | div_leaf
            break
        if not last or depth + 1 == max_depth or _host_flag(turning | diverging):
            break
    accept_stat = sum_acc / max(n_leaves, 1)
    return q_prop, accept_stat, n_leaves, diverging


def _nuts_warmup_chunk(vg, draws, carry, it0, chunk_len, step_size, max_depth,
                       adapt_step_size, welford_on, target_accept, trace=None):
    """``chunk_len`` warmup transitions (JAX ``_nuts_warmup_chunk``);
    ``welford_on`` marks the mass window, ``it0`` is the dual-averaging
    iteration index of the first."""
    q, da, wf, inv_mass = carry
    for it in range(it0, it0 + chunk_len):
        eps = torch.exp(da[0]) if adapt_step_size else _per_chain(step_size, q)
        q, accept_stat, _, _ = _nuts_transition(vg, q, eps, inv_mass, max_depth, draws, trace)
        if adapt_step_size:
            da = _dual_averaging_update(da, accept_stat, target_accept, it)
        if welford_on:
            wf = _welford_update(wf, q)
    return (q, da, wf, inv_mass)


def _nuts_sample_chunk(vg, draws, q, final_eps, inv_mass, max_depth, out, start, chunk_len, trace=None):
    """Draws ``start .. start + chunk_len - 1`` into ``out``: the samples
    ``(S, D)`` and accept statistics ``(S,)`` on the device, and lists of the
    leaves and divergence flags."""
    samples, accept, leaves, diverging = out
    for i in range(start, start + chunk_len):
        q, accept[i], n_leaves, div = _nuts_transition(vg, q, final_eps, inv_mass, max_depth, draws, trace)
        samples[i] = q
        leaves.append(n_leaves)
        diverging.append(div)
    return q


def _run_chain_chunked(vg, init_q, draws, config, chunk_size, trace=None):
    """One chain (JAX ``_run_chain_chunked``): the step-size search and fresh
    adaptation state (JAX ``_nuts_init``, the same as HMC's start), the
    windowed warmup, then the draws."""
    num_samples, warmup = config.num_samples, config.warmup
    adapt_eps = config.adapt_step_size and warmup > 0
    chunk = chunk_size or max(warmup, num_samples, 1)

    warm_carry = _hmc_init(vg, init_q, draws, config.step_size, adapt_eps, trace)

    def warmup_chunk(carry, it0, n, welford_on):
        return _nuts_warmup_chunk(vg, draws, carry, it0, n, config.step_size, config.max_depth,
                                  adapt_eps, welford_on, config.target_accept, trace)

    def mass_switch(q, da, wf):
        return _mass_switch(vg, q, draws, da, wf, adapt_eps, trace)

    q, da, _, inv_mass = run_windowed_warmup(warmup_chunk, mass_switch, warm_carry, config, chunk_size)
    final_eps = torch.exp(da[1]) if adapt_eps else _per_chain(config.step_size, init_q)

    out = (init_q.new_empty((num_samples, init_q.shape[-1])), init_q.new_empty((num_samples,)), [], [])
    done = 0
    while done < num_samples:
        n = min(chunk, num_samples - done)
        q = _nuts_sample_chunk(vg, draws, q, final_eps, inv_mass, config.max_depth, out, done, n, trace)
        done += n
        _heartbeat("nuts-sample", done, num_samples, q)
    samples, accept, leaves, diverging = out
    diverging = torch.stack(diverging) if diverging else torch.zeros(0, dtype=torch.bool, device=init_q.device)
    return samples, (accept, torch.tensor(leaves, dtype=torch.long, device=init_q.device), diverging,
                     final_eps, inv_mass)


def _chain_draws(draws, seed, chains: int, device) -> list:
    """The draws of each chain: a sequence of ``chains`` draws objects, one
    object the chains use in turn, or (``None``) a generator per chain on
    ``device`` seeded from ``(seed, chain)``."""
    if draws is None:
        return [_seeded_draws(np.random.SeedSequence([int(seed), c]).generate_state(1)[0], device)
                for c in range(chains)]
    if isinstance(draws, (list, tuple)):
        if len(draws) != chains:
            raise ValueError(f"{len(draws)} draws objects for {chains} chain(s)")
        return list(draws)
    return [draws] * chains


def nuts_sample(
    potential_fn: Callable,
    init_position: torch.Tensor,
    seed: Optional[int],
    config: NUTSConfig,
    data: Optional[tuple] = None,
    chunk_size: Optional[int] = None,
    *,
    draws=None,
    trace: Optional[list] = None,
    mesh=None,
):
    """Run NUTS from a flat position on its device: the drop-in upgrade of
    :func:`.hmc.hmc_sample`, with the same calling convention.

    ``potential_fn`` is ``U(q)`` (``data=None``) or ``U(q, *data)`` on
    ``q`` of shape ``(D,)``. Returns ``(samples, info)``: ``samples`` is
    ``(num_samples, D)`` for one chain or ``(num_chains, num_samples, D)``
    for several, run one after another (a 1-D ``init_position`` starts every
    chain there); ``info`` is a :class:`NUTSInfo`.

    ``draws`` is one draws object (the chains use it in turn), a sequence of
    one per chain, or ``None``: then chain c draws from a generator on the
    position's device seeded from ``(seed, c)``. ``chunk_size`` (env default
    ``ROBUSTBNNS_NUTS_CHUNK``) bounds the transitions between two heartbeats
    and changes no result. ``trace``, a list, receives every decision of the
    run (see :func:`_nuts_transition`) for tests that check margins.

    With ``mesh``, ``data`` is this rank's share of rows, and every
    evaluation's U and ∇U are summed over the mesh's ``data`` axis before the
    tree uses them: each U-turn and divergence is decided from values that
    are bit-identical on every rank, so all ranks build the same tree and
    meet at the same collectives.
    """
    check_precision(config.precision)
    if chunk_size is None and os.environ.get("ROBUSTBNNS_NUTS_CHUNK"):
        chunk_size = int(os.environ["ROBUSTBNNS_NUTS_CHUNK"])
    if chunk_size is not None and chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    exact_f32()
    chains = config.num_chains
    q0 = init_position.detach()
    if chains > 1 and q0.dim() == 1:
        q0 = q0.expand(chains, -1)
    if q0.dim() != (1 if chains == 1 else 2) or (chains > 1 and q0.shape[0] != chains):
        raise ValueError(f"init_position of shape {tuple(init_position.shape)} for {chains} chain(s)")
    vg = _Potential(potential_fn, () if data is None else data, mesh, bf16=config.precision == "default")
    if chains == 1:
        samples, parts = _run_chain_chunked(vg, q0, _chain_draws(draws, seed, 1, q0.device)[0], config,
                                            chunk_size, trace)
        return samples, NUTSInfo(*parts, evaluations=vg.evaluations)
    runs = [_run_chain_chunked(vg, q0[c].clone(), chain_draws, config, chunk_size, trace)
            for c, chain_draws in enumerate(_chain_draws(draws, seed, chains, q0.device))]
    samples = torch.stack([s for s, _ in runs])
    parts = [torch.stack(p) for p in zip(*(parts for _, parts in runs))]
    return samples, NUTSInfo(*parts, evaluations=vg.evaluations)
