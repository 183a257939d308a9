"""The port's HMC engine (``inference/hmc.py``) against the JAX package's.

Inputs come from numpy; JAX's threefry draws are replayed into the port in the
order JAX's key splits make them (``hmc.py:292,310,334,397,484,588,671,686``).
A whole-chain comparison is only meaningful while no Metropolis decision or
step-size search sits at its threshold (one flipped decision diverges the rest
of the chain), so every such test first asserts a margin: ``|u − accept_prob|
> 1e-3`` on every transition and ``|log_accept − log ½| > 1e-3`` in every
search, read from the port's ``trace``.

Tolerances: one transition chains six f32 forward/backward passes of a small
network, held to rtol 1e-5 + 1e-5·max|ref|; whole chains of about 15
transitions to 1e-4·max|ref|; the step-size search returns eps0·2^k, held
exactly; dual averaging is float32 scalar arithmetic, rtol 1e-6.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustbnns_tpu.inference import hmc as jhmc
from robustbnns_tpu.models import build_architecture as jax_build
from robustbnns_tpu.utils import pytree as jax_pytree
from robustbnns_tpu.utils.pytree import flatten_tree_to_vector as jax_flatten
from robustbnns_tpu_torch.inference import hmc
from robustbnns_tpu_torch.models.architectures import build_architecture
from robustbnns_tpu_torch.models.bnn import bnn_potential
from robustbnns_tpu_torch.utils import pytree
from robustbnns_tpu_torch.utils.pytree import flatten_tree_to_vector, tree_leaves, tree_size

SHAPE, CLASSES, HIDDEN = (4, 4, 1), 3, 16  # fc-16: the narrowest width build_architecture takes
LOG_HALF = math.log(0.5)


def jax_potential(jarch, unravel):
    """The JAX package's BNN potential, as written in ``models/bnn.py:129-137``."""

    def potential_fn(q, bx, blabels):
        logp = jax.nn.log_softmax(jarch.apply(unravel(q), bx), axis=-1)
        loglik = jnp.sum(jnp.take_along_axis(logp, blabels[:, None], axis=-1))
        return -(-0.5 * jnp.sum(q * q) + loglik)

    return potential_fn


class Problem:
    """fc-16 on ``n`` points: both packages' potentials and JAX's init as numpy."""

    def __init__(self, n=32, seed=0):
        jarch = jax_build("fc", "leaky", SHAPE, CLASSES, HIDDEN)
        tarch = build_architecture("fc", "leaky", SHAPE, CLASSES, HIDDEN)
        rng = np.random.default_rng(seed)
        self.x = rng.uniform(size=(n,) + SHAPE).astype(np.float32)
        self.labels = rng.integers(0, CLASSES, n).astype(np.int32)
        q0, unravel = jax_flatten(jarch.init(jax.random.key(seed)))
        self.q0, self.d = np.asarray(q0), int(q0.shape[0])
        self.jpot = jax_potential(jarch, unravel)
        _, tunravel = flatten_tree_to_vector(tarch.init(torch.Generator().manual_seed(0)))
        self.tpot = bnn_potential(tarch, tunravel)
        self.tdata = (torch.from_numpy(self.x), torch.from_numpy(self.labels).long())

    def jax_nullary(self):
        return lambda q: self.jpot(q, self.x, self.labels)

    def torch_nullary(self):
        return lambda q: self.tpot(q, *self.tdata)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(got, want, rtol=0.0, of_max=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=of_max * max(np.abs(want).max(), 1e-30))


def assert_margins(trace):
    """The whole-chain precondition: no decision within 1e-3 of its threshold."""
    assert trace, "the run recorded nothing"
    for entry in trace:
        if entry[0] == "search":
            la = entry[1].detach().numpy()
            assert np.all(np.abs(la - LOG_HALF) > 1e-3), f"search at its threshold: {la}"
        else:
            u, ap = entry[1].numpy(), entry[2].numpy()
            assert np.all(np.abs(u - ap) > 1e-3), f"accept decision at its threshold: u {u}, p {ap}"


class Replay:
    """Injected draws: one queue per kind, consumed in order."""

    def __init__(self, search=(), momentum=(), uniform=(), resample=None):
        self.queues = {name: iter([torch.tensor(np.asarray(v, np.float32)) for v in vals])
                       for name, vals in (("search", search), ("momentum", momentum), ("uniform", uniform))}
        self.resample_idx = resample

    def search_normal(self, like):
        return next(self.queues["search"])

    def momentum(self, like):
        return next(self.queues["momentum"])

    def uniform(self, like):
        return next(self.queues["uniform"])

    def resample(self, n, high):
        idx = torch.tensor(np.asarray(self.resample_idx)).long()
        assert idx.shape == (n,) and int(idx.max()) < high
        return idx


def jax_chain_draws(key, d, cfg):
    """JAX's draws of ``hmc_sample(key)`` for one chain, by kind, in the order
    the port asks for them: ``_hmc_init`` splits (key, k_find) then (key,
    k_warm); warmup transitions split k, k_t then k_mom, k_acc from k_warm;
    the mass switch splits k, k_ms; sampling transitions run from the key left."""
    adapt_eps = cfg.adapt_step_size and cfg.warmup > 0
    adapt_mass = cfg.adapt_mass_matrix and cfg.warmup > 0
    search, momentum, uniform = [], [], []

    def transitions(k, n):
        for _ in range(n):
            k, k_t = jax.random.split(k)
            k_mom, k_acc = jax.random.split(k_t)
            momentum.append(jax.random.normal(k_mom, (d,), jnp.float32))
            uniform.append(jax.random.uniform(k_acc))
        return k

    key, k_find = jax.random.split(key)
    if adapt_eps:
        search.append(jax.random.normal(k_find, (d,), jnp.float32))
    key, k = jax.random.split(key)
    w1, w2, w3 = jhmc.warmup_phase_lengths(cfg.warmup, adapt_eps, adapt_mass)
    k = transitions(k, w1 + w2)
    if adapt_mass:
        k, k_ms = jax.random.split(k)
        if adapt_eps:
            search.append(jax.random.normal(k_ms, (d,), jnp.float32))
        transitions(k, w3)
    transitions(key, cfg.num_samples)
    return search, momentum, uniform


def jax_config(cfg):
    return jhmc.HMCConfig(**cfg._asdict())


def test_flat_vector_uses_jax_leaf_order_and_unravels_to_views():
    """The port's flat vector of JAX's init is JAX's ``ravel_pytree`` (``b``
    before ``w``); ``unravel`` gives views of the vector, also with a chain
    axis, and a gradient through them comes back flat."""
    jarch = jax_build("fc", "leaky", SHAPE, CLASSES, HIDDEN)
    jtree = jarch.init(jax.random.key(2))
    want, _ = jax_flatten(jtree)
    tree = tuple({k: t(v) for k, v in layer.items()} for layer in jtree)
    flat, unravel = flatten_tree_to_vector(tree)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    assert tree_size(tree) == flat.numel()
    for got, leaf in zip(tree_leaves(unravel(flat)), tree_leaves(tree)):
        assert torch.equal(got, leaf)
        assert got.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
    chains = torch.stack([flat, 2 * flat]).requires_grad_(True)
    stacked = unravel(chains)
    assert stacked[1]["w"].shape == (2, HIDDEN, CLASSES)
    assert torch.equal(stacked[1]["w"][1], 2 * tree[1]["w"])
    (grad,) = torch.autograd.grad(sum((v * v).sum() for v in tree_leaves(stacked)), chains)
    assert grad.shape == chains.shape and torch.allclose(grad, 2 * chains)


def test_stack_index_and_slice_trees_match_jax():
    jarch = jax_build("fc", "leaky", SHAPE, CLASSES, HIDDEN)
    jtrees = [jarch.init(jax.random.key(k)) for k in range(3)]
    trees = [tuple({k: t(v) for k, v in layer.items()} for layer in jt) for jt in jtrees]
    jstacked, stacked = jax_pytree.stack_trees(jtrees), pytree.stack_trees(trees)
    for got, want in ((stacked, jstacked), (pytree.index_tree(stacked, torch.tensor([2, 0])),
                                            jax_pytree.index_tree(jstacked, jnp.array([2, 0]))),
                      (pytree.slice_tree(stacked, 2), jax_pytree.slice_tree(jstacked, 2))):
        for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want), strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert pytree.tree_size(stacked) == jax_pytree.tree_size(jstacked) == 3 * tree_size(trees[0])


def test_bnn_potential_and_gradient_match_jax():
    prob = Problem(32)
    q = prob.q0
    want_u, want_g = jax.value_and_grad(prob.jax_nullary())(jnp.asarray(q))
    u, g = hmc._Potential(prob.torch_nullary())(t(q))
    np.testing.assert_allclose(float(u), float(want_u), rtol=1e-6)
    close(g, want_g, rtol=1e-5, of_max=1e-6)
    # two chains: one value each, the stacked apply
    u2, g2 = hmc._Potential(prob.torch_nullary())(torch.stack([t(q), 0.5 * t(q)]))
    want_u2 = float(prob.jax_nullary()(0.5 * jnp.asarray(q)))
    np.testing.assert_allclose(u2.numpy(), [float(want_u), want_u2], rtol=1e-6)
    close(g2[0], want_g, rtol=1e-5, of_max=1e-6)


def std_normal(q):
    return 0.5 * (q * q).sum(-1)


def test_leapfrog_conserves_energy():
    """Small-step leapfrog on a Gaussian conserves the Hamiltonian to O(eps^2)."""
    gen = torch.Generator().manual_seed(0)
    q, p = torch.randn(10, generator=gen), torch.randn(10, generator=gen)
    inv_mass = torch.ones(10)
    h0 = std_normal(q) + hmc._kinetic(p, inv_mass)
    q1, p1 = hmc._leapfrog(std_normal, q, p, 0.01, inv_mass, 50)
    h1 = std_normal(q1) + hmc._kinetic(p1, inv_mass)
    assert abs(float(h1 - h0)) < 1e-3
    assert float(torch.linalg.norm(q1 - q)) > 0.1


def test_leapfrog_is_reversible():
    """Integrating forward then backward (negated momentum) returns the start."""
    q, p, inv_mass = torch.tensor([1.0, -2.0, 0.5]), torch.tensor([0.3, 0.1, -0.7]), torch.ones(3)
    q1, p1 = hmc._leapfrog(std_normal, q, p, 0.05, inv_mass, 20)
    q2, p2 = hmc._leapfrog(std_normal, q1, -p1, 0.05, inv_mass, 20)
    np.testing.assert_allclose(q2.numpy(), q.numpy(), atol=1e-5)
    np.testing.assert_allclose(-p2.numpy(), p.numpy(), atol=1e-5)


@pytest.mark.parametrize("eps,seed", [(0.01, 3), (0.05, 4), (0.3, 5)])
def test_leapfrog_and_transition_match_jax(eps, seed):
    """fc-16 on 32 points, the same q, p, eps and inv_mass: ``_leapfrog``'s
    (q, p), and ``_hmc_transition``'s q and accept probability with JAX's
    momentum and uniform injected."""
    prob = Problem(32)
    rng = np.random.default_rng(seed)
    p = rng.normal(size=prob.d).astype(np.float32)
    inv_mass = rng.uniform(0.5, 1.5, prob.d).astype(np.float32)
    jq, jp = jhmc._leapfrog(prob.jax_nullary(), jnp.asarray(prob.q0), jnp.asarray(p), eps, jnp.asarray(inv_mass), 5)
    tq, tp = hmc._leapfrog(prob.torch_nullary(), t(prob.q0), t(p), eps, t(inv_mass), 5)
    close(tq, jq, rtol=1e-5)
    close(tp, jp, rtol=1e-5)

    key = jax.random.key(seed)
    jq2, jap = jhmc._hmc_transition(prob.jax_nullary(), 5)(jnp.asarray(prob.q0), key, eps, jnp.asarray(inv_mass))
    k_mom, k_acc = jax.random.split(key)
    z, u = jax.random.normal(k_mom, (prob.d,), jnp.float32), jax.random.uniform(k_acc)
    trace = []
    vg = hmc._Potential(prob.torch_nullary())
    tq2, tap = hmc._hmc_transition(vg, t(prob.q0), torch.tensor(eps), t(inv_mass), 5, t(z), t(u), trace)
    assert_margins(trace)
    close(tq2, jq2, rtol=1e-5)
    # exp(h0 - h1) inherits the f32 rounding of two Hamiltonians of about
    # |h0| (~40 here): within 1e-6·|h0|, about 8 ulp of h0
    h0 = float(prob.jax_nullary()(jnp.asarray(prob.q0))) + 0.5 * float(jnp.sum(z * z / inv_mass))
    np.testing.assert_allclose(float(tap), float(jap), rtol=0, atol=1e-6 * abs(h0))


def test_transition_costs_num_steps_plus_one_evaluations():
    """A transition is ``num_steps + 1`` value-and-gradient evaluations and
    nothing else; ``HMCInfo.evaluations`` counts a whole run's."""
    prob = Problem(32)
    calls = []

    def counted(q):
        calls.append(1)
        return prob.torch_nullary()(q)

    vg = hmc._Potential(counted)
    hmc._hmc_transition(vg, t(prob.q0), torch.tensor(0.01), torch.ones(prob.d), 7, torch.zeros(prob.d),
                        torch.tensor(0.5))
    assert len(calls) == vg.evaluations == 8
    calls.clear()
    cfg = hmc.HMCConfig(num_samples=3, warmup=4, step_size=0.01, num_steps=6,
                        adapt_step_size=False, adapt_mass_matrix=False)
    _, info = hmc.hmc_sample(lambda q: counted(q), t(prob.q0), 0, cfg)
    assert len(calls) == info.evaluations == (4 + 3) * 7
    calls.clear()
    _, info = hmc.hmc_sample(lambda q: counted(q), t(prob.q0), 0, cfg._replace(adapt_step_size=True))
    assert len(calls) == info.evaluations > (4 + 3) * 7


def test_a_transition_reads_nothing_on_the_host():
    """On ``meta`` tensors, which hold no values, any host read raises: the
    warmup chunk (transitions, dual averaging, Welford) and the sampling
    chunk run through, so nothing in a transition waits for the device."""
    prob = Problem(8)
    meta = torch.device("meta")
    vg = hmc._Potential(prob.tpot, tuple(v.to(meta) for v in prob.tdata))

    class MetaDraws:
        def momentum(self, like):
            return torch.empty_like(like)

        def uniform(self, like):
            return torch.empty(like.shape[:-1], device=meta)

    q = torch.empty(prob.d, device=meta)
    carry = (q, hmc._fresh_dual_averaging(torch.empty((), device=meta)), hmc._welford_start(q), torch.ones_like(q))
    q, da, wf, inv_mass = hmc._hmc_warmup_chunk(vg, MetaDraws(), carry, 0, 2, 0.01, 3, True, True, 0.8)
    assert q.device == meta and da[0].device == meta and wf[2] == 2.0
    samples, accept = torch.empty((2, prob.d), device=meta), torch.empty(2, device=meta)
    hmc._hmc_sample_chunk(vg, MetaDraws(), q, torch.exp(da[1]), inv_mass, 3, samples, accept, 0, 2)
    assert vg.evaluations == 4 * 4


@pytest.mark.parametrize("eps0,seed", [(1e-4, 5), (0.01, 6), (3.0, 7)])
def test_find_reasonable_step_size_equals_jax(eps0, seed):
    """With JAX's normal injected the search returns JAX's step exactly,
    eps0·2^k (doubling from a small eps0, halving from a large one)."""
    prob = Problem(32)
    key = jax.random.key(seed)
    ones = np.ones(prob.d, np.float32)
    want = float(jhmc._find_reasonable_step_size(prob.jax_nullary(), jnp.asarray(prob.q0), key, eps0,
                                                 jnp.asarray(ones)))
    z = jax.random.normal(key, (prob.d,), jnp.float32)
    trace = []
    got = hmc._find_reasonable_step_size(hmc._Potential(prob.torch_nullary()), t(prob.q0), t(z), eps0, t(ones),
                                         trace)
    assert_margins(trace)
    assert float(got) == want
    k = math.log2(want / float(np.float32(eps0)))
    assert k == round(k) and k != 0


def test_dual_averaging_matches_jax_over_20_updates():
    rng = np.random.default_rng(0)
    accept = rng.uniform(size=20).astype(np.float32)
    eps = np.float32(0.0123)
    state = hmc._fresh_dual_averaging(torch.tensor(eps))
    ref = (jnp.log(eps), jnp.log(eps), jnp.zeros(()), jnp.log(10.0 * eps))
    for it in range(20):
        state = hmc._dual_averaging_update(state, torch.tensor(accept[it]), 0.8, it)
        ref = jhmc._dual_averaging_update(ref, jnp.asarray(accept[it]), 0.8, jnp.int32(it))
        for got, want in zip(state, ref):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_warmup_phase_lengths_equal_jax():
    for warmup in list(range(10)) + [10, 50, 100]:
        for adapt_eps in (True, False):
            for adapt_mass in (True, False):
                assert (hmc.warmup_phase_lengths(warmup, adapt_eps, adapt_mass)
                        == jhmc.warmup_phase_lengths(warmup, adapt_eps, adapt_mass))


WHOLE_CHAIN = hmc.HMCConfig(num_samples=6, warmup=8, step_size=0.05, num_steps=5)


def test_whole_chain_matches_jax_with_its_draws_replayed():
    """``hmc_sample`` on fc-16 and 64 points, warmup 8 (both adaptations,
    the mass switch among them), 6 draws of 5 steps, with JAX's draws: the
    draws within 1e-4·max, the accept probabilities within 1e-4, the final
    step size and inverse mass within rtol 1e-4; and the port's results
    bit-identical with chunks of 1 and 3."""
    prob = Problem(64, seed=1)
    key = jax.random.key(11)
    want, jinfo = jhmc.hmc_sample(prob.jpot, jnp.asarray(prob.q0), key, jax_config(WHOLE_CHAIN),
                                  data=(prob.x, prob.labels))
    draws = jax_chain_draws(key, prob.d, WHOLE_CHAIN)
    trace = []
    got, info = hmc.hmc_sample(prob.tpot, t(prob.q0), None, WHOLE_CHAIN, data=prob.tdata,
                               draws=Replay(*draws), trace=trace)
    assert_margins(trace)
    assert sum(e[0] == "transition" for e in trace) == 14
    close(got, want, of_max=1e-4)
    np.testing.assert_allclose(info.accept_prob.numpy(), np.asarray(jinfo.accept_prob), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(info.step_size), float(jinfo.step_size), rtol=1e-4)
    np.testing.assert_allclose(info.inv_mass.numpy(), np.asarray(jinfo.inv_mass), rtol=1e-4)
    assert not np.allclose(np.asarray(jinfo.inv_mass), 1.0)  # the mass window moved
    for chunk in (1, 3):
        again, info2 = hmc.hmc_sample(prob.tpot, t(prob.q0), None, WHOLE_CHAIN, data=prob.tdata,
                                      chunk_size=chunk, draws=Replay(*draws))
        assert torch.equal(again, got) and torch.equal(info2.accept_prob, info.accept_prob)
        assert torch.equal(info2.step_size, info.step_size) and torch.equal(info2.inv_mass, info.inv_mass)


def test_train_batched_faithful_matches_jax_with_its_draws_replayed():
    """Faithful mode on two batches of 32: each batch's run from ``key, k_run
    = split(key)``, then the resample's indices from ``key, k_idx =
    split(key)``, all replayed; the port's resampled draws equal JAX's.

    A warmup of 8 gives each run a Welford window of 4 draws, whose variance
    turns f32-level differences of the draws into percent-level differences
    of the inverse mass wherever the window barely moved; the problem and key
    are one where the window is well conditioned (on others the two chains
    part after the first mass switch with every decision clear of its
    threshold)."""
    prob = Problem(64, seed=3)
    x, labels = prob.x, prob.labels
    key = jax.random.key(23)
    kw = dict(n_samples=5, warmup=8, step_size=0.05, num_steps=4, mode="faithful", verbose=False)
    want, jinfo = jhmc.hmc_train_batched(prob.jpot, [(x[:32], labels[:32]), (x[32:], labels[32:])],
                                         jnp.asarray(prob.q0), key, **kw)
    cfg = hmc.HMCConfig(num_samples=5 // 2 + 1, warmup=8, step_size=0.05, num_steps=4)
    search, momentum, uniform = [], [], []
    for _ in range(2):
        key, k_run = jax.random.split(key)
        for acc, more in zip((search, momentum, uniform), jax_chain_draws(k_run, prob.d, cfg)):
            acc.extend(more)
    key, k_idx = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k_idx, (5,), 0, cfg.num_samples))
    tx, tl = prob.tdata
    trace = []
    got, info = hmc.hmc_train_batched(prob.tpot, [(tx[:32], tl[:32]), (tx[32:], tl[32:])], t(prob.q0), None,
                                      draws=Replay(search, momentum, uniform, idx), trace=trace, **kw)
    assert_margins(trace)
    assert got.shape == (5, prob.d)
    close(got, want, of_max=1e-4)
    np.testing.assert_allclose(float(info.step_size), float(jinfo.step_size), rtol=1e-4)


def centre_potential(q, x, labels):
    return 0.5 * ((q - x.mean()) ** 2).sum(-1)


CENTRE_BATCHES = [(torch.full((4,), 0.0), torch.zeros(4, dtype=torch.long)),
                  (torch.full((4,), 5.0), torch.zeros(4, dtype=torch.long))]


def test_hmc_train_batched_faithful_resamples_last_batch():
    """Faithful mode with the port's own draws: n_samples draws resampled
    from the last batch's chain (JAX ``tests/test_hmc.py:98``)."""
    samples, _ = hmc.hmc_train_batched(centre_potential, CENTRE_BATCHES, torch.zeros(3), 0, n_samples=40,
                                       warmup=100, step_size=0.3, num_steps=5, mode="faithful", verbose=False)
    assert samples.shape == (40, 3)
    assert abs(float(samples.mean()) - 5.0) < 1.0  # conditioned on the LAST batch only
    assert len(torch.unique(samples[:, 0])) < 40  # 40 drawn with replacement from 21


def test_hmc_train_batched_full_mode_uses_all_data():
    samples, _ = hmc.hmc_train_batched(centre_potential, CENTRE_BATCHES, torch.zeros(3), 0, n_samples=200,
                                       warmup=100, step_size=0.3, num_steps=5, mode="full", verbose=False)
    assert samples.shape == (200, 3)
    assert abs(float(samples.mean()) - 2.5) < 0.5


def test_what_is_not_ported_raises(monkeypatch):
    """An unknown precision, a chunk size below 1, unknown samplers and modes
    raise; ``sampler="nuts"`` samples by NUTS and ``precision="default"``
    (single-pass bf16) samples too."""
    from robustbnns_tpu_torch.inference.nuts import NUTSInfo

    kw = dict(n_samples=4, warmup=2, verbose=False)
    samples, info = hmc.hmc_train_batched(centre_potential, CENTRE_BATCHES, torch.zeros(3), 0, sampler="nuts", **kw)
    assert samples.shape == (4, 3) and isinstance(info, NUTSInfo) and bool(torch.isfinite(samples).all())
    with pytest.raises(ValueError, match="sampler"):
        hmc.hmc_train_batched(centre_potential, CENTRE_BATCHES, torch.zeros(3), 0, sampler="mala", **kw)
    with pytest.raises(ValueError, match="mode"):
        hmc.hmc_train_batched(centre_potential, CENTRE_BATCHES, torch.zeros(3), 0, mode="half", **kw)
    cfg = hmc.HMCConfig(num_samples=2, warmup=2)
    samples, _ = hmc.hmc_sample(std_normal, torch.zeros(3), 0, cfg._replace(precision="default"))
    assert samples.shape == (2, 3) and bool(torch.isfinite(samples).all())  # the bf16 opt-in samples
    with pytest.raises(ValueError, match="precision"):
        hmc.hmc_sample(std_normal, torch.zeros(3), 0, cfg._replace(precision="bf16"))
    with pytest.raises(ValueError, match="chunk_size"):
        hmc.hmc_sample(std_normal, torch.zeros(3), 0, cfg, chunk_size=0)
    with pytest.raises(ValueError, match="last axis"):
        hmc.hmc_sample(lambda q: (q * q).sum(), torch.zeros((2, 3)), 0, cfg._replace(num_chains=2))
    monkeypatch.setenv("ROBUSTBNNS_HMC_CHUNK", "0")
    with pytest.raises(ValueError, match="chunk_size"):
        hmc.hmc_sample(std_normal, torch.zeros(3), 0, cfg)


def test_mcmc_precision_default_and_env_validation():
    """The sampler never defaults to "default"; a typo in
    ROBUSTBNNS_MCMC_PRECISION fails at resolution, as in JAX."""
    import os
    from unittest import mock

    assert hmc.MCMC_PRECISION_DEFAULT == os.environ.get("ROBUSTBNNS_MCMC_PRECISION", "high") != "default"
    assert hmc.HMCConfig(num_samples=1, warmup=1).precision == hmc.MCMC_PRECISION_DEFAULT
    with mock.patch.dict(os.environ, {"ROBUSTBNNS_MCMC_PRECISION": "f32"}):
        with pytest.raises(ValueError, match="ROBUSTBNNS_MCMC_PRECISION"):
            hmc._default_mcmc_precision()
    for ok in ("default", "high", "highest"):
        with mock.patch.dict(os.environ, {"ROBUSTBNNS_MCMC_PRECISION": ok}):
            assert hmc._default_mcmc_precision() == ok


def test_mcmc_heartbeat_emits_progress(monkeypatch, capsys):
    """ROBUSTBNNS_MCMC_HEARTBEAT=1 prints one synced stderr line per chunk and
    changes no draw (JAX ``tests/test_hmc.py:348``)."""
    cfg = hmc.HMCConfig(num_samples=4, warmup=4, step_size=0.3)
    q0 = torch.full((3,), 1.0)
    monkeypatch.delenv("ROBUSTBNNS_MCMC_HEARTBEAT", raising=False)
    s_off, _ = hmc.hmc_sample(std_normal, q0, 3, cfg, chunk_size=2)
    assert "[mcmc" not in capsys.readouterr().err
    monkeypatch.setenv("ROBUSTBNNS_MCMC_HEARTBEAT", "1")
    s_on, _ = hmc.hmc_sample(std_normal, q0, 3, cfg, chunk_size=2)
    err = capsys.readouterr().err
    assert err.count("warmup") >= 2 and err.count("hmc-sample") == 2
    assert torch.equal(s_off, s_on)


def test_hmc_multi_chain_shapes():
    cfg = hmc.HMCConfig(num_samples=50, warmup=20, step_size=0.2, num_chains=3)
    samples, info = hmc.hmc_sample(std_normal, torch.zeros(4), 0, cfg)
    assert samples.shape == (3, 50, 4)
    assert info.accept_prob.shape == (3, 50) and info.step_size.shape == (3,) and info.inv_mass.shape == (3, 4)


def test_hmc_fixed_step_mode():
    cfg = hmc.HMCConfig(num_samples=100, warmup=50, step_size=0.25, adapt_step_size=False,
                        adapt_mass_matrix=False)
    _, info = hmc.hmc_sample(std_normal, torch.zeros(2), 0, cfg)
    assert float(info.step_size) == pytest.approx(0.25)
    assert torch.equal(info.inv_mass, torch.ones(2))


def test_hmc_recovers_standard_normal():
    """Sampling N(0, I) on 4 dimensions: the moments (JAX ``tests/test_hmc.py:45``
    at a third of its budget, tolerances widened by sqrt(3))."""
    cfg = hmc.HMCConfig(num_samples=700, warmup=200, step_size=0.2, num_steps=8)
    samples, info = hmc.hmc_sample(std_normal, torch.zeros(4), 0, cfg)
    assert samples.shape == (700, 4)
    assert float(info.accept_prob.mean()) > 0.6
    assert abs(float(samples.mean())) < 0.17
    assert abs(float(samples.std()) - 1.0) < 0.17


def test_three_chains_in_one_batched_run_equal_three_single_runs():
    """C = 3 chains of the BNN potential (one stacked forward and backward per
    evaluation, adaptation per chain) equal three one-chain runs with the same
    injected draws, up to the f32 rounding of batched products."""
    prob = Problem(32, seed=3)
    cfg = hmc.HMCConfig(num_samples=4, warmup=8, step_size=0.05, num_steps=4)
    rng = np.random.default_rng(12)
    n_search, n_trans = 2, 12
    per_chain = [(rng.normal(size=(n_search, prob.d)), rng.normal(size=(n_trans, prob.d)), rng.uniform(size=n_trans))
                 for _ in range(3)]
    starts = np.stack([prob.q0, 0.9 * prob.q0, 1.1 * prob.q0]).astype(np.float32)
    singles, traces = [], []
    for c in range(3):
        trace = []
        s, info = hmc.hmc_sample(prob.tpot, t(starts[c]), None, cfg, data=prob.tdata,
                                 draws=Replay(*per_chain[c]), trace=trace)
        assert_margins(trace)
        singles.append((s, info))
    stacked = Replay(*(np.stack([pc[k] for pc in per_chain], axis=1) for k in range(3)))
    trace = []
    got, info = hmc.hmc_sample(prob.tpot, t(starts), None, cfg._replace(num_chains=3), data=prob.tdata,
                               draws=stacked, trace=trace)
    assert_margins(trace)
    assert got.shape == (3, 4, prob.d)
    for c, (s, i) in enumerate(singles):
        close(got[c], s, of_max=1e-5)
        np.testing.assert_allclose(info.accept_prob[c].numpy(), i.accept_prob.numpy(), atol=1e-5)
        np.testing.assert_allclose(float(info.step_size[c]), float(i.step_size), rtol=1e-5)
        np.testing.assert_allclose(info.inv_mass[c].numpy(), i.inv_mass.numpy(), rtol=1e-5)


def test_mass_switch_degenerate_guard_and_reanchor_match_jax():
    """A Welford window that never moved falls back to unit mass and the step
    re-anchors (fresh dual-averaging state); a healthy window's variance flows
    through Stan's shrinkage — both as JAX's ``_mass_switch`` computes them."""
    d = 6
    q = np.full(d, 0.3, np.float32)
    eps = np.float32(1e-6)
    jda = (jnp.log(eps), jnp.log(eps), jnp.zeros(()), jnp.log(np.float32(1e-5)))
    tda = tuple(torch.tensor(float(np.asarray(v)), dtype=torch.float32) for v in jda)
    key = jax.random.key(0)
    z = jax.random.normal(key, (d,), jnp.float32)
    jpot = lambda q, *unused: 0.5 * jnp.sum(q * q)  # noqa: E731
    for m2, count in ((np.zeros(d, np.float32), 50.0), (np.full(d, 2.0 * 49.0, np.float32), 50.0),
                      (np.full(d, 3.0, np.float32), 1.0)):
        jda2, jinv = jhmc._mass_switch(jpot, (), jnp.asarray(q), key, jda, (jnp.asarray(q), jnp.asarray(m2), count),
                                       True)
        tda2, tinv = hmc._mass_switch(hmc._Potential(std_normal), t(q), Replay(search=[z]), tda,
                                      (t(q), t(m2), count), True)
        np.testing.assert_allclose(tinv.numpy(), np.asarray(jinv), rtol=1e-6)
        for got, want in zip(tda2, jda2):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        if count > 1 and m2.max() > 0:
            np.testing.assert_allclose(tinv.numpy(), (50.0 / 55.0) * 2.0 + (5.0 / 55.0) * 1e-3, rtol=1e-5)
        else:
            assert torch.equal(tinv, torch.ones(d))
            assert float(torch.exp(tda2[0])) > 1e-5 and float(tda2[2]) == 0.0


def test_warmup_dual_averaging_counter_continuous_across_window():
    """One dual-averaging counter across the init buffer and the mass window,
    restarting only after the mass switch (JAX ``tests/test_hmc.py:267``)."""
    seen = []

    def warmup_chunk(carry, it0, n, welford_on):
        seen.append((it0, n, welford_on))
        return carry

    def mass_switch(q, da, wf):
        seen.append("mass_switch")
        return da, torch.ones_like(q)

    q = torch.zeros(3)
    carry0 = (q, hmc._fresh_dual_averaging(torch.tensor(1.0)), hmc._welford_start(q), torch.ones(3))
    hmc.run_windowed_warmup(warmup_chunk, mass_switch, carry0, hmc.HMCConfig(num_samples=1, warmup=8), chunk_size=3)
    assert seen == [(0, 2, False), (2, 3, True), (5, 1, True), "mass_switch", (0, 2, False)]


def test_map_warm_start_matches_optax_adam():
    """50 Adam steps on the fc-16 potential from JAX's init: the port's
    ``torch.optim.Adam`` against JAX's optax Adam, to 1e-4·max."""
    prob = Problem(32)
    want, want_us = jhmc.map_warm_start(prob.jpot, jnp.asarray(prob.q0), data=(prob.x, prob.labels), steps=50,
                                        lr=1e-2)
    got, us = hmc.map_warm_start(prob.tpot, t(prob.q0), data=prob.tdata, steps=50, lr=1e-2)
    close(got, want, of_max=1e-4)
    np.testing.assert_allclose(us.numpy(), np.asarray(want_us), rtol=1e-4)
    assert float(us[-1]) < float(us[0])
