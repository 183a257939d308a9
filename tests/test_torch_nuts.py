"""The port's NUTS (``inference/nuts.py``) against the JAX package's.

JAX's threefry draws are replayed into the port in the order of JAX's key
splits (``nuts.py:372-373,400,433``; for a whole chain ``:590,603,626,660``).
A trajectory is only comparable while no decision sits at its threshold: a
flipped U-turn test, multinomial or merge choice changes the draw. So every
comparison first asserts, from the port's ``trace``, that each U-turn dot
product is at least 1e-3 of |rho|·|v| from 0, each multinomial and merge
comparison at least 1e-3 from its threshold in log space, and each energy
error at least 1 from the divergence cutoff of 1000.

Tolerances: a transition on a Gaussian (elementwise leapfrog, one reduction
for the energy) holds q to 1e-5·max|ref|; on the fc2-16 BNN potential, whose
leaves chain forward and backward passes, to 1e-4·max|ref|; accept statistics
(means of exp(−ΔH)) to 1e-6·|H0|, about 8 ulp of the energy whose rounding
they inherit; leaf counts and divergence flags exactly. Whole adapted chains:
1e-4·max|ref|.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hmc import jax_potential

from robustbnns_tpu.inference import hmc as jhmc
from robustbnns_tpu.inference import nuts as jnuts
from robustbnns_tpu.models import build_architecture as jax_build
from robustbnns_tpu.utils.pytree import flatten_tree_to_vector as jax_flatten
from robustbnns_tpu_torch.inference import hmc, nuts
from robustbnns_tpu_torch.models.architectures import build_architecture
from robustbnns_tpu_torch.models.bnn import bnn_potential
from robustbnns_tpu_torch.utils.pytree import flatten_tree_to_vector


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(got, want, of_max):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=of_max * max(np.abs(want).max(), 1e-30))


def assert_margins(trace):
    """No decision of the run within 1e-3 of its threshold (in its unit)."""
    assert trace, "the run recorded nothing"
    for entry in trace:
        if entry[0] == "search":  # the step-size searches of the warmup
            la = entry[1].detach().numpy()
            assert np.all(np.abs(la - math.log(0.5)) > 1e-3), f"search at its threshold: {la}"
            continue
        kind, value, threshold, scale, active = entry
        value, threshold = torch.as_tensor(value).double(), torch.as_tensor(threshold).double()
        decided = ~torch.isfinite(threshold) | (torch.as_tensor(scale) <= 0) | ~torch.as_tensor(active)
        clear = (value - threshold).abs() > 1e-3 * torch.as_tensor(scale)
        assert bool((decided | clear).all()), f"{kind} at its threshold: {value} vs {threshold} (scale {scale})"


class JaxDraws:
    """JAX's draws for the port's NUTS, split as JAX's transition splits
    them: each ``momentum`` opens a transition from the next of
    ``transition_keys``; each doubling splits its outer key in four."""

    def __init__(self, d, transition_keys, search_keys=(), resample_idx=None):
        self.d, self.transitions, self.search = d, iter(transition_keys), iter(search_keys)
        self.resample_idx = resample_idx

    def search_normal(self, like):
        return t(jax.random.normal(next(self.search), (self.d,), jnp.float32))

    def momentum(self, like):
        self.key_out, k_mom = jax.random.split(next(self.transitions))
        return t(jax.random.normal(k_mom, (self.d,), jnp.float32))

    def direction(self, like):
        self.key_out, k_dir, self.key_in, self.k_merge = jax.random.split(self.key_out, 4)
        u = jax.random.uniform(k_dir)
        assert bool(jax.random.bernoulli(k_dir)) == bool(u < 0.5)
        return t(u)

    def merge(self, like):
        return t(jax.random.uniform(self.k_merge))

    def multinomial(self, like):
        self.key_in, k_mult = jax.random.split(self.key_in)
        return t(jax.random.uniform(k_mult))

    def resample(self, n, high):
        idx = torch.tensor(np.asarray(self.resample_idx)).long()
        assert idx.shape == (n,) and int(idx.max()) < high
        return idx


def jax_chain_keys(key, cfg):
    """The search and transition keys of JAX's ``nuts_sample(key)`` for one
    chain, in the order the port asks for them: ``_nuts_init`` splits (key,
    k_find) then (key, k_warm); warmup transitions split (k, k_t) from k_warm,
    the mass switch (k, k_ms); sampling transitions run from the key left."""
    adapt_eps = cfg.adapt_step_size and cfg.warmup > 0
    adapt_mass = cfg.adapt_mass_matrix and cfg.warmup > 0
    search, trans = [], []

    def transitions(k, n):
        for _ in range(n):
            k, k_t = jax.random.split(k)
            trans.append(k_t)
        return k

    key, k_find = jax.random.split(key)
    if adapt_eps:
        search.append(k_find)
    key, k = jax.random.split(key)
    w1, w2, w3 = jhmc.warmup_phase_lengths(cfg.warmup, adapt_eps, adapt_mass)
    k = transitions(k, w1 + w2)
    if adapt_mass:
        k, k_ms = jax.random.split(k)
        if adapt_eps:
            search.append(k_ms)
        transitions(k, w3)
    transitions(key, cfg.num_samples)
    return search, trans


def std_normal(q):
    return 0.5 * (q * q).sum(-1)


MEAN, SCALE = np.array([1.0, -2.0, 0.5], np.float32), np.array([0.3, 2.0, 1.0], np.float32)


def gaussian(q):
    z = (q - t(MEAN)) / t(SCALE)
    return 0.5 * (z * z).sum(-1)


def jax_gaussian(q):
    z = (q - MEAN) / SCALE
    return 0.5 * jnp.sum(z * z)


class Fc2Problem:
    """fc2-16 on 24 points of 16 pixels and 3 classes: both packages'
    potentials, nullary, and JAX's init as numpy (D = 627)."""

    def __init__(self, seed=0):
        shape, classes = (4, 4, 1), 3
        jarch = jax_build("fc2", "leaky", shape, classes, 16)
        tarch = build_architecture("fc2", "leaky", shape, classes, 16)
        rng = np.random.default_rng(seed)
        x = rng.uniform(size=(24,) + shape).astype(np.float32)
        labels = rng.integers(0, classes, 24).astype(np.int32)
        q0, unravel = jax_flatten(jarch.init(jax.random.key(seed)))
        self.q0, self.d = np.asarray(q0), int(q0.shape[0])
        jpot = jax_potential(jarch, unravel)
        self.jax = lambda q: jpot(q, x, labels)
        _, tunravel = flatten_tree_to_vector(tarch.init(torch.Generator().manual_seed(0)))
        tpot, tdata = bnn_potential(tarch, tunravel), (torch.from_numpy(x), torch.from_numpy(labels).long())
        self.torch = lambda q: tpot(q, *tdata)


def potentials():
    """(name, port potential, JAX potential, start, inv_mass, [(max_depth, eps)], q tolerance of max)."""
    rng = np.random.default_rng(7)
    fc2 = Fc2Problem()
    return {
        "std_normal": (std_normal, lambda q: 0.5 * jnp.sum(q * q), np.zeros(4, np.float32),
                       np.ones(4, np.float32), [(6, 0.3), (3, 1.1)], 1e-5),
        "scaled_gaussian": (gaussian, jax_gaussian, np.zeros(3, np.float32), np.array([1.0, 0.5, 2.0], np.float32),
                            [(6, 0.25), (2, 0.9)], 1e-5),
        "fc2_16_bnn": (fc2.torch, fc2.jax, fc2.q0, rng.uniform(0.5, 1.5, fc2.d).astype(np.float32),
                       [(7, 0.2), (4, 0.5), (5, 0.01)], 1e-4),
    }


POTENTIALS = potentials()


@pytest.mark.parametrize("name", list(POTENTIALS))
def test_transition_matches_jax_flat_and_nested(name):
    """Successive transitions from JAX's keys: the port's leaf counts,
    divergence flags and accept statistics equal JAX's flat ``_nuts_transition``
    and its nested reference (asserted bit-identical to each other), the
    positions within the stated tolerance; deep trees, early U-turns and
    max-depth exits all occur."""
    pot, jpot, q0, inv_mass, settings, tol = POTENTIALS[name]
    d = q0.shape[0]
    leaves_seen = set()
    for max_depth, eps in settings:
        flat = jax.jit(jnuts._nuts_transition(jpot, max_depth))
        nested = jax.jit(jnuts._nuts_transition_nested(jpot, max_depth))
        jq, q = jnp.asarray(q0), t(q0)
        vg = hmc._Potential(pot)
        for s in range(12):
            key = jax.random.key(100 * max_depth + s)
            want = flat(jq, key, eps, jnp.asarray(inv_mass))
            for a, b in zip(want, nested(jq, key, eps, jnp.asarray(inv_mass))):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            trace = []
            q, acc, n_leaves, div = nuts._nuts_transition(vg, q, torch.tensor(eps), t(inv_mass), max_depth,
                                                          JaxDraws(d, [key]), trace)
            assert_margins(trace)
            assert n_leaves == int(want[2]) and bool(div) == bool(want[3])
            # exp(−ΔH) inherits the f32 rounding of two energies of about |H0|
            z = jax.random.normal(jax.random.split(key)[1], (d,), jnp.float32)
            h0 = float(jpot(jq)) + 0.5 * float(jnp.sum(z * z))
            np.testing.assert_allclose(float(acc), float(want[1]), rtol=0, atol=1e-6 * max(abs(h0), 1.0))
            close(q, want[0], tol)
            jq = want[0]
            leaves_seen.add(n_leaves)
    assert len(leaves_seen) >= 3, leaves_seen  # trees of several sizes, not one shape repeated


def test_trailing_counts_match_jax():
    for i in range(1, 70):
        assert nuts._trailing_ones(i) == int(jnuts._trailing_ones(jnp.asarray(i, jnp.int32)))
        assert nuts._trailing_zeros(i) == int(jnuts._trailing_zeros(jnp.asarray(i, jnp.int32)))
    assert nuts._trailing_ones(0) == 0


def test_max_depth_bounds_the_leaves():
    """A tiny step never U-turns within max_depth = 4: at most 2^4 − 1 leaves
    (JAX ``tests/test_nuts.py:79``), and some draws reach the bound."""
    cfg = nuts.NUTSConfig(num_samples=20, warmup=0, step_size=0.01, max_depth=4, adapt_step_size=False,
                          adapt_mass_matrix=False)
    _, info = nuts.nuts_sample(std_normal, torch.zeros(2), 1, cfg)
    assert int(info.num_leapfrog.max()) == 2**4 - 1


def test_a_huge_step_diverges_like_jax():
    """A step of 50 on the scaled Gaussian: the first leaf's energy error
    passes 1000, the draw stops there, stays at its start and reports it."""
    q = np.array([0.3, -1.0, 0.2], np.float32)
    key = jax.random.key(5)
    want = jax.jit(jnuts._nuts_transition(jax_gaussian, 6))(jnp.asarray(q), key, 50.0, jnp.ones(3))
    trace = []
    got = nuts._nuts_transition(hmc._Potential(gaussian), t(q), torch.tensor(50.0), torch.ones(3), 6,
                                JaxDraws(3, [key]), trace)
    assert_margins(trace)
    assert bool(want[3]) and bool(got[3]) and got[2] == int(want[2]) == 1
    assert torch.equal(got[0], t(q))
    np.testing.assert_allclose(float(got[1]), float(want[1]), atol=1e-7)


def test_one_evaluation_per_leaf_and_one_at_the_root():
    """A draw costs ``n_leapfrog + 1`` value-and-gradient evaluations (JAX
    ``tests/test_nuts.py:249``); ``NUTSInfo.evaluations`` counts them, plus
    one per step-size search trial when the step adapts."""
    calls = []

    def counted(q):
        calls.append(1)
        return std_normal(q)

    cfg = nuts.NUTSConfig(num_samples=20, warmup=0, step_size=0.25, adapt_step_size=False, adapt_mass_matrix=False)
    _, info = nuts.nuts_sample(counted, torch.zeros(4), 3, cfg)
    assert len(calls) == info.evaluations == int(info.num_leapfrog.sum()) + cfg.num_samples
    calls.clear()
    _, info = nuts.nuts_sample(counted, torch.zeros(4), 3, cfg._replace(warmup=6, adapt_step_size=True))
    assert len(calls) == info.evaluations > int(info.num_leapfrog.sum()) + cfg.num_samples + 6


def test_at_most_one_host_read_per_leaf(monkeypatch):
    """The host reads the card only through ``_host_flag``, at most once per leaf."""
    reads = []
    flag = nuts._host_flag
    monkeypatch.setattr(nuts, "_host_flag", lambda v: reads.append(1) or flag(v))
    prob = POTENTIALS["fc2_16_bnn"]
    vg = hmc._Potential(prob[0])
    for s in range(4):
        reads.clear()
        _, _, n_leaves, _ = nuts._nuts_transition(vg, t(prob[2]), torch.tensor(0.01), t(prob[3]), 7,
                                                  JaxDraws(len(prob[2]), [jax.random.key(s)]))
        assert 0 < len(reads) <= n_leaves


WHOLE = nuts.NUTSConfig(num_samples=8, warmup=12, step_size=0.3, max_depth=6)


def test_whole_chain_matches_jax_with_its_draws_replayed():
    """``nuts_sample`` on the scaled Gaussian with both adaptations (the mass
    switch among them) from JAX's keys: draws, leaf counts, divergences,
    accept statistics, final step and inverse mass as JAX's."""
    key = jax.random.key(21)
    q0 = np.array([0.5, 0.5, 0.5], np.float32)
    want, jinfo = jnuts.nuts_sample(jax_gaussian, jnp.asarray(q0), key, jnuts.NUTSConfig(**WHOLE._asdict()))
    search, trans = jax_chain_keys(key, WHOLE)
    trace = []
    got, info = nuts.nuts_sample(gaussian, t(q0), None, WHOLE, draws=JaxDraws(3, trans, search), trace=trace)
    assert_margins(trace)
    np.testing.assert_array_equal(info.num_leapfrog.numpy(), np.asarray(jinfo.num_leapfrog))
    np.testing.assert_array_equal(info.diverging.numpy(), np.asarray(jinfo.diverging))
    close(got, want, 1e-4)
    np.testing.assert_allclose(info.accept_stat.numpy(), np.asarray(jinfo.accept_stat), rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(info.step_size), float(jinfo.step_size), rtol=1e-4)
    np.testing.assert_allclose(info.inv_mass.numpy(), np.asarray(jinfo.inv_mass), rtol=1e-4)
    assert not np.allclose(np.asarray(jinfo.inv_mass), 1.0)  # the mass window moved


def test_chunking_is_bit_identical(monkeypatch):
    """Chunks of 1 and 5, and ``ROBUSTBNNS_NUTS_CHUNK``, change no result
    (JAX ``tests/test_nuts.py:165``); a chunk below 1 raises."""
    def potential(q):
        return 0.5 * (q * q).sum(-1) + 0.1 * (q**4).sum(-1)

    cfg = nuts.NUTSConfig(num_samples=8, warmup=10, max_depth=5)
    q0 = torch.full((4,), 1.5)
    mono, i_mono = nuts.nuts_sample(potential, q0, 3, cfg)
    runs = [nuts.nuts_sample(potential, q0, 3, cfg, chunk_size=c) for c in (1, 5)]
    monkeypatch.setenv("ROBUSTBNNS_NUTS_CHUNK", "2")
    runs.append(nuts.nuts_sample(potential, q0, 3, cfg))
    for s, i in runs:
        assert torch.equal(s, mono)
        for a, b in zip(i, i_mono):
            assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    monkeypatch.setenv("ROBUSTBNNS_NUTS_CHUNK", "0")
    with pytest.raises(ValueError, match="chunk_size"):
        nuts.nuts_sample(potential, q0, 3, cfg)
    with pytest.raises(ValueError, match="chunk_size"):
        nuts.nuts_sample(potential, q0, 3, cfg, chunk_size=0)


def test_chains_equal_per_chain_runs_and_jax_vmapped_chains():
    """Three chains from JAX's ``split(key, 3)`` keys: chain c equals a
    one-chain run on chain c's draws, and JAX's vmapped chains."""
    cfg = nuts.NUTSConfig(num_samples=5, warmup=8, step_size=0.4, max_depth=5, num_chains=3)
    key = jax.random.key(4)
    starts = np.array([[0.2, 0.1, -0.3], [1.0, -1.5, 0.4], [0.0, -2.0, 1.0]], np.float32)
    want, jinfo = jnuts.nuts_sample(jax_gaussian, jnp.asarray(starts), key, jnuts.NUTSConfig(**cfg._asdict()))
    chain_draws = [JaxDraws(3, *reversed(jax_chain_keys(k, cfg))) for k in jax.random.split(key, 3)]
    trace = []
    got, info = nuts.nuts_sample(gaussian, t(starts), None, cfg, draws=chain_draws, trace=trace)
    assert_margins(trace)
    assert got.shape == (3, 5, 3) and info.accept_stat.shape == (3, 5) and info.step_size.shape == (3,)
    close(got, want, 1e-4)
    np.testing.assert_array_equal(info.num_leapfrog.numpy(), np.asarray(jinfo.num_leapfrog))
    for c, k in enumerate(jax.random.split(key, 3)):
        one, one_info = nuts.nuts_sample(gaussian, t(starts[c]), None, cfg._replace(num_chains=1),
                                         draws=JaxDraws(3, *reversed(jax_chain_keys(k, cfg))))
        assert torch.equal(one, got[c]) and torch.equal(one_info.num_leapfrog, info.num_leapfrog[c])
        assert torch.equal(one_info.inv_mass, info.inv_mass[c])


def test_recovers_gaussian_mean_and_variance():
    """N(0, I) and N((1, −2), diag(0.5, 2)²) (JAX ``tests/test_nuts.py:28,41``
    at a quarter of their draws, tolerances widened by 2)."""
    cfg = nuts.NUTSConfig(num_samples=500, warmup=200, step_size=0.5)
    samples, info = nuts.nuts_sample(std_normal, torch.zeros(4), 0, cfg)
    assert samples.shape == (500, 4) and float(info.accept_stat.mean()) > 0.6 and not bool(info.diverging.any())
    assert abs(float(samples.mean())) < 0.2 and abs(float(samples.std()) - 1.0) < 0.2

    mean, scale = torch.tensor([1.0, -2.0]), torch.tensor([0.5, 2.0])
    samples, _ = nuts.nuts_sample(lambda q: 0.5 * (((q - mean) / scale) ** 2).sum(-1), torch.zeros(2), 42,
                                  cfg._replace(warmup=300))
    np.testing.assert_allclose(samples.mean(0).numpy(), mean.numpy(), atol=0.3)
    np.testing.assert_allclose(samples.std(0).numpy(), scale.numpy(), rtol=0.5)


def test_trajectory_length_adapts_to_scale():
    """Unit mass, no adaptation: an anisotropic target takes over 4× the
    leaves of an isotropic one (JAX ``tests/test_nuts.py:56``)."""
    cfg = nuts.NUTSConfig(num_samples=60, warmup=0, step_size=0.5, adapt_step_size=False, adapt_mass_matrix=False)
    aniso = torch.tensor([1.0, 100.0])
    _, iso = nuts.nuts_sample(std_normal, torch.zeros(2), 0, cfg)
    _, ani = nuts.nuts_sample(lambda q: 0.5 * ((q / aniso) ** 2).sum(-1), torch.zeros(2), 0, cfg)
    assert float(ani.num_leapfrog.float().mean()) > 4 * float(iso.num_leapfrog.float().mean())


def test_what_nuts_refuses():
    cfg = nuts.NUTSConfig(num_samples=2, warmup=0)
    samples, _ = nuts.nuts_sample(std_normal, torch.zeros(3), 0, cfg._replace(precision="default"))
    assert samples.shape == (2, 3) and bool(torch.isfinite(samples).all())  # the bf16 opt-in samples
    with pytest.raises(ValueError, match="precision"):
        nuts.nuts_sample(std_normal, torch.zeros(3), 0, cfg._replace(precision="bf16"))
    with pytest.raises(ValueError, match="chain"):
        nuts.nuts_sample(std_normal, torch.zeros((2, 3)), 0, cfg)
    with pytest.raises(ValueError, match="draws objects"):
        nuts.nuts_sample(std_normal, torch.zeros(3), 0, cfg._replace(num_chains=2), draws=[None])
    with pytest.raises(ValueError, match="sampler"):
        hmc.check_sampler("mala")
    hmc.check_sampler("nuts")


def test_train_batched_faithful_with_nuts_matches_jax():
    """``hmc_train_batched(sampler='nuts')`` in faithful mode on two batches:
    each batch's run (both adaptations) from ``key, k_run = split(key)``, the
    resample from ``key, k_idx = split(key)``, all replayed; the resampled
    draws, leaves, step and history as JAX's.

    The potential is a Gaussian whose centre is the batch mean. A BNN
    potential's trees are held above, one transition at a time; a whole
    faithful run on one is not a fair comparison: its long trajectories
    amplify rounding, so that on fc2-16 JAX's own jitted leapfrog loop parts
    from its eager one within 16 steps (eager JAX and the port stay
    together)."""
    scale = np.array([0.5, 1.0, 2.0], np.float32)

    def jpot(q, bx, blabels):
        return 0.5 * jnp.sum(((q - jnp.mean(bx)) / scale) ** 2)

    def tpot(q, bx, blabels):
        return 0.5 * (((q - bx.mean()) / t(scale)) ** 2).sum(-1)

    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(0.0, 1.0, 8), rng.normal(3.0, 1.0, 8)]).astype(np.float32)
    labels = np.zeros(16, np.int32)
    q0 = np.array([0.4, -0.2, 0.1], np.float32)
    key = jax.random.key(9)
    kw = dict(n_samples=6, warmup=10, step_size=0.3, mode="faithful", sampler="nuts", verbose=False)
    want, jinfo = jhmc.hmc_train_batched(jpot, [(x[:8], labels[:8]), (x[8:], labels[8:])], jnp.asarray(q0), key, **kw)
    cfg = nuts.NUTSConfig(num_samples=6 // 2 + 1, warmup=10, step_size=0.3)
    search, trans = [], []
    for _ in range(2):
        key, k_run = jax.random.split(key)
        s, tr = jax_chain_keys(k_run, cfg)
        search += s
        trans += tr
    key, k_idx = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k_idx, (6,), 0, cfg.num_samples))
    tx, tl = torch.from_numpy(x), torch.from_numpy(labels).long()
    trace, history = [], {}
    got, info = hmc.hmc_train_batched(tpot, [(tx[:8], tl[:8]), (tx[8:], tl[8:])], t(q0), None,
                                      draws=JaxDraws(3, trans, search, idx), trace=trace, history=history, **kw)
    assert_margins(trace)
    assert isinstance(info, nuts.NUTSInfo) and got.shape == (6, 3)
    close(got, want, 1e-4)
    np.testing.assert_array_equal(info.num_leapfrog.numpy(), np.asarray(jinfo.num_leapfrog))
    np.testing.assert_allclose(float(info.step_size), float(jinfo.step_size), rtol=1e-4)
    assert len(history["leaves"]) == 2 and history["divergences"] == [0.0, 0.0]
    np.testing.assert_allclose(history["leaves"][-1], float(np.mean(jinfo.num_leapfrog)))
    np.testing.assert_allclose(history["accept"][-1], float(np.mean(jinfo.accept_stat)), atol=1e-4)


def test_train_batched_with_nuts_conditions_on_the_last_batch():
    """Faithful NUTS with the port's own draws keeps the reference's
    semantics (JAX ``tests/test_nuts.py:117``)."""
    from test_torch_hmc import CENTRE_BATCHES, centre_potential

    samples, info = hmc.hmc_train_batched(centre_potential, CENTRE_BATCHES, torch.zeros(3), 0, n_samples=40,
                                          warmup=60, step_size=0.3, mode="faithful", sampler="nuts", verbose=False)
    assert samples.shape == (40, 3) and isinstance(info, nuts.NUTSInfo)
    assert abs(float(samples.mean()) - 5.0) < 1.0
