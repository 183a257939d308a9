"""The port's mesh module (``robustbnns_tpu_torch/parallel``) against the
unsharded port calls and the JAX package's mesh functions, case by case as
``tests/test_parallel.py`` (``test_graft_entry_contract`` is the JAX
package's own and has no counterpart).

Two gloo ranks (``tests/torch_mesh_worker.py``, a file store, no TCP port)
run every case once, on a 2x1 mesh (``data``) or a 1x2 mesh (``sample``);
JAX runs on two of conftest's eight CPU devices with the same mesh shapes.
JAX's draws are injected into the port (the SVI step's noise, the
predictive's, the FGSM predictive's), so those paths are deterministic in
both packages and compared directly.

Tolerances: a two-rank sum adds the same f32 terms in another order, so
sharded results sit within 1e-6 (probabilities, O(1) gradients) to 1e-5
(an Adam step on a loss of ~50) of the unsharded ones; against JAX, 1e-5
for forward values and 1e-4 for a gradient step, as ``tests/test_torch_svi.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from robustbnns_tpu import parallel as jax_parallel
from robustbnns_tpu.inference import svi as jax_svi
from robustbnns_tpu.models import build_architecture as jax_build
from robustbnns_tpu.predict import svi_predict as jax_svi_predict
from robustbnns_tpu.utils.pytree import normal_like_tree as jax_normal_like_tree
from robustbnns_tpu_torch.attacks.gradient_attacks import _input_gradients, fgsm_attack, pgd_attack
from robustbnns_tpu_torch.inference.hmc import ChainDraws, HMCConfig, _seeded_draws, hmc_sample
from robustbnns_tpu_torch.inference.nuts import NUTSConfig, nuts_sample
from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior
from robustbnns_tpu_torch.models.architectures import build_architecture
from robustbnns_tpu_torch.predict import svi_predict

N_DRAWS = 4


def stacked(trees):
    return jax.tree_util.tree_map(lambda *v: np.stack([np.asarray(a) for a in v]), *trees)


@pytest.fixture(scope="module")
def inputs():
    """JAX-made inputs as numpy, the names the worker reads."""
    jarch = jax_build("fc", "relu", (1, 2, 1), 2, 16)
    post = jax_svi.init_meanfield(jax.random.key(0), jarch.init(jax.random.key(1)))
    rng = np.random.default_rng(0)
    fgsm_arch = jax_build("fc", "leaky", (1, 2, 1), 2, 16)
    fgsm_post = jax_svi.init_meanfield(jax.random.key(6), fgsm_arch.init(jax.random.key(7)))
    fgsm_keys = jax.random.split(jax.random.key(8), N_DRAWS)
    pred_keys = jax.random.split(jax.random.key(5), N_DRAWS)
    inp = {
        "svi_x": np.asarray(jax.random.uniform(jax.random.key(2), (32, 1, 2, 1))),
        "svi_labels": rng.integers(0, 2, 32),
        "pred_x": np.asarray(jax.random.uniform(jax.random.key(4), (16, 1, 2, 1))),
        "fgsm_x": rng.uniform(size=(32, 1, 2, 1)).astype(np.float32),
        "fgsm_labels": rng.integers(0, 2, 32),
        **worker.tree_arrays("svi_loc", post.loc), **worker.tree_arrays("svi_rho", post.rho),
        **worker.tree_arrays("svi_eps", jax_normal_like_tree(jax.random.key(3), post.loc)),
        **worker.tree_arrays("pred_eps", stacked([jax_normal_like_tree(k, post.loc) for k in pred_keys])),
        **worker.tree_arrays("nn", jarch.init(jax.random.key(9))),
        **worker.tree_arrays("fgsm_loc", fgsm_post.loc), **worker.tree_arrays("fgsm_rho", fgsm_post.rho),
        **worker.tree_arrays("fgsm_eps", stacked([jax_normal_like_tree(k, fgsm_post.loc) for k in fgsm_keys])),
    }
    return inp, {"arch": jarch, "post": post, "pred_keys": pred_keys, "fgsm_arch": fgsm_arch,
                 "fgsm_post": fgsm_post, "fgsm_keys": fgsm_keys}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return worker.spawn("parallel", 2, tmp_path_factory.mktemp("parallel"), inputs[0])


@pytest.fixture(scope="module")
def jax_mesh21():
    return jax_parallel.make_mesh(n_data=2, n_sample=1, devices=jax.devices()[:2])


def jax_mesh(n_data, n_sample):
    return jax_parallel.make_mesh(n_data=n_data, n_sample=n_sample, devices=jax.devices()[:2])


def flat(tree) -> list:
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for item in tree for v in flat(item)]
    return [tree]


def assert_ranks_equal(ranks, name):
    """Every rank returned the same bits (results are whole tensors on every rank)."""
    for a, b in zip(flat(ranks[0][name]), flat(ranks[1][name]), strict=True):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b, name


def test_make_mesh_shapes(ranks):
    for r, rank in enumerate(ranks):
        out = rank["make_mesh"]
        assert out["shapes"] == [{"data": 2, "sample": 1}, {"data": 1, "sample": 2}]
        assert out["index"] == [r, r]
        assert out["error"] == "mesh 3x2 != 2 ranks"


def test_shard_batch_places_leading_axis(ranks):
    x = torch.arange(32.0).reshape(32, 1)
    for r, rank in enumerate(ranks):
        out = rank["shard_batch"]
        assert torch.equal(out["local"], x[16 * r : 16 * (r + 1)])
        assert torch.equal(out["gathered"], x)
        assert torch.equal(out["ragged"], torch.arange(33.0))  # 33 rows do not divide: replicated, with a warning
        assert len(out["warned"]) == 1 and "does not divide" in out["warned"][0]
        assert torch.equal(out["replicated"][0], torch.zeros(3))  # rank 0's values everywhere
        assert torch.equal(out["replicated"][1]["b"], torch.full((2,), 10.0))


def test_sharded_svi_step_matches_single_device(ranks, inputs, jax_mesh21):
    """The data-parallel step gives the unsharded step's loss and update, and
    JAX's sharded step's (its draw injected)."""
    import optax

    inp, j = inputs
    arch, post = j["arch"], j["post"]
    optimizer = optax.adam(0.01, b1=0.9, b2=0.999, eps=1e-8)
    x, labels = jnp.asarray(inp["svi_x"]), jnp.asarray(inp["svi_labels"])
    step = jax_parallel.sharded_svi_step(arch, optimizer, jax_mesh21)
    p_ref, _, loss_ref = step(jax_parallel.replicate(post, jax_mesh21),
                              jax_parallel.replicate(optimizer.init(post), jax_mesh21),
                              jax_parallel.shard_batch(x, jax_mesh21), jax_parallel.shard_batch(labels, jax_mesh21),
                              jax.random.key(3))
    want = jax.tree_util.tree_leaves(p_ref.loc) + jax.tree_util.tree_leaves(p_ref.rho)
    assert ranks[0]["svi_step"]["checksums"][0] == ranks[0]["svi_step"]["checksums"][1]
    for rank in ranks:
        out = rank["svi_step"]
        assert float(out["mesh"]["loss"]) == pytest.approx(float(out["plain"]["loss"]), rel=1e-6)
        assert float(out["mesh"]["loss"]) == pytest.approx(float(loss_ref), rel=1e-5)
        for got, plain, ref in zip(out["mesh"]["leaves"], out["plain"]["leaves"], want, strict=True):
            np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_sharded_predict_matches_unsharded(ranks, inputs):
    """Draws over ``sample`` (1x2) or rows over ``data`` (2x1): the unsharded
    predictive, and JAX's ``sharded_predict`` on the same mesh shape."""
    inp, j = inputs
    arch = build_architecture("fc", "relu", (1, 2, 1), 2, 16)
    post = MeanFieldPosterior(worker.tree_from(inp, "svi_loc"), worker.tree_from(inp, "svi_rho"))
    plain = svi_predict(arch, post, torch.tensor(inp["pred_x"]), worker.tree_from(inp, "pred_eps"))
    x = jnp.asarray(inp["pred_x"])
    for nd, ns in ((2, 1), (1, 2)):
        m = jax_mesh(nd, ns)
        keys = jax.device_put(j["pred_keys"], jax.sharding.NamedSharding(m, jax.sharding.PartitionSpec("sample")))
        ref = jax_parallel.sharded_predict(j["arch"], m, N_DRAWS)(
            jax_parallel.replicate(j["post"], m), jax_parallel.shard_batch(x, m), keys)
        for rank in ranks:
            got = rank["predict"][f"{nd}x{ns}"]
            np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert_ranks_equal(ranks, "predict")


def test_sharded_attack_grads_match(ranks, inputs, jax_mesh21):
    inp, j = inputs
    arch = build_architecture("fc", "relu", (1, 2, 1), 2, 16)
    params = worker.tree_from(inp, "nn")
    x, labels = torch.tensor(inp["svi_x"]), torch.tensor(inp["svi_labels"])
    plain = _input_gradients(lambda xx, g: arch.apply(params, xx), x, labels, None)
    jparams = j["arch"].init(jax.random.key(9))
    ref = jax_parallel.sharded_attack_grads(lambda xx, key: j["arch"].apply(jparams, xx), jax_mesh21)(
        jax_parallel.shard_batch(jnp.asarray(inp["svi_x"]), jax_mesh21),
        jax_parallel.shard_batch(jnp.asarray(inp["svi_labels"]), jax_mesh21), jax.random.key(0))
    for rank in ranks:
        np.testing.assert_allclose(rank["attack_grads"].numpy(), plain.numpy(), atol=1e-6)
        np.testing.assert_allclose(rank["attack_grads"].numpy(), np.asarray(ref), atol=1e-5)
    assert_ranks_equal(ranks, "attack_grads")


def test_sharded_hmc_chains(ranks):
    """Two ranks of one chain each give exactly the unsharded two-chain run
    with the same per-chain seeds; the draws are N(0, 1) (JAX's statistics)."""
    def potential(q):
        return 0.5 * (q * q).sum(-1)

    cfg = HMCConfig(num_samples=200, warmup=50, step_size=0.3, num_steps=5, num_chains=2)
    draws = ChainDraws([_seeded_draws(11, "cpu"), _seeded_draws(12, "cpu")])
    plain, info = hmc_sample(potential, torch.zeros(2, 4), None, cfg, draws=draws)
    alone = [hmc_sample(potential, torch.zeros(4), seed, cfg._replace(num_chains=1)) for seed in (11, 12)]
    assert all(torch.equal(plain[c], s) for c, (s, _) in enumerate(alone))  # a chain ignores its neighbours
    for rank in ranks:
        got = rank["hmc_chains"]
        assert got["samples"].shape == (2, 200, 4)
        assert torch.equal(got["samples"], plain)
        assert all(torch.equal(a, b) for a, b in zip(got["info"][:3], info[:3]))
        assert got["info"].evaluations == sum(i.evaluations for _, i in alone)  # each rank's own chain
    draws_flat = plain.reshape(-1)
    assert abs(float(draws_flat.mean())) < 0.15 and abs(float(draws_flat.std()) - 1.0) < 0.15


def test_sharded_nuts_chains(ranks):
    """As HMC: one chain a rank equals ``nuts_sample``'s two chains run one
    after another with the same per-chain seeds."""
    cfg = NUTSConfig(num_samples=30, warmup=20, step_size=0.3, max_depth=4, num_chains=2)
    draws = [_seeded_draws(21, "cpu"), _seeded_draws(22, "cpu")]
    plain, info = nuts_sample(lambda q: 0.5 * (q * q).sum(-1), torch.zeros(2, 4), None, cfg, draws=draws)
    for rank in ranks:
        got = rank["nuts_chains"]
        assert torch.equal(got["samples"], plain)
        assert all(torch.equal(a, b) for a, b in zip(got["info"][:5], info[:5]))
        assert got["info"].evaluations == info.evaluations
    assert bool(torch.isfinite(plain).all()) and float(info.num_leapfrog.float().mean()) > 1


def _fgsm_forward(inp):
    arch = build_architecture("fc", "leaky", (1, 2, 1), 2, 16)
    post = MeanFieldPosterior(worker.tree_from(inp, "fgsm_loc"), worker.tree_from(inp, "fgsm_rho"))
    eps = worker.tree_from(inp, "fgsm_eps")
    return lambda x, generator=None: svi_predict(arch, post, x, eps)


def clear_of_zero(grads: torch.Tensor) -> torch.Tensor:
    """Pixels whose gradient sign is not rounding noise (ROADMAP Queue 3 item 5)."""
    return grads.abs() > 1e-6 * float(grads.abs().max())


def test_sharded_fgsm_matches_unsharded(ranks, inputs, jax_mesh21):
    """Mesh FGSM equals the unsharded attack, and JAX's ``sharded_fgsm`` where
    the gradient is clear of zero (the draws are JAX's in both)."""
    inp, j = inputs
    forward = _fgsm_forward(inp)
    x, labels = torch.tensor(inp["fgsm_x"]), torch.tensor(inp["fgsm_labels"])
    plain = fgsm_attack(forward, x, labels, epsilon=0.3)
    clear = clear_of_zero(_input_gradients(forward, x, labels, None))
    assert float(clear.float().mean()) > 0.9

    def pure_fn(state, xx, key):
        return jax_svi_predict(j["fgsm_arch"], state, xx, j["fgsm_keys"])

    ref = jax_parallel.sharded_fgsm(pure_fn, jax_mesh21)(
        jax_parallel.replicate(j["fgsm_post"], jax_mesh21), jax_parallel.shard_batch(jnp.asarray(inp["fgsm_x"]),
                                                                                     jax_mesh21),
        jax_parallel.shard_batch(jnp.asarray(inp["fgsm_labels"]), jax_mesh21), 0.3, jax.random.key(5))
    for rank in ranks:
        np.testing.assert_allclose(rank["fgsm"].numpy(), plain.numpy(), atol=1e-6)
        np.testing.assert_array_equal(rank["fgsm"][clear].numpy(), np.asarray(ref)[clear.numpy()])
    assert_ranks_equal(ranks, "fgsm")


def test_sharded_pgd_runs_and_stays_in_ball(ranks, inputs):
    inp, _ = inputs
    x, labels = torch.tensor(inp["fgsm_x"][:16]), torch.tensor(inp["fgsm_labels"][:16])
    plain = pgd_attack(_fgsm_forward(inp), x, labels, epsilon=0.2, alpha=2.0, iters=5)
    for rank in ranks:
        adv = rank["pgd"]
        assert float((adv - x).abs().max()) <= 0.2 + 1e-6
        assert float(adv.min()) >= 0.0 and float(adv.max()) <= 1.0
        np.testing.assert_allclose(adv.numpy(), plain.numpy(), atol=1e-6)
    assert_ranks_equal(ranks, "pgd")
