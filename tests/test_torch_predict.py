"""The port's leaf modules and posterior predictive against the JAX package's.

Config, data, batching, architectures, checkpoints, the mean-field posterior,
the unfused and fused SVI predictive and the BNN facade, at small widths, with
inputs from numpy. Deterministic paths match to f32 tolerance (1e-5 on O(1)
outputs of <= 64-term products); fresh-draw paths are compared with JAX's own
draws injected, since threefry and torch's generators differ.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustbnns_tpu import config as jax_config
from robustbnns_tpu.data import datasets as jax_datasets
from robustbnns_tpu.data.loaders import batch_arrays as jax_batch_arrays
from robustbnns_tpu.inference.svi import MeanFieldPosterior as JaxPosterior
from robustbnns_tpu.inference.svi import sample_meanfield as jax_sample_meanfield
from robustbnns_tpu.models import build_architecture as jax_build
from robustbnns_tpu.ops import svi_predict_fused as jax_svi_predict_fused
from robustbnns_tpu.predict import svi_avg_posterior_predict as jax_avg_predict
from robustbnns_tpu.predict import svi_predict as jax_svi_predict
from robustbnns_tpu.utils.checkpoint import load_pytree as jax_load_pytree
from robustbnns_tpu.utils.checkpoint import save_pytree as jax_save_pytree
from robustbnns_tpu_torch import config
from robustbnns_tpu_torch.data import datasets
from robustbnns_tpu_torch.data.loaders import batch_arrays
from robustbnns_tpu_torch.inference.svi import (
    MeanFieldPosterior,
    init_meanfield,
    sample_meanfield,
    sample_meanfield_eps,
)
from robustbnns_tpu_torch.models.architectures import build_architecture
from robustbnns_tpu_torch.models.bnn import BNN
from robustbnns_tpu_torch.ops.fused_predict import layer_seed, supports_fused, svi_predict_fused
from robustbnns_tpu_torch.predict import (
    batched_eval,
    sample_eps,
    svi_avg_posterior_predict,
    svi_predict,
)
from robustbnns_tpu_torch.utils.checkpoint import (
    load_meta,
    load_pytree,
    meanfield_from_numpy,
    save_pytree,
)
from robustbnns_tpu_torch.utils.device import resolve_device

SHAPE, CLASSES, HIDDEN = (6, 6, 1), 10, 32


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def to_torch(tree):
    return tuple({k: torch.tensor(np.asarray(v)) for k, v in layer.items()} for layer in tree)


@pytest.fixture(params=["fc", "fc2"])
def nets(request):
    """The same random parameters in both packages."""
    jarch = jax_build(request.param, "leaky", SHAPE, CLASSES, HIDDEN)
    tarch = build_architecture(request.param, "leaky", SHAPE, CLASSES, HIDDEN)
    loc = to_np(jarch.init(jax.random.key(0)))
    rng = np.random.default_rng(1)
    rho = jax.tree_util.tree_map(lambda p: (rng.normal(size=p.shape) - 3.0).astype(np.float32), loc)
    x = rng.uniform(size=(9,) + SHAPE).astype(np.float32)
    return jarch, tarch, loc, rho, x


def test_zoo_and_paths_match_jax():
    assert config.saved_BNNs.keys() == jax_config.saved_BNNs.keys()
    for k, cfg in config.saved_BNNs.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_config.saved_BNNs[k])
        assert cfg.name() == jax_config.saved_BNNs[k].name()
        assert cfg.name(100) == jax_config.saved_BNNs[k].name(100)
        assert config.bnn_batch_size(cfg) == jax_config.bnn_batch_size(jax_config.saved_BNNs[k])
    assert (config.DATA, config.TESTS) == (jax_config.DATA, jax_config.TESTS)
    for flag in ("DATA", "TESTS"):
        assert config.resolve_rel_path(flag) == jax_config.resolve_rel_path(flag)


@pytest.fixture
def fresh_surrogate_state(monkeypatch):
    """Both packages record, per process, which datasets they served
    synthetically, and tag checkpoints with it; give each test empty records
    (restored afterwards) so neither its result nor later tests depend on order.
    The generators' in-process caches are emptied too: a cached call records
    nothing."""
    for module in (datasets, jax_datasets):
        monkeypatch.setattr(module, "_surrogate_served", set())
        module._synthetic_image_dataset.cache_clear()


def test_synthetic_surrogate_is_byte_equal(monkeypatch, fresh_surrogate_state):
    monkeypatch.setenv("ROBUSTBNNS_SYNTH_CACHE", "0")
    ours = datasets._synthetic_image_dataset("mnist", 28, 28, 1, 300, 50)
    ref = jax_datasets._synthetic_image_dataset("mnist", 28, 28, 1, 300, 50)
    for a, b in zip(jax.tree_util.tree_leaves(ours), jax.tree_util.tree_leaves(ref)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert datasets.SURROGATE_VERSION == jax_datasets.SURROGATE_VERSION


def test_load_dataset_is_byte_equal(monkeypatch, tmp_path, fresh_surrogate_state):
    """Through the cross-process cache, truncated and shuffled as in the reference."""
    monkeypatch.setenv("ROBUSTBNNS_SYNTH_CACHE", str(tmp_path))
    ours = datasets.load_dataset("mnist", n_inputs=500, shuffle=True, fallback="synthetic", seed=3)
    ref = jax_datasets.load_dataset("mnist", n_inputs=500, shuffle=True, fallback="synthetic", seed=3)
    for a, b in zip(ours[:4], ref[:4]):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    assert tuple(ours[4]) == tuple(ref[4]) and ours[5] == ref[5]
    assert datasets.surrogate_fingerprint() == jax_datasets.surrogate_fingerprint()
    # What neither package serves raises alike: CIFAR-10 with no local batches
    # and no fallback, and an unknown name.
    monkeypatch.delenv("ROBUSTBNNS_DATA_FALLBACK", raising=False)
    monkeypatch.setenv("ROBUSTBNNS_CIFAR_DIR", str(tmp_path / "no_cifar"))
    monkeypatch.chdir(tmp_path)
    for module in (datasets, jax_datasets):
        with pytest.raises(FileNotFoundError):
            module.load_dataset("cifar")
        with pytest.raises(ValueError, match="not available"):
            module.load_dataset("svhn")


def test_batch_arrays_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(11, 3)).astype(np.float32)
    y = rng.normal(size=(11, 2)).astype(np.float32)
    perm = rng.permutation(11)
    ours = batch_arrays(torch.from_numpy(x), torch.from_numpy(y), 4, perm=torch.from_numpy(perm))
    ref = jax_batch_arrays(jnp.asarray(x), jnp.asarray(y), 4, perm=jnp.asarray(perm))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_architectures_give_jax_logits(nets):
    """Same parameters -> same logits: NHWC in, (h, w, c) flatten, (I, O) weights."""
    jarch, tarch, loc, _, x = nets
    ours = tarch.apply(to_torch(loc), torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jarch.apply(loc, x)), atol=1e-5)
    assert tarch.dims == tuple((p["w"].shape[0], p["w"].shape[1]) for p in loc)


def test_torch_default_init_and_rejections():
    arch = build_architecture("fc2", "leaky", (1, 28, 28), 10, 64)  # CHW accepted as HWC
    assert arch.input_shape == (28, 28, 1)
    params = arch.init(torch.Generator().manual_seed(0))
    for p, (i, o) in zip(params, arch.dims):
        assert p["w"].shape == (i, o) and p["b"].shape == (o,)
        assert float(p["w"].abs().max()) <= 1 / np.sqrt(i) and float(p["b"].abs().max()) <= 1 / np.sqrt(i)
    conv = build_architecture("conv", "leaky", (28, 28, 1), 10, 32, "mnist")  # ported since conv's slice
    assert conv.dims == ((25, 32), (800, 32), (7 * 7 * 32, 10))
    with pytest.raises(ValueError):
        build_architecture("fc", "leaky", (28, 28, 1), 10, 24)


def test_jax_checkpoint_loads_into_port_and_back(nets, tmp_path):
    """npz leaf names ``loc/0/w`` ... and the meta key interoperate both ways."""
    jarch, tarch, loc, rho, _ = nets
    jpost = JaxPosterior(loc=jax.tree_util.tree_map(jnp.asarray, loc), rho=jax.tree_util.tree_map(jnp.asarray, rho))
    path = jax_save_pytree(jpost, str(tmp_path / "jax_post"), meta={"name": "m"})
    template = tarch.init(torch.Generator().manual_seed(5))
    ours = load_pytree(MeanFieldPosterior(template, template), path)
    for a, b in zip(jax.tree_util.tree_leaves(to_np(jpost)), _leaves(ours)):
        np.testing.assert_array_equal(a, b.numpy())
    assert load_meta(path)["name"] == "m"
    with np.load(path) as z:
        assert "loc/0/w" in z and "rho/0/b" in z and "__robustbnns_meta__" in z

    back = save_pytree(ours, str(tmp_path / "torch_post"), meta={"name": "n"})
    rt = jax_load_pytree(JaxPosterior(jarch.init(jax.random.key(3)), jarch.init(jax.random.key(3))), back)
    for a, b in zip(jax.tree_util.tree_leaves(rt), _leaves(ours)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _leaves(post):
    return [layer[k] for tree in post for layer in tree for k in sorted(layer)]


def test_surrogate_version_mismatch_warns(tmp_path):
    path = save_pytree({"a": torch.zeros(2)}, str(tmp_path / "p"), meta={"surrogate_version": -1})
    with pytest.warns(UserWarning, match="surrogate"):
        load_pytree({"a": torch.zeros(2)}, path)


def test_meanfield_from_numpy(nets):
    _, _, loc, rho, _ = nets
    post = meanfield_from_numpy(loc, rho)
    assert isinstance(post, MeanFieldPosterior)
    for a, b in zip(jax.tree_util.tree_leaves((loc, rho)), _leaves(post)):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(a, b.numpy())


def test_meanfield_sampling():
    arch = build_architecture("fc", "leaky", SHAPE, CLASSES, HIDDEN)
    post = init_meanfield(torch.Generator().manual_seed(0), arch.init(torch.Generator().manual_seed(1)))
    w1 = sample_meanfield(post, torch.Generator().manual_seed(4))
    w2 = sample_meanfield(post, torch.Generator().manual_seed(4))
    assert all(torch.equal(a, b) for a, b in zip(_leaves((w1,)), _leaves((w2,))))
    zero = tuple({k: torch.zeros_like(v) for k, v in layer.items()} for layer in post.loc)
    assert all(torch.equal(a, b) for a, b in zip(_leaves((sample_meanfield_eps(post, zero),)), _leaves((post.loc,))))


def test_svi_predict_with_jax_draws_injected(nets):
    """eps = (w − loc)/softplus(rho) recovers JAX's own draws; the port's
    predictive on them equals JAX's ``svi_predict`` (1e-5: the recovered eps
    carries f32 rounding of order 1e-7 relative)."""
    jarch, tarch, loc, rho, x = nets
    jpost = JaxPosterior(loc=loc, rho=rho)
    keys = jax.random.split(jax.random.key(11), 5)
    ref = jax_svi_predict(jarch, jpost, x, keys)
    eps = [
        jax.tree_util.tree_map(lambda w, m, r: (w - m) / jax.nn.softplus(r), jax_sample_meanfield(jpost, k), loc, rho)
        for k in keys
    ]
    stacked = jax.tree_util.tree_map(lambda *e: np.stack([np.asarray(a) for a in e]), *eps)
    ours = svi_predict(tarch, meanfield_from_numpy(loc, rho), torch.from_numpy(x), eps=to_torch(stacked))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(ours.sum(-1).numpy(), 1.0, atol=1e-5)


def test_avg_posterior_predict_matches_jax(nets):
    jarch, tarch, loc, rho, x = nets
    ours = svi_avg_posterior_predict(tarch, meanfield_from_numpy(loc, rho), torch.from_numpy(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_avg_predict(jarch, JaxPosterior(loc, rho), x)), atol=1e-5)


def test_seeded_draws_follow_the_seed(nets):
    """Seed i always selects the same draw (``keys_from_seeds``' rule)."""
    _, tarch, loc, rho, x = nets
    post, xt = meanfield_from_numpy(loc, rho), torch.from_numpy(x)
    a = svi_predict(tarch, post, xt, sample_eps(post.loc, 3, seeds=[0, 1, 2]))
    b = svi_predict(tarch, post, xt, sample_eps(post.loc, 3, seeds=[0, 1, 2]))
    c = svi_predict(tarch, post, xt, sample_eps(post.loc, 3, seeds=[3, 4, 5]))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError):
        sample_eps(post.loc, 3, seeds=[0, 1])
    g = torch.Generator().manual_seed(0)
    f1 = svi_predict(tarch, post, xt, sample_eps(post.loc, 3, generator=g))
    f2 = svi_predict(tarch, post, xt, sample_eps(post.loc, 3, generator=g))
    assert not torch.equal(f1, f2)  # fresh draws per call


def test_seeded_mode_is_one_generator_per_seed():
    """Seeded noise is bit-identical to drawing each seed's tree from its own
    generator, leaf by leaf in flatten order, and stacking the draws."""
    from robustbnns_tpu_torch.utils.prng import keys_from_seeds
    from robustbnns_tpu_torch.utils.pytree import normal_like_tree

    like = build_architecture("conv2", "leaky", (16, 16, 3), 10, 16).init(torch.Generator().manual_seed(0))
    seeds = [4, 0, 9]
    got = sample_eps(like, 3, seeds=seeds)
    per_seed = [normal_like_tree(g, like) for g in keys_from_seeds(seeds)]
    for li, layer in enumerate(got):
        for k, v in layer.items():
            assert torch.equal(v, torch.stack([d[li][k] for d in per_seed]))


def test_fresh_draws_are_one_generator_per_call():
    """Fresh draws: the same CPU generator state repeats them, successive calls
    differ, and the pooled draws are N(0, 1) within sampling error (86k
    normals: 5 standard errors are 0.017 for the mean and 0.012 for the std)."""
    like = build_architecture("conv", "leaky", (28, 28, 1), 10, 16, "mnist").init(torch.Generator().manual_seed(0))
    a = sample_eps(like, 4, generator=torch.Generator().manual_seed(3))
    b = sample_eps(like, 4, generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    first, second = sample_eps(like, 4, generator=g), sample_eps(like, 4, generator=g)
    flat = lambda t: torch.cat([v.reshape(-1) for layer in t for v in layer.values()])  # noqa: E731
    assert torch.equal(flat(a), flat(b)) and torch.equal(flat(a), flat(first))
    assert not torch.equal(flat(first), flat(second))
    assert all(v.shape[0] == 4 for layer in a for v in layer.values())
    pooled = flat(a)
    assert abs(float(pooled.mean())) < 0.02 and abs(float(pooled.std()) - 1.0) < 0.014
    assert not torch.equal(a[0]["w"][0], a[0]["w"][1])  # the draws of one call differ


def test_batched_eval_pads_and_masks(nets):
    _, tarch, loc, _, x = nets
    xt = torch.from_numpy(x)
    y = torch.nn.functional.one_hot(torch.arange(len(x)) % CLASSES, CLASSES).float()

    def fn(xb, generator=None):
        return tarch.apply(to_torch(loc), xb)

    outs, correct = batched_eval(fn, xt, y, batch_size=4)
    full = fn(xt)
    np.testing.assert_allclose(outs.numpy(), full.numpy(), atol=1e-6)
    assert int(correct) == int((full.argmax(-1) == y.argmax(-1)).sum())


def test_fused_predictive_zero_scale_matches_jax(nets):
    """With scale -> 0 the fused predictive equals JAX's fused predictive and the
    deterministic network (JAX's Pallas kernels in interpret mode)."""
    jarch, tarch, loc, _, x = nets
    neg = jax.tree_util.tree_map(lambda p: np.full_like(p, -30.0), loc)
    ours = svi_predict_fused(tarch, meanfield_from_numpy(loc, neg), torch.from_numpy(x), 4, seed=17)
    ref = jax_svi_predict_fused(jarch, JaxPosterior(loc, neg), x, 4, 17)
    det = jax.nn.softmax(jarch.apply(loc, x), -1)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(det), atol=1e-5)
    assert supports_fused(tarch)


def test_layer_seeds_wrap_like_int32():
    """JAX adds the 1000003 stride to an int32 seed, which wraps; the bits match."""
    for seed in (0, 5, 2**31 - 2):
        for li in range(3):
            wrapped = np.asarray(jnp.asarray(seed, jnp.int32) + li * 1000003).astype(np.uint32)
            assert layer_seed(seed, li) == int(wrapped)


def test_bnn_save_load_predict(tmp_path):
    """The facade on the CPU: JAX's checkpoint path, a seeded evaluation that
    repeats, memoized closures, and no fused seeded mode."""
    cfg = config.BNNConfig("mnist", 32, "leaky", "fc2", "svi", epochs=1, lr=0.1)
    bnn = BNN.from_config(cfg, (6, 6, 1), 10, device="cpu")
    bnn.posterior = init_meanfield(torch.Generator().manual_seed(0), bnn.arch.init(torch.Generator().manual_seed(1)))
    path = bnn.save(rel_path=str(tmp_path))
    assert path == str(tmp_path / cfg.name() / (cfg.name() + "_weights.npz"))
    other = BNN.from_config(cfg, (6, 6, 1), 10, device="cpu").load(rel_path=str(tmp_path))
    assert all(torch.equal(a, b) for a, b in zip(_leaves(bnn.posterior), _leaves(other.posterior)))

    rng = np.random.default_rng(0)
    x = rng.uniform(size=(20, 6, 6, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 20)]
    assert other.evaluate(x, y, verbose=False) == other.evaluate(x, y, verbose=False)
    assert other.predictive_fn(5, seeds=range(5)) is other.predictive_fn(5, seeds=range(5))
    assert other.predictive_fn(5, fused=True) is other.predictive_fn(5, fused=True)
    with pytest.raises(ValueError):
        other.predictive_fn(5, seeds=range(5), fused=True)
    probs = other.forward(torch.from_numpy(x), 4, seeds=[0, 1, 2, 3])
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
    from torch_mesh_worker import one_rank_mesh

    trained = BNN.from_config(cfg, (6, 6, 1), 10, device="cpu").train(x, y, batch_size=8, verbose=False)
    with one_rank_mesh() as mesh:  # SVI trains under a mesh: one rank changes no bit
        meshed = BNN.from_config(cfg, (6, 6, 1), 10, device="cpu").train(x, y, batch_size=8, mesh=mesh,
                                                                       verbose=False)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(trained.posterior), _leaves(meshed.posterior)))


def test_cuda_requests_without_a_card_raise():
    """Entry points run on cuda by default and never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    cfg = config.saved_BNNs["model_7"]
    with pytest.raises(RuntimeError, match="cuda"):
        BNN.from_config(cfg, (28, 28, 1), 10)
    assert resolve_device("cpu") == torch.device("cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert resolve_device("cpu").type == "cpu"
