"""HMC posteriors through the port's BNN, predictive, attacks, loss gradients,
checkpoints and CLIs, against the JAX package's.

* a tiny HMC BNN trained by JAX (fc-16 on 64 points) carried across with
  ``hmc_samples_from_numpy``: ``forward``, ``evaluate`` and ``predictive_fn``
  within 1e-6, the expected loss gradients within 1e-5·max, FGSM and 3-step
  PGD giving JAX's adversarial sets, checkpoints bit-equal both ways, and
  out-of-range seeds refused on the host;
* ``BNN.train`` against JAX's with JAX's init and draws replayed (margins
  asserted, as in ``tests/test_torch_hmc.py``);
* the CLIs on the CPU at ``model_9``'s widths (fc-512, Fashion-MNIST) on 64
  surrogate images, the zoo entry's draws and warmup cut (the checkpoint
  name shows the cut).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_hmc import CLASSES, SHAPE, Replay, assert_margins, jax_chain_draws

from robustbnns_tpu.analysis import expected_loss_gradients as jax_expected_loss_gradients
from robustbnns_tpu.attacks.gradient_attacks import fgsm_attack as jax_fgsm
from robustbnns_tpu.attacks.gradient_attacks import pgd_attack as jax_pgd
from robustbnns_tpu.config import BNNConfig as JaxBNNConfig
from robustbnns_tpu.models import BNN as JaxBNN
from robustbnns_tpu.utils.pytree import flatten_tree_to_vector as jax_flatten
from robustbnns_tpu_torch import config
from robustbnns_tpu_torch.analysis import expected_loss_gradients
from robustbnns_tpu_torch.attacks.gradient_attacks import fgsm_attack, pgd_attack
from robustbnns_tpu_torch.inference import hmc
from robustbnns_tpu_torch.models.bnn import BNN
from robustbnns_tpu_torch.utils.checkpoint import hmc_samples_from_numpy
from robustbnns_tpu_torch.utils.pytree import tree_leaves

CFG = config.BNNConfig("mnist", 16, "leaky", "fc", "hmc", n_samples=6, warmup=4, step_size=0.05, num_steps=3)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n,) + SHAPE).astype(np.float32)
    return x, np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, n)]


def close(got, want, of_max):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=of_max * np.abs(want).max())


@pytest.fixture(scope="module")
def both():
    """A JAX-trained HMC fc-16 (6 draws) and the port's BNN on its samples."""
    x, y = data()
    ref = JaxBNN.from_config(JaxBNNConfig(**dataclasses.asdict(CFG)), SHAPE, CLASSES)
    ref.train(x, y, batch_size=64, verbose=False)
    ours = BNN.from_config(CFG, SHAPE, CLASSES, device="cpu")
    ours.samples = hmc_samples_from_numpy(to_np(ref.samples))
    xt, yt = data(16, seed=1)
    return ref, ours, xt, yt


def test_samples_cross_as_a_tree_or_a_flat_array(both):
    ref, ours, _, _ = both
    flat = np.stack([np.asarray(jax_flatten(jax.tree_util.tree_map(lambda v: v[s], ref.samples))[0])
                     for s in range(CFG.n_samples)])
    like = ours.arch.init(torch.Generator().manual_seed(0))
    for a, b in zip(tree_leaves(hmc_samples_from_numpy(flat, like=like)), tree_leaves(ours.samples), strict=True):
        assert torch.equal(a, b) and a.is_contiguous()
    assert ours.samples[0]["w"].shape == (CFG.n_samples,) + tuple(like[0]["w"].shape)


def test_forward_evaluate_and_predictive_match_jax(both):
    """Seeded draws (default ``range(n)`` and given seeds), ``avg_posterior``
    ignored, the memoized closure, and the accuracy."""
    ref, ours, x, y = both
    tx = torch.from_numpy(x)
    for kw in ({"n_samples": 4}, {"n_samples": 3, "seeds": [5, 0, 2]}, {"n_samples": 4, "avg_posterior": True}):
        close(ours.forward(tx, **kw), ref.forward(x, **kw), 1e-6)
    fn = ours.predictive_fn(n_samples=4)
    assert fn is ours.predictive_fn(n_samples=4) is ours.predictive_fn(n_samples=4, seeds=range(4))
    close(fn(tx), ref.predictive_fn(n_samples=4)(x), 1e-6)
    close(ours.predictive_fn(n_samples=6, avg_posterior=True)(tx), ref.forward(x, n_samples=6), 1e-6)
    assert ours.evaluate(x, y, n_samples=5, batch_size=8, verbose=False) == ref.evaluate(
        x, y, n_samples=5, batch_size=8, verbose=False)
    with pytest.raises(ValueError, match="fused"):
        ours.predictive_fn(n_samples=4, fused=True)


def test_expected_loss_gradients_match_jax(both):
    ref, ours, x, y = both
    want = jax_expected_loss_gradients(ref, x, y, n_samples=5, batch_size=8)
    got = expected_loss_gradients(ours, x, y, n_samples=5, batch_size=8)
    assert got.shape == x.shape
    close(got, want, 1e-5)
    close(expected_loss_gradients(ours, x, y, n_samples=2, seeds=[4, 1]),
          jax_expected_loss_gradients(ref, x, y, n_samples=2, seeds=[4, 1]), 1e-5)
    with pytest.raises(ValueError, match="eps"):
        expected_loss_gradients(ours, x, y, n_samples=2, eps=ours.samples)


def test_fgsm_and_pgd_give_jax_adversarial_sets(both):
    """FGSM and 3-step PGD on the 4-draw predictive move the same pixels to
    the same values (rounding of the final clip aside)."""
    ref, ours, x, y = both
    fn, jfn = ours.predictive_fn(n_samples=4), ref.predictive_fn(n_samples=4)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for got, want in ((fgsm_attack(fn, tx, ty, epsilon=0.3), jax_fgsm(jfn, x, y, epsilon=0.3)),
                      (pgd_attack(fn, tx, ty, epsilon=0.3, iters=3), jax_pgd(jfn, x, y, epsilon=0.3, iters=3))):
        want = np.asarray(want)
        np.testing.assert_array_equal(got.numpy() != x, want != x)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("saved_by", ["port", "jax"])
def test_checkpoints_cross_bit_equal(tmp_path, both, saved_by):
    """The stacked draws under JAX's leaf names ``0/b``, ``0/w``, ... load
    bit-equal in the other package."""
    ref, ours, _, _ = both
    rel = str(tmp_path) + "/"
    (ours if saved_by == "port" else ref).save(rel_path=rel)
    if saved_by == "port":
        loaded = JaxBNN.from_config(JaxBNNConfig(**dataclasses.asdict(CFG)), SHAPE, CLASSES).load(rel_path=rel)
        pairs = zip(jax.tree_util.tree_leaves(loaded.samples), tree_leaves(ours.samples), strict=True)
    else:
        loaded = BNN.from_config(CFG, SHAPE, CLASSES, device="cpu").load(rel_path=rel)
        pairs = zip(tree_leaves(loaded.samples), jax.tree_util.tree_leaves(ref.samples), strict=True)
    for a, b in pairs:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_out_of_range_seeds_raise_before_indexing(both):
    """JAX clamps an index past the last draw; the reference and the port
    raise (on the card a bad index would poison the context)."""
    _, ours, x, y = both
    tx = torch.from_numpy(x)
    with pytest.raises(IndexError, match="out of range"):
        ours.forward(tx, n_samples=2, seeds=[0, 6])
    with pytest.raises(IndexError):
        ours.predictive_fn(n_samples=1, seeds=[-7])
    with pytest.raises(IndexError):
        expected_loss_gradients(ours, x, y, n_samples=7)
    with pytest.raises(ValueError, match="seeds"):
        ours.forward(tx, n_samples=2, seeds=[0])
    assert torch.equal(ours.forward(tx, n_samples=1, seeds=[-1]), ours.forward(tx, n_samples=1, seeds=[5]))


TRAIN_CFG = config.BNNConfig("mnist", 16, "leaky", "fc", "hmc", n_samples=5, warmup=8, step_size=0.05, num_steps=4)


def test_bnn_train_matches_jax_with_its_init_and_draws_replayed():
    """``BNN.train`` (faithful, two batches of 32, the labels from one-hot)
    from JAX's ``arch.init(key(seed))`` with the draws of ``key(seed)``
    replayed: the stacked samples within 1e-4·max of JAX's (1.1e-5 seen),
    under the margin precondition; the history has one entry per batch. Seeds
    1, 2, 4 and 23 fail the precondition (a decision within 1e-3 of its
    threshold), which is what it is for."""
    seed = 0
    x, y = data(64, seed=3)
    ref = JaxBNN.from_config(JaxBNNConfig(**dataclasses.asdict(TRAIN_CFG)), SHAPE, CLASSES)
    ref.train(x, y, batch_size=32, seed=seed, verbose=False)
    init = to_np(ref.arch.init(jax.random.key(seed)))
    d = int(jax_flatten(init)[0].shape[0])
    run_cfg = hmc.HMCConfig(num_samples=5 // 2 + 1, warmup=8, step_size=0.05, num_steps=4)
    key = jax.random.key(seed)
    search, momentum, uniform = [], [], []
    for _ in range(2):
        key, k_run = jax.random.split(key)
        for acc, more in zip((search, momentum, uniform), jax_chain_draws(k_run, d, run_cfg)):
            acc.extend(more)
    key, k_idx = jax.random.split(key)
    idx = np.asarray(jax.random.randint(k_idx, (5,), 0, run_cfg.num_samples))

    ours = BNN.from_config(TRAIN_CFG, SHAPE, CLASSES, device="cpu")
    trace = []
    draws = Replay(search, momentum, uniform, idx)
    original = hmc.hmc_train_batched
    with pytest.MonkeyPatch.context() as mp:  # record the margins of the run
        mp.setattr("robustbnns_tpu_torch.models.bnn.hmc_train_batched",
                   lambda *a, **kw: original(*a, trace=trace, **kw))
        ours.train(x, y, batch_size=32, seed=seed, verbose=False, draws=draws,
                   init=tuple({k: torch.from_numpy(v) for k, v in layer.items()} for layer in init))
    assert_margins(trace)
    for got, want in zip(tree_leaves(ours.samples), jax.tree_util.tree_leaves(ref.samples), strict=True):
        assert got.shape == want.shape
        close(got, want, 1e-4)
    assert len(ours.history["accept"]) == 2 and ours.history["evaluations"][0] > (8 + 3) * 5
    np.testing.assert_allclose(float(ours.hmc_info.step_size), float(ref.hmc_info.step_size), rtol=1e-4)


def test_svi_bnn_ignores_the_hmc_flags():
    """As JAX's ``train``: an SVI model given HMC flags trains as without them."""
    cfg = config.BNNConfig("mnist", 16, "leaky", "fc", "svi", epochs=1, lr=0.01)
    x, y = data(64)
    runs = [BNN.from_config(cfg, SHAPE, CLASSES, device="cpu").train(x, y, batch_size=32, verbose=False, **kw)
            for kw in ({}, {"hmc_sampler": "nuts", "hmc_mode": "full", "num_chains": 3, "hmc_init": "map"})]
    for a, b in zip(*(tree_leaves(r.posterior.loc) + tree_leaves(r.posterior.rho) for r in runs), strict=True):
        assert torch.equal(a, b)


@pytest.fixture
def hmc_zoo(monkeypatch, tmp_path):
    """model_9's widths with 10 draws and a warmup of 4, checkpoints and the
    surrogate under ``tmp_path``, fresh surrogate records."""
    from robustbnns_tpu_torch.data import datasets

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ROBUSTBNNS_SYNTH_CACHE", str(tmp_path / "synthetic"))
    monkeypatch.setattr(config, "DATA", str(tmp_path / "data") + "/")
    monkeypatch.setattr(datasets, "_surrogate_served", set())
    datasets._synthetic_image_dataset.cache_clear()
    cut = dataclasses.replace(config.saved_BNNs["model_9"], n_samples=10, warmup=4)
    monkeypatch.setitem(config.saved_BNNs, "model_9", cut)
    yield cut
    datasets._synthetic_image_dataset.cache_clear()


def test_clis_train_attack_and_take_loss_gradients_of_an_hmc_model(hmc_zoo, monkeypatch):
    """``cli.train_bnn`` trains model_9 (fc-512) by HMC on 64 surrogate images
    and reloads it bit-equal; ``cli.attacks --model_type=bnn`` attacks it
    without launching a sampled-dense kernel; ``cli.loss_gradients`` runs on
    it (the S list cut to the 10 draws); ``--hmc_sampler=nuts`` then trains
    it by NUTS, whose draws save and reload under the same names."""
    import importlib

    from robustbnns_tpu_torch.cli import attacks, loss_gradients, train_bnn

    flags = ["--model_idx=9", "--n_inputs=64", "--savedir=DATA", "--device=cpu"]
    bnn = train_bnn.main(flags + ["--train=True", "--test=True"])
    assert "_samp=10_warm=4_" in bnn.name
    assert bnn.samples[0]["w"].shape == (10, 784, 512) and len(bnn.history["accept"]) == 1
    assert all(bool(torch.isfinite(v).all()) for v in tree_leaves(bnn.samples))
    loaded = train_bnn.main(flags + ["--train=False", "--test=False"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(loaded.samples), tree_leaves(bnn.samples)))

    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    sd.reset_launch_counts()
    load = attacks.load_data
    monkeypatch.setattr(attacks, "load_data", lambda ds, n, shuffle=True: load(ds, 64, shuffle))
    out = attacks.main(["--model_type=bnn", "--model_idx=9", "--train=False", "--test=True", "--n_inputs=8",
                        "--device=cpu", "--attack_method=pgd"])
    x, xa = torch.as_tensor(out["x_test"]), out["x_attack"]
    assert xa.shape == (8, 28, 28, 1) and float((xa - x).abs().max()) <= 0.3 + 1e-6
    assert 0 <= float(xa.min()) and float(xa.max()) <= 1 and not any(sd.launch_counts().values())
    assert 0.0 <= out["adversarial_accuracy"] <= 100.0

    monkeypatch.setattr(loss_gradients, "POSTERIOR_SAMPLES_LIST", [1, 5, 10])
    grads = loss_gradients.main(["--model_idx=9", "--n_inputs=5", "--savedir=DATA", "--device=cpu"])
    assert sorted(grads) == [1, 5, 10]
    for g in grads.values():
        assert g.shape == (5, 28, 28) and np.isfinite(g).all()

    from robustbnns_tpu_torch.inference.nuts import NUTSInfo

    nuts_bnn = train_bnn.main(flags + ["--train=True", "--test=False", "--hmc_sampler=nuts"])
    h = nuts_bnn.history
    assert isinstance(nuts_bnn.hmc_info, NUTSInfo) and nuts_bnn.samples[0]["w"].shape == (10, 784, 512)
    assert all(bool(torch.isfinite(v).all()) for v in tree_leaves(nuts_bnn.samples))
    assert h["evaluations"][0] >= 11 * 2 + 4 and h["leaves"][0] >= 1 and 0 <= h["divergences"][0] <= 11
    loaded = train_bnn.main(flags + ["--train=False", "--test=False"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(loaded.samples), tree_leaves(nuts_bnn.samples)))
