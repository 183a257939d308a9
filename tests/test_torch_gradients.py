"""The port's expected loss gradients (``analysis/gradients.py``) against the
JAX package's, and the SVI cases of ``tests/test_gradients.py`` on the port.

* ``expected_loss_gradients`` and ``_per_sample_input_grads`` on fc2 and conv
  posteriors equal JAX's with JAX's seeded draws injected (f32 parity at 1e-5
  of the largest entry: the port sums the S draws' losses before one backward,
  JAX averages S gradients);
* the file names, the save/load round trip and ``compute_vanishing_norms_idxs``
  equal JAX's;
* the HMC, deterministic (NN) and ensemble branches equal JAX's on the same
  parameters; meshes raise;
* ``cli.loss_gradients`` runs ``model_0`` at full width on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustbnns_tpu.analysis import compute_vanishing_norms_idxs as jax_vanishing
from robustbnns_tpu.analysis import expected_loss_gradients as jax_expected_loss_gradients
from robustbnns_tpu.analysis import gradients as jax_gradients
from robustbnns_tpu.analysis import load_loss_gradients as jax_load_loss_gradients
from robustbnns_tpu.config import BNNConfig as JaxBNNConfig
from robustbnns_tpu.inference.svi import MeanFieldPosterior as JaxPosterior
from robustbnns_tpu.inference.svi import sample_meanfield as jax_sample_meanfield
from robustbnns_tpu.models import BNN as JaxBNN
from robustbnns_tpu.utils.prng import keys_from_seeds as jax_keys_from_seeds
from robustbnns_tpu.utils.pytree import normal_like_tree as jax_normal_like_tree
from robustbnns_tpu_torch import config
from robustbnns_tpu_torch.analysis import (
    compute_vanishing_norms_idxs,
    expected_loss_gradients,
    load_loss_gradients,
    loss_gradients,
)
from robustbnns_tpu_torch.analysis.gradients import _grads_path, _per_sample_input_grads
from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior, sample_meanfield_eps
from robustbnns_tpu_torch.models.bnn import BNN
from robustbnns_tpu_torch.utils.checkpoint import meanfield_from_numpy

CLASSES = 10
NETS = {"fc2": (6, 6, 1), "conv": (28, 28, 1)}


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, of_max=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=of_max * np.abs(want).max())


def both_models(name):
    """The same posterior (init loc, rho ~ N(-3, 0.3)) in both packages, and a batch."""
    cfg = config.BNNConfig("mnist", 16, "leaky", name, "svi", epochs=1, lr=0.01)
    shape = NETS[name]
    ref = JaxBNN.from_config(JaxBNNConfig(**dataclasses.asdict(cfg)), shape, CLASSES)
    rng = np.random.default_rng(0)
    loc = to_np(ref.arch.init(jax.random.key(0)))
    rho = jax.tree_util.tree_map(lambda p: (rng.normal(size=p.shape) * 0.3 - 3.0).astype(np.float32), loc)
    ref.posterior = JaxPosterior(jax.tree_util.tree_map(jnp.asarray, loc), jax.tree_util.tree_map(jnp.asarray, rho))
    ours = BNN.from_config(cfg, shape, CLASSES, device="cpu")
    ours.posterior = meanfield_from_numpy(loc, rho)
    x = rng.uniform(size=(8,) + shape).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, 8)]
    return ref, ours, loc, x, y


def jax_seeded_eps(loc, seeds):
    """JAX's draws for ``keys_from_seeds(seeds)`` as a stacked torch noise tree."""
    draws = [jax_normal_like_tree(k, loc) for k in jax_keys_from_seeds(list(seeds))]
    return tuple({k: torch.tensor(np.stack([np.asarray(d[li][k]) for d in draws])) for k in loc[li]}
                 for li in range(len(loc)))


@pytest.mark.parametrize("name", ["fc2", "conv"])
def test_expected_loss_gradients_match_jax(name):
    """Seeds 0..3 in JAX, the same draws injected into the port, two batches
    of 4: the same mean input gradient; and on the first batch the per-draw
    gradients equal JAX's ``_per_sample_input_grads`` (one JAX compile)."""
    ref, ours, loc, x, y = both_models(name)
    want = jax_expected_loss_gradients(ref, x, y, n_samples=4, batch_size=4)
    eps = jax_seeded_eps(loc, range(4))
    got = expected_loss_gradients(ours, x, y, n_samples=4, batch_size=4, eps=eps)
    assert got.shape == x.shape
    close(got, want)

    stacked = jax.vmap(lambda k: jax_sample_meanfield(ref.posterior, k))(jax_keys_from_seeds([0, 1, 2, 3]))
    x4, labels = x[:4], y[:4].argmax(-1)
    want_each = jax_gradients._per_sample_input_grads(ref.arch.apply, stacked, jnp.asarray(x4), jnp.asarray(labels))
    got_each = _per_sample_input_grads(ours.arch.apply, sample_meanfield_eps(ours.posterior, eps),
                                       torch.from_numpy(x4), torch.from_numpy(labels))
    close(got_each, want_each)
    close(got_each.mean(0), got[:4])


@pytest.fixture(scope="module")
def trained_svi_bnn():
    """The JAX tests' fixture on the port: an SVI ``fc``-16 trained for 5
    epochs on 1000 rows of two noisy 2-D classes (the port has no Half Moons
    yet), and 64 test rows."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 2, 1064)
    x = (rng.normal(size=(1064, 1, 2, 1)) * 0.5 + np.where(labels, 1.0, -1.0)[:, None, None, None]).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[labels]
    cfg = config.BNNConfig("half_moons", 16, "leaky", "fc", "svi", epochs=5, lr=0.01)
    bnn = BNN.from_config(cfg, (1, 2, 1), 2, device="cpu")
    bnn.train(x[:1000], y[:1000], batch_size=64, train_acc_samples=0, verbose=False)
    return bnn, x[1000:], y[1000:]


def test_expected_gradients_shape_and_finiteness(trained_svi_bnn):
    bnn, x, y = trained_svi_bnn
    grads = expected_loss_gradients(bnn, x, y, n_samples=10)
    assert grads.shape == x.shape and bool(torch.isfinite(grads).all())


def test_expected_gradients_deterministic_given_seeds(trained_svi_bnn):
    """Fixed seeds 0..S-1 by default: repeated calls agree exactly, other seeds differ."""
    bnn, x, y = trained_svi_bnn
    g1 = expected_loss_gradients(bnn, x, y, n_samples=5)
    assert torch.equal(g1, expected_loss_gradients(bnn, x, y, n_samples=5))
    assert torch.equal(g1, expected_loss_gradients(bnn, x, y, n_samples=5, seeds=range(5)))
    assert not torch.equal(g1, expected_loss_gradients(bnn, x, y, n_samples=5, seeds=[7, 8, 9, 10, 11]))


def test_expected_gradients_match_manual_average(trained_svi_bnn):
    """The one-backward mean over S seeds equals the mean of per-seed gradients."""
    bnn, x, y = trained_svi_bnn
    per_seed = [expected_loss_gradients(bnn, x, y, n_samples=1, seeds=[s]).numpy() for s in range(4)]
    close(expected_loss_gradients(bnn, x, y, n_samples=4), np.mean(per_seed, axis=0))


def test_loss_gradients_save_load_roundtrip(tmp_path, trained_svi_bnn):
    """The port's file is JAX's name and loads in both packages; the result is
    squeezed ((N, 1, 2, 1) -> (N, 2))."""
    bnn, x, y = trained_svi_bnn
    rel = str(tmp_path) + "/"
    out = loss_gradients(bnn, x, y, n_samples=3, filename="unit", savedir="unit_dir", rel_path=rel, verbose=False)
    assert out.shape == (64, 2)
    assert _grads_path(3, "unit", "unit_dir", rel) == jax_gradients._grads_path(3, "unit", "unit_dir", rel)
    np.testing.assert_array_equal(out, load_loss_gradients(3, "unit", "unit_dir", rel))
    np.testing.assert_array_equal(out, jax_load_loss_gradients(3, "unit", "unit_dir", rel))


def test_vanishing_norms_detection():
    """Monotone non-increasing norms -> vanishing; else increasing; zero -> null;
    and JAX's indices on random norms with ties and zeros."""
    g = np.zeros((3, 3, 2, 2), np.float32)
    for j, v in enumerate([3, 2, 1]):
        g[0, j, 0, 0] = v
    for j, v in enumerate([1, 2, 3]):
        g[1, j, 0, 0] = v
    for norm in ("linfty", "l2"):
        assert compute_vanishing_norms_idxs(g, [1, 10, 100], norm=norm, verbose=False) == [0]
    rng = np.random.default_rng(1)
    r = np.round(rng.uniform(size=(40, 4, 3, 3)), 1).astype(np.float32)
    r[::7] = 0.0
    for norm in ("linfty", "l2"):
        assert (compute_vanishing_norms_idxs(r, [1, 10, 50, 100], norm=norm, verbose=False)
                == jax_vanishing(r, [1, 10, 50, 100], norm=norm, verbose=False))


def test_vanishing_norms_shape_guard():
    with pytest.raises(ValueError, match="Second dimension"):
        compute_vanishing_norms_idxs(np.zeros((2, 3, 4)), [1, 10], verbose=False)
    with pytest.raises(ValueError, match="norm"):
        compute_vanishing_norms_idxs(np.zeros((2, 2, 4)), [1, 10], norm="l1", verbose=False)


def test_branches_of_later_slices_raise(trained_svi_bnn):
    """Every branch of a later slice is ported (the name is from when they
    raised). A one-rank mesh gives the unmeshed gradients bit for bit
    (``tests/test_torch_mesh_api.py`` holds two ranks). The HMC,
    deterministic and ensemble branches compute JAX's gradients on the same
    parameters: the stacked draws or members indexed by the seeds, and for an
    NN (``n_samples=None``) the gradient of the CE of its raw logits."""
    from robustbnns_tpu.models import DeterministicNN as JaxNN
    from robustbnns_tpu.models import EnsembleNN as JaxEnsemble
    from robustbnns_tpu_torch.models import DeterministicNN, EnsembleNN
    from robustbnns_tpu_torch.utils.checkpoint import params_from_numpy

    from torch_mesh_worker import one_rank_mesh

    bnn, x, y = trained_svi_bnn
    with one_rank_mesh() as mesh:
        meshed = expected_loss_gradients(bnn, x, y, n_samples=2, mesh=mesh)
    assert torch.equal(meshed, expected_loss_gradients(bnn, x, y, n_samples=2))

    from robustbnns_tpu_torch.utils.checkpoint import hmc_samples_from_numpy

    hmc_cfg = config.BNNConfig("mnist", 16, "leaky", "fc2", "hmc", n_samples=5, warmup=1)
    ref = JaxBNN.from_config(JaxBNNConfig(**dataclasses.asdict(hmc_cfg)), NETS["fc2"], CLASSES)
    rng = np.random.default_rng(3)
    ref.samples = jax.tree_util.tree_map(
        lambda p: (rng.normal(size=(5,) + p.shape) * 0.5).astype(np.float32), to_np(ref.arch.init(jax.random.key(0))))
    ours = BNN.from_config(hmc_cfg, NETS["fc2"], CLASSES, device="cpu")
    ours.samples = hmc_samples_from_numpy(ref.samples)
    xh = rng.uniform(size=(6,) + NETS["fc2"]).astype(np.float32)
    yh = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, 6)]
    for kw in ({"n_samples": 5}, {"n_samples": 2, "seeds": [3, 0]}):
        close(expected_loss_gradients(ours, xh, yh, batch_size=4, **kw),
              jax_expected_loss_gradients(ref, xh, yh, batch_size=4, **kw))

    params = to_np(ref.arch.init(jax.random.key(4)))
    nn_ref, nn = JaxNN(arch=ref.arch, params=params), DeterministicNN(ours.arch, params_from_numpy(params))
    close(expected_loss_gradients(nn, xh, yh, n_samples=None, batch_size=4),
          jax_expected_loss_gradients(nn_ref, xh, yh, n_samples=None, batch_size=4))
    members = ref.samples  # five stacked parameter sets serve as five members
    ens_ref = JaxEnsemble(arch=ref.arch, stacked_params=members, ensemble_size=5)
    ens = EnsembleNN(ours.arch, params_from_numpy(members), 5)
    for kw in ({"n_samples": 5}, {"n_samples": 2, "seeds": [3, 0]}):
        close(expected_loss_gradients(ens, xh, yh, batch_size=4, **kw),
              jax_expected_loss_gradients(ens_ref, xh, yh, batch_size=4, **kw))
    with pytest.raises(IndexError, match="out of range"):
        expected_loss_gradients(ens, xh, yh, n_samples=1, seeds=[5])
    unloaded = BNN.from_config(bnn.config, (1, 2, 1), 2, device="cpu")
    with pytest.raises(ValueError, match="load"):
        expected_loss_gradients(unloaded, x, y, n_samples=2)
    with pytest.raises(ValueError, match="seeds"):
        expected_loss_gradients(bnn, x, y, n_samples=2, seeds=[0])


def test_loss_gradients_cli_runs_model_0_on_the_cpu(monkeypatch, tmp_path):
    """``cli.loss_gradients`` on a saved full-width ``model_0`` posterior and 3
    test images: S = 1, 10, 50, 100, one file each, finite arrays of the
    squeezed input shape, whose norms ``compute_vanishing_norms_idxs`` sorts."""
    from robustbnns_tpu_torch.cli import loss_gradients as cli
    from robustbnns_tpu_torch.data import datasets

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ROBUSTBNNS_SYNTH_CACHE", str(tmp_path / "synthetic"))
    monkeypatch.setattr(config, "DATA", str(tmp_path / "data") + "/")
    monkeypatch.setattr(datasets, "_surrogate_served", set())
    datasets._synthetic_image_dataset.cache_clear()
    bnn = BNN.from_config(config.saved_BNNs["model_0"], (28, 28, 1), CLASSES, device="cpu")
    loc = bnn.arch.init(torch.Generator().manual_seed(0))
    bnn.posterior = MeanFieldPosterior(loc, tuple({k: torch.full_like(v, -5.0) for k, v in p.items()} for p in loc))
    bnn.save(rel_path=config.DATA)

    out = cli.main(["--model_idx=0", "--n_inputs=3", "--savedir=DATA", "--device=cpu"])
    assert sorted(out) == [1, 10, 50, 100]
    for n, g in out.items():
        assert g.shape == (3, 28, 28) and np.isfinite(g).all() and np.abs(g).max() > 0
        np.testing.assert_array_equal(g, load_loss_gradients(n, bnn.name, bnn.name, config.DATA))
    stacked = np.stack([out[n] for n in (1, 10, 50, 100)], axis=1)
    idxs = compute_vanishing_norms_idxs(stacked, [1, 10, 50, 100], verbose=False)
    assert idxs == jax_vanishing(stacked, [1, 10, 50, 100], verbose=False)
