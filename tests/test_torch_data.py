"""The port's datasets, per-class subsets, the epoch iterator, host
partitioning and image grids (``data/datasets.py``, ``data/loaders.py``,
``parallel/distributed.py``, ``utils/plotting.py``) against the JAX package's
and sklearn's, on the CPU.

Every comparison is exact: the arrays are numpy's on both sides, so they
must be equal byte for byte (``make_moons`` against sklearn's included), and
the partitions and the errors raised the same.
"""
import os
import pickle

import numpy as np
import pytest
from sklearn.datasets import make_moons as sk_make_moons

from robustbnns_tpu.data import datasets as jax_datasets
import jax
import jax.numpy as jnp
import torch

import robustbnns_tpu.data as jax_data
import robustbnns_tpu_torch.data as data
from robustbnns_tpu.data.loaders import Batches as JaxBatches
from robustbnns_tpu.data.loaders import classwise_arrays as jax_classwise_arrays
from robustbnns_tpu.parallel import distributed as jax_distributed
from robustbnns_tpu.utils import plotting as jax_plotting
from robustbnns_tpu_torch.data import datasets
from robustbnns_tpu_torch.data.loaders import Batches, classwise_arrays
from robustbnns_tpu_torch.parallel import distributed
from robustbnns_tpu_torch.utils import plotting


@pytest.fixture
def fresh_surrogate_state(monkeypatch):
    """Empty both packages' records of served surrogates and their in-process
    caches for the test, restored after it, so the test adds no dependence
    on the order the suite runs in (a served surrogate tags later saves)."""
    for module in (datasets, jax_datasets):
        monkeypatch.setattr(module, "_surrogate_served", set())
        module._synthetic_image_dataset.cache_clear()
    yield
    for module in (datasets, jax_datasets):
        module._synthetic_image_dataset.cache_clear()


def assert_bytes_equal(ours, ref):
    for a, b in zip(ours[:4], ref[:4]):
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    assert tuple(ours[4]) == tuple(ref[4]) and ours[5] == ref[5]


@pytest.mark.parametrize("n", [30000, 7, 8])
def test_make_moons_is_sklearns(n):
    x, y = datasets.make_moons(n, noise=0.1, random_state=0)
    rx, ry = sk_make_moons(n_samples=n, shuffle=True, noise=0.1, random_state=0)
    assert x.dtype == rx.dtype and x.tobytes() == rx.tobytes()
    assert y.dtype == ry.dtype and y.tobytes() == ry.tobytes()


@pytest.mark.parametrize("n_inputs, shuffle, seed", [(None, False, 0), (500, True, 3), (100000, True, 0)])
def test_half_moons_is_jaxs(n_inputs, shuffle, seed):
    ours = datasets.load_dataset("half_moons", n_inputs=n_inputs, shuffle=shuffle, seed=seed)
    assert_bytes_equal(ours, jax_datasets.load_dataset("half_moons", n_inputs=n_inputs, shuffle=shuffle, seed=seed))
    assert ours[0].shape[1:] == (1, 2, 1) and ours[5] == 2


def test_cifar_surrogate_is_jaxs(monkeypatch, tmp_path, fresh_surrogate_state):
    """Each package generates the surrogate itself (no shared cache file).

    The working directory is an empty one, so that no batches beside it or
    under its ``data/`` can be found by either package's search.
    """
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("ROBUSTBNNS_SYNTH_CACHE", "0")
    monkeypatch.setenv("ROBUSTBNNS_CIFAR_DIR", "")
    ours = datasets.load_dataset("cifar", n_inputs=300, shuffle=True, fallback="synthetic")
    assert_bytes_equal(ours, jax_datasets.load_dataset("cifar", n_inputs=300, shuffle=True, fallback="synthetic"))
    assert ours[0].shape[1:] == (32, 32, 3)
    assert datasets.surrogate_fingerprint() == jax_datasets.surrogate_fingerprint()


def test_cifar_pickle_batches_read_as_jax_reads_them(monkeypatch, tmp_path):
    """Six tiny batches in the CIFAR-10 layout: NCHW rows of uint8, labels a list."""
    rng = np.random.default_rng(0)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    for i, name in enumerate(names):
        batch = {"data": rng.integers(0, 256, size=(4 + i, 3 * 32 * 32), dtype=np.uint8),
                 "labels": [int(v) for v in rng.integers(0, 10, size=4 + i)]}
        with open(tmp_path / name, "wb") as f:
            pickle.dump(batch, f)
    monkeypatch.setenv("ROBUSTBNNS_CIFAR_DIR", str(tmp_path))
    ours = datasets.load_dataset("cifar")
    assert_bytes_equal(ours, jax_datasets.load_dataset("cifar"))
    assert ours[0].shape == (4 + 5 + 6 + 7 + 8, 32, 32, 3) and ours[2].shape == (9, 32, 32, 3)


def test_classwise_arrays_and_labels_are_jaxs():
    x, y, *_ = datasets.load_dataset("half_moons", n_inputs=300)
    for n in (None, 5):
        ours, ref = classwise_arrays(x, y, n, 2), jax_classwise_arrays(x, y, n, 2)
        assert len(ours) == len(ref) == 2
        for (a, b), (ra, rb) in zip(ours, ref):
            np.testing.assert_array_equal(a, ra)
            np.testing.assert_array_equal(b, rb)
    np.testing.assert_array_equal(datasets.onehot_to_labels(y), jax_datasets.onehot_to_labels(y))


@pytest.mark.parametrize("n_hosts", [1, 3, 4])
def test_partition_for_host_is_jaxs(n_hosts):
    items = list(range(10))
    parts = [distributed.partition_for_host(items, h, n_hosts) for h in range(n_hosts)]
    assert parts == [jax_distributed.partition_for_host(items, h, n_hosts) for h in range(n_hosts)]
    assert sorted(sum(parts, [])) == items


@pytest.mark.parametrize("args", [(2, None), (None, 3), (3, 3), (-1, 2)])
def test_partition_for_host_raises_as_jax_does(args):
    with pytest.raises(ValueError) as ours:
        distributed.partition_for_host(range(5), *args)
    with pytest.raises(ValueError) as ref:
        jax_distributed.partition_for_host(range(5), *args)
    assert str(ours.value) == str(ref.value)


def test_host_identity_reads_the_environment(monkeypatch):
    assert distributed.host_identity() == jax_distributed.host_identity() == (0, 1)
    monkeypatch.setenv("ROBUSTBNNS_HOST_ID", "2")
    monkeypatch.setenv("ROBUSTBNNS_N_HOSTS", "5")
    assert distributed.host_identity() == jax_distributed.host_identity() == (2, 5)
    assert distributed.partition_for_host(list(range(12))) == [2, 7]


def test_image_grid_is_jaxs(tmp_path):
    """The same pixels as the JAX package's grid: at most 10×10 images, and
    Half Moons points drawn as one row of two pixels."""
    import matplotlib.image

    images = np.random.default_rng(1).random((150, 6, 6, 1)).astype(np.float32)
    for name, imgs in (("grid.png", images), ("moons.png", images[:7, :1, :2])):
        ours = plotting.plot_save_grid_images(imgs, name, str(tmp_path / "port"))
        ref = jax_plotting.plot_save_grid_images(imgs, name, str(tmp_path / "jax"))
        assert os.path.basename(ours) == os.path.basename(ref)
        np.testing.assert_array_equal(matplotlib.image.imread(ours), matplotlib.image.imread(ref))


@pytest.fixture
def tiny_image_files(monkeypatch, tmp_path):
    """Small MNIST and Fashion-MNIST npz files and CIFAR-10 pickle batches that
    both packages find first ($ROBUSTBNNS_DATASET_DIR, $ROBUSTBNNS_CIFAR_DIR),
    from an empty working directory."""
    rng = np.random.default_rng(1)
    for name in ("mnist", "fashion_mnist"):
        np.savez(tmp_path / f"{name}.npz", x_train=rng.integers(0, 256, (12, 28, 28), dtype=np.uint8),
                 y_train=rng.integers(0, 10, 12, dtype=np.uint8),
                 x_test=rng.integers(0, 256, (5, 28, 28), dtype=np.uint8),
                 y_test=rng.integers(0, 10, 5, dtype=np.uint8))
    cifar = tmp_path / "cifar"
    cifar.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(cifar / name, "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, size=(3, 3 * 32 * 32), dtype=np.uint8),
                         "labels": [int(v) for v in rng.integers(0, 10, size=3)]}, f)
    monkeypatch.setenv("ROBUSTBNNS_DATASET_DIR", str(tmp_path))
    monkeypatch.setenv("ROBUSTBNNS_CIFAR_DIR", str(cifar))
    monkeypatch.chdir(tmp_path)


@pytest.mark.parametrize("channels", ["last", "first"])
@pytest.mark.parametrize("loader, args", [
    ("load_mnist", ("error",)),
    ("load_fashion_mnist", ("error",)),
    ("load_cifar", ("error",)),
    ("load_half_moons", (300,)),
])
def test_loaders_bind_channels_positionally_as_jax(tiny_image_files, loader, args, channels):
    """``channels`` comes first (``load_half_moons(channels, n_samples)``,
    ``load_cifar(channels, fallback)``, ``load_mnist``/``load_fashion_mnist``
    alike) and gives JAX's arrays in both layouts: a greyscale reshape to
    NCHW, CIFAR-10's transpose, Half Moons' (N, 1, 2, 1) either way."""
    ours = getattr(datasets, loader)(channels, *args)
    assert_bytes_equal(ours, getattr(jax_datasets, loader)(channels, *args))
    if channels == "first" and loader != "load_half_moons":
        assert ours[0].shape[1] in (1, 3)


@pytest.mark.parametrize("name", ["mnist", "fashion_mnist", "cifar", "half_moons"])
def test_load_dataset_binds_channels_third_as_jax(tiny_image_files, name):
    """``load_dataset(name, n_inputs, channels, shuffle, fallback, seed)``
    positionally, as JAX's signature has it."""
    args = (name, 7, "first", True, "error", 2)
    assert_bytes_equal(datasets.load_dataset(*args), jax_datasets.load_dataset(*args))


def test_package_exports_match_jax():
    assert set(data.__all__) == set(jax_data.__all__)
    for name in data.__all__:
        assert callable(getattr(data, name))


def test_batches_reshuffle_each_epoch_and_batch_as_jax():
    """With JAX's permutation of an epoch injected, the port's batches equal
    JAX's exactly; the port's own permutations differ from epoch to epoch,
    repeat for a seed and epoch, and permute every row; ``__iter__`` yields
    epoch 0's (x, y, mask) and no shuffle keeps the order."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(11, 2, 3)).astype(np.float32)
    y = rng.normal(size=(11, 4)).astype(np.float32)
    jb = JaxBatches(x, y, 4, key=jax.random.key(5))
    ours = Batches(torch.from_numpy(x), torch.from_numpy(y), 4, seed=5)
    assert (ours.n, ours.num_batches) == (jb.n, jb.num_batches) == (11, 3)
    for epoch in (0, 3):
        perm = np.asarray(jax.random.permutation(jax.random.fold_in(jb.key, epoch), jb.n))
        for a, b in zip(ours.epoch(epoch, perm=torch.from_numpy(perm.copy())), jb.epoch(epoch)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    p0, p1 = ours.permutation(0), ours.permutation(1)
    assert torch.equal(p0, Batches(torch.from_numpy(x), torch.from_numpy(y), 4, seed=5).permutation(0))
    assert not torch.equal(p0, p1) and sorted(p0.tolist()) == list(range(11))
    assert not torch.equal(p0, Batches(torch.from_numpy(x), torch.from_numpy(y), 4, seed=6).permutation(0))
    e0 = ours.epoch(0)
    torch.testing.assert_close(e0.x[:2].reshape(8, 2, 3), torch.from_numpy(x)[p0[:8]], rtol=0, atol=0)
    for i, (bx, by, bm) in enumerate(ours):
        assert torch.equal(bx, e0.x[i]) and torch.equal(by, e0.y[i]) and torch.equal(bm, e0.mask[i])
    assert float(e0.mask.sum()) == 11
    plain = Batches(torch.from_numpy(x), torch.from_numpy(y), 4, shuffle=False)
    for a, b in zip(plain.epoch(2), JaxBatches(x, y, 4, shuffle=False).epoch(2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert jnp.asarray(x).shape == tuple(ours.x.shape)
