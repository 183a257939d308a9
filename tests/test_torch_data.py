"""The port's datasets, per-class subsets, host partitioning and image grids
(``data/datasets.py``, ``data/loaders.py``, ``parallel/distributed.py``,
``utils/plotting.py``) against the JAX package's and sklearn's, on the CPU.

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
from robustbnns_tpu.data.loaders import classwise_arrays as jax_classwise_arrays
from robustbnns_tpu.parallel import distributed as jax_distributed
from robustbnns_tpu.utils import plotting as jax_plotting
from robustbnns_tpu_torch.data import datasets
from robustbnns_tpu_torch.data.loaders import classwise_arrays
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
