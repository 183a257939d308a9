"""Dataset loading with the reference's preprocessing (port of
``robustbnns_tpu/data/datasets.py``).

Numpy only, and byte-for-byte the JAX package's output:

* Half Moons — sklearn's ``make_moons(30000, noise=0.1, random_state=0)``
  (a numpy copy, :func:`make_moons`), global min-max to [0, 1], an 80/20
  split, ``(N, 1, 2, 1)`` points and one-hot(2) labels (reference
  ``utils.py:67-92``);
* MNIST / Fashion-MNIST — float32 ``/255`` NHWC images and one-hot(10)
  labels (reference ``utils.py:95-145``);
* CIFAR-10 — the local pickle batches, NCHW transposed to NHWC, float32
  ``/255``, one-hot(10) (reference ``utils.py:160-206``);
* ``n_inputs`` truncation of train and test, then an optional seeded shuffle
  (``utils.py:221-233``).

Layout: NHWC (``channels='last'``, the default). ``channels='first'`` gives
the JAX package's NCHW arrays: greyscale images reshaped to ``(N, 1, H, W)``,
multi-channel ones (CIFAR-10, its surrogate) transposed from NHWC
(``_finish_image_dataset``, JAX ``datasets.py:386-410``); Half Moons keeps its
``(N, 1, 2, 1)`` shape either way. ``channels`` sits where the JAX signatures
put it, so positional calls bind alike.

Offline fallback: with no local copy the deterministic synthetic surrogate of
the JAX package stands in for MNIST, Fashion-MNIST and CIFAR-10, generated by
the same code (``SURROGATE_VERSION`` 2) and kept in the same cross-process
cache.
"""
from __future__ import annotations

import functools
import os
import pickle
import warnings
from typing import Optional, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, tuple, int]

_FALLBACK_ENV = "ROBUSTBNNS_DATA_FALLBACK"

# Version of the synthetic-surrogate generator; equal to the JAX package's, since
# the generator below is the same code. Checkpoints saved by a process that
# served surrogate data carry it (see utils.checkpoint).
SURROGATE_VERSION = 2
_surrogate_served: set = set()  # dataset names served synthetically, this process


def surrogate_fingerprint() -> Optional[dict]:
    """Checkpoint-meta tag when this process served synthetic surrogate data."""
    if not _surrogate_served:
        return None
    return {
        "surrogate_version": SURROGATE_VERSION,
        "surrogate_datasets": sorted(_surrogate_served),
    }


def labels_to_onehot(integer_labels: np.ndarray, n_classes: Optional[int] = None):
    """Dense one-hot encoding (reference ``utils.py:147-152``)."""
    n_rows = len(integer_labels)
    n_cols = n_classes if n_classes else int(integer_labels.max()) + 1
    onehot = np.zeros((n_rows, n_cols), dtype="float32")
    onehot[np.arange(n_rows), np.asarray(integer_labels, dtype=np.int64)] = 1.0
    return onehot


def onehot_to_labels(y: np.ndarray) -> np.ndarray:
    """Inverse of :func:`labels_to_onehot` (reference ``utils.py:154-158``)."""
    return np.argmax(y, axis=-1)


def make_moons(n_samples: int, noise: float = 0.1, random_state: int = 0):
    """sklearn's ``make_moons(n_samples, shuffle=True, noise, random_state)``,
    bit for bit (sklearn 1.x, ``datasets/_samples_generator.py``): two
    half-circles from ``linspace``, shuffled by a ``RandomState`` (sklearn's
    ``utils.shuffle``), then Gaussian noise from the same generator."""
    n_out = n_samples // 2
    n_in = n_samples - n_out
    generator = np.random.RandomState(random_state)
    outer_x = np.cos(np.linspace(0, np.pi, n_out))
    outer_y = np.sin(np.linspace(0, np.pi, n_out))
    inner_x = 1 - np.cos(np.linspace(0, np.pi, n_in))
    inner_y = 1 - np.sin(np.linspace(0, np.pi, n_in)) - 0.5
    x = np.vstack([np.append(outer_x, inner_x), np.append(outer_y, inner_y)]).T
    y = np.hstack([np.zeros(n_out, dtype=np.intp), np.ones(n_in, dtype=np.intp)])
    order = np.arange(n_samples)
    generator.shuffle(order)
    x, y = x[order], y[order]
    x += generator.normal(scale=noise, size=x.shape)
    return x, y


def load_half_moons(channels: str = "last", n_samples: int = 30000) -> Arrays:
    """Half Moons with the reference's generation and normalization
    (``utils.py:67-92``): global min-max to [0, 1], an 80/20 split, the
    ``(N, 1, 2, 1)`` image-like shape (for either ``channels``, as in the
    reference) and one-hot(2) labels."""
    x, y = make_moons(n_samples, noise=0.1, random_state=0)
    x, y = x.astype("float32"), y.astype("float32")
    x = (x - np.min(x)) / (np.max(x) - np.min(x))
    split = int(0.8 * len(x))
    x_train = x[:split].reshape(split, 1, 2, 1)
    x_test = x[split:].reshape(len(x) - split, 1, 2, 1)
    return (
        x_train,
        labels_to_onehot(y[:split].astype(np.int64), 2),
        x_test,
        labels_to_onehot(y[split:].astype(np.int64), 2),
        x_train.shape[1:],
        2,
    )


def _search_roots() -> list[str]:
    return [
        os.environ.get("ROBUSTBNNS_DATASET_DIR", ""),
        os.path.expanduser("~/.keras/datasets"),
        "data",
        ".",
    ]


def _read_idx(path: str) -> np.ndarray:
    """Read one IDX-format array (the MNIST file format), gzipped or raw."""
    import gzip
    import struct

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        z1, z2, dtype_code, ndim = struct.unpack("BBBB", f.read(4))
        if z1 != 0 or z2 != 0:
            raise ValueError(f"{path}: not an IDX file (bad magic)")
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        dtypes = {
            0x08: np.dtype(np.uint8), 0x09: np.dtype(np.int8),
            0x0B: np.dtype(">i2"), 0x0C: np.dtype(">i4"),
            0x0D: np.dtype(">f4"), 0x0E: np.dtype(">f8"),
        }
        if dtype_code not in dtypes:
            raise ValueError(f"{path}: unknown IDX dtype 0x{dtype_code:02x}")
        data = np.frombuffer(f.read(), dtype=dtypes[dtype_code])
        if data.size != int(np.prod(dims)):
            raise ValueError(f"{path}: truncated IDX payload")
        return data.reshape(dims)


_IDX_FILES = {
    "x_train": "train-images-idx3-ubyte",
    "y_train": "train-labels-idx1-ubyte",
    "x_test": "t10k-images-idx3-ubyte",
    "y_test": "t10k-labels-idx1-ubyte",
}


def _search_idx_quad(subdirs: list[str]) -> Optional[dict]:
    """Find all four IDX files (.gz or raw) under the dataset search roots."""
    for root in filter(None, _search_roots()):
        for sub in subdirs:
            d = os.path.join(root, sub) if sub else root
            found = {}
            for key, stem in _IDX_FILES.items():
                for name in (stem + ".gz", stem):
                    if os.path.exists(os.path.join(d, name)):
                        found[key] = os.path.join(d, name)
                        break
            if len(found) == len(_IDX_FILES):
                return found
    return None


def _load_mnist_like(dataset_name: str, fallback: str):
    """Same search order as the JAX package: npz, then a named IDX quad, then a
    flat one (with its warning), then the surrogate if allowed."""
    for root in filter(None, _search_roots()):
        path = os.path.join(root, f"{dataset_name}.npz")
        if os.path.exists(path):
            with np.load(path, allow_pickle=False) as f:
                return (f["x_train"], f["y_train"]), (f["x_test"], f["y_test"])
    idx_subdir = {"mnist": "mnist", "fashion_mnist": "fashion-mnist"}[dataset_name]
    quad = _search_idx_quad([idx_subdir, dataset_name])
    if quad is None:
        quad = _search_idx_quad([""])
        if quad is not None:
            warnings.warn(
                f"Serving {dataset_name} from an IDX quad found flat in a search "
                f"root ({os.path.dirname(quad['x_train'])}): MNIST and "
                "Fashion-MNIST use identical IDX file names — place them under a "
                f"'{idx_subdir}/' subdir to disambiguate.",
                stacklevel=2,
            )
    if quad is not None:
        return (
            (_read_idx(quad["x_train"]), _read_idx(quad["y_train"])),
            (_read_idx(quad["x_test"]), _read_idx(quad["y_test"])),
        )
    fallback = os.environ.get(_FALLBACK_ENV, fallback)
    if fallback == "synthetic":
        return _synthetic_image_dataset(dataset_name, 28, 28, 1, 60000, 10000)
    raise FileNotFoundError(
        f"No local copy of {dataset_name} (looked for {dataset_name}.npz and the "
        f"IDX quad under $ROBUSTBNNS_DATASET_DIR, ~/.keras/datasets, ./data). "
        f"Pass fallback='synthetic' or set {_FALLBACK_ENV}=synthetic to use a "
        "deterministic surrogate."
    )


def _synth_cache_dir() -> str:
    """Cross-process cache dir for generated surrogates ('' disables).

    Shared with the JAX package: the generator is the same pure function, so
    either package may write the file the other reads.
    """
    v = os.environ.get("ROBUSTBNNS_SYNTH_CACHE")
    if v == "0":
        return ""
    if v:
        return v
    return os.path.join(os.path.expanduser("~"), ".cache", "robustbnns_tpu", "synthetic")


@functools.lru_cache(maxsize=4)
def _synthetic_image_dataset(name, rows, cols, chans, n_train, n_test):
    """Deterministic learnable surrogate: per-class smooth prototypes + noise.

    The JAX package's generator, unchanged (``datasets.py:274-365``): classes
    are 3-subsets of a shared 5-blob pool, seeded by ``zlib.crc32(name)``;
    train and test noise come from seeds 1234 and 5678. Callers never mutate the
    returned uint8 arrays (``_finish_image_dataset`` copies via ``astype``).
    """
    _surrogate_served.add(name)
    cache_dir = _synth_cache_dir()
    cache_path = (
        os.path.join(cache_dir, f"{name}_{rows}x{cols}x{chans}_tr{n_train}_te{n_test}.npz")
        if cache_dir
        else ""
    )
    if cache_path and os.path.exists(cache_path):
        try:
            with np.load(cache_path) as z:
                return (z["xtr"], z["ytr"]), (z["xte"], z["yte"])
        except (OSError, ValueError, KeyError) as e:  # partial file: regenerate
            warnings.warn(f"synthetic cache unreadable ({e}); regenerating")

    import zlib

    rng = np.random.default_rng(zlib.crc32(name.encode("utf-8")))
    n_classes = 10
    yy, xx = np.mgrid[0:rows, 0:cols].astype(np.float32)
    pool = [
        (rng.uniform(4, rows - 4), rng.uniform(4, cols - 4), rng.uniform(2.0, 4.5))
        for _ in range(5)
    ]
    combos: list[tuple] = []
    while len(combos) < n_classes:
        c = tuple(sorted(rng.choice(len(pool), size=3, replace=False)))
        if c not in combos:
            combos.append(c)
    protos = []
    for combo in combos:
        img = np.zeros((rows, cols), np.float32)
        for i in combo:
            cy, cx, s = pool[i]
            img += np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s)))
        protos.append(img / img.max())
    protos = np.stack(protos)

    def make(n, seed):
        r = np.random.default_rng(seed)
        labels = r.integers(0, n_classes, size=n)
        noise = r.normal(0.0, 0.30, size=(n, rows, cols)).astype(np.float32)
        imgs = np.clip(protos[labels] + noise, 0.0, 1.0)
        x = (imgs * 255).astype(np.uint8)
        if chans > 1:
            x = np.repeat(x[..., None], chans, axis=-1)
        return x, labels.astype(np.uint8)

    train, test = make(n_train, 1234), make(n_test, 5678)
    if cache_path:
        try:  # atomic publish: concurrent writers race benignly (same bytes)
            import tempfile

            os.makedirs(cache_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".npz.tmp")
            with os.fdopen(fd, "wb") as f:
                np.savez(f, xtr=train[0], ytr=train[1], xte=test[0], yte=test[1])
            os.replace(tmp, cache_path)
        except OSError as e:  # read-only FS etc. — the cache is best-effort
            warnings.warn(f"synthetic cache write failed ({e})")
    return train, test


def _finish_image_dataset(train, test, channels, rows, cols, n_chan) -> Arrays:
    (x_train, y_train), (x_test, y_test) = train, test
    x_train = x_train.astype("float32") / 255.0
    x_test = x_test.astype("float32") / 255.0
    if x_train.ndim == 3:  # greyscale (N, H, W): reshaped to NCHW or NHWC
        shape = (n_chan, rows, cols) if channels == "first" else (rows, cols, n_chan)
        x_train = x_train.reshape((len(x_train),) + shape)
        x_test = x_test.reshape((len(x_test),) + shape)
    elif channels == "first":  # NHWC (CIFAR-10, multi-channel surrogates) -> NCHW
        x_train = np.transpose(x_train, (0, 3, 1, 2))
        x_test = np.transpose(x_test, (0, 3, 1, 2))
    y_train = labels_to_onehot(y_train.astype(np.int64).reshape(-1), 10)
    y_test = labels_to_onehot(y_test.astype(np.int64).reshape(-1), 10)
    return x_train, y_train, x_test, y_test, x_train.shape[1:], 10


def load_mnist(channels: str = "last", fallback: str = "error") -> Arrays:
    """MNIST with the reference's preprocessing (``utils.py:121-145``)."""
    return _finish_image_dataset(*_load_mnist_like("mnist", fallback), channels, 28, 28, 1)


def load_fashion_mnist(channels: str = "last", fallback: str = "error") -> Arrays:
    """Fashion-MNIST with the reference's preprocessing (``utils.py:95-118``)."""
    return _finish_image_dataset(*_load_mnist_like("fashion_mnist", fallback), channels, 28, 28, 1)


def load_cifar(channels: str = "last", fallback: str = "error") -> Arrays:
    """CIFAR-10 from local pickle batches (reference ``utils.py:160-206``).

    Search order: ``$ROBUSTBNNS_CIFAR_DIR``, ``data/cifar-10/``,
    ``data/cifar-10-batches-py/``. Unlike the JAX package, the port does not
    look in ``../cifar-10/`` (the reference's path, ``utils.py:164``): relative
    to a checkout that is the directory beside it, which the port never reads.
    The batches store NCHW rows; they are transposed to NHWC. With none found,
    the synthetic 32×32×3 surrogate under ``fallback='synthetic'`` (or
    ``ROBUSTBNNS_DATA_FALLBACK``), else ``FileNotFoundError``.
    """
    data_dirs = [
        os.environ.get("ROBUSTBNNS_CIFAR_DIR", ""),
        "data/cifar-10/",
        "data/cifar-10-batches-py/",
    ]
    data_dir = next(
        (d for d in data_dirs if d and os.path.exists(os.path.join(d, "data_batch_1"))), None
    )
    if data_dir is None:
        fallback = os.environ.get(_FALLBACK_ENV, fallback)
        if fallback == "synthetic":
            train, test = _synthetic_image_dataset("cifar", 32, 32, 3, 50000, 10000)
            return _finish_image_dataset(train, test, channels, 32, 32, 3)
        raise FileNotFoundError(
            "No local CIFAR-10 pickle batches found (set $ROBUSTBNNS_CIFAR_DIR). "
            f"Pass fallback='synthetic' or set {_FALLBACK_ENV}=synthetic."
        )

    def unpickle(path):  # the dataset's own format: python pickles of arrays and lists
        with open(path, "rb") as f:
            return pickle.load(f, encoding="latin-1")

    xs, ys = [], []
    for batch in range(1, 6):
        d = unpickle(os.path.join(data_dir, f"data_batch_{batch}"))
        xs.append(d["data"])
        ys += list(d["labels"])
    x_train = np.vstack(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    d = unpickle(os.path.join(data_dir, "test_batch"))
    x_test = np.asarray(d["data"]).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return _finish_image_dataset(
        (x_train, np.array(ys, dtype=np.int64)), (x_test, np.array(d["labels"], dtype=np.int64)),
        channels, 32, 32, 3,
    )


def load_dataset(
    dataset_name: str,
    n_inputs: Optional[int] = None,
    channels: str = "last",
    shuffle: bool = False,
    fallback: str = "error",
    seed: int = 0,
) -> Arrays:
    """Load any of the four datasets, NHWC unless ``channels='first'``
    (reference ``utils.py:208-235``)."""
    if dataset_name == "mnist":
        out = load_mnist(channels, fallback)
    elif dataset_name == "fashion_mnist":
        out = load_fashion_mnist(channels, fallback)
    elif dataset_name == "cifar":
        out = load_cifar(channels, fallback)
    elif dataset_name == "half_moons":
        out = load_half_moons(channels)
    else:
        raise ValueError(f"Dataset {dataset_name!r} not available.")
    x_train, y_train, x_test, y_test, input_shape, num_classes = out
    if n_inputs:
        x_train, y_train = x_train[:n_inputs], y_train[:n_inputs]
        x_test, y_test = x_test[:n_inputs], y_test[:n_inputs]
    if shuffle:
        rng = np.random.default_rng(seed)
        idxs = rng.permutation(len(x_train))
        x_train, y_train = x_train[idxs], y_train[idxs]
        idxs = rng.permutation(len(x_test))
        x_test, y_test = x_test[idxs], y_test[idxs]
    return x_train, y_train, x_test, y_test, input_shape, num_classes
