"""The port's checkpoint backend switch (``utils/checkpoint.py``) against the
JAX package's, on the CPU.

The port takes JAX's ``backend=`` and ``ROBUSTBNNS_CKPT_BACKEND`` and rejects
the same unknown names. Its Orbax backend is not ported: a save under
``orbax`` and a load of a JAX Orbax checkpoint raise ``NotImplementedError``
naming Orbax, and the save writes nothing. npz files move between the two
packages unchanged, meta included.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robustbnns_tpu.utils import checkpoint as jax_checkpoint
from robustbnns_tpu_torch.utils import checkpoint, wait_for_checkpoints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tree():
    return {"w": jnp.arange(12.0).reshape(3, 4), "nested": {"b": jnp.ones((5,)), "n": jnp.full((2, 2), 7.0)}}


def port_tree():
    return {"w": torch.arange(12.0).reshape(3, 4), "nested": {"b": torch.ones(5), "n": torch.full((2, 2), 7.0)}}


def assert_trees_equal(a, b):
    for key in ("w", "nested/b", "nested/n"):
        x, y = a, b
        for part in key.split("/"):
            x, y = x[part], y[part]
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture
def orbax_checkpoint(tmp_path):
    """A checkpoint written by JAX's Orbax backend: (logical path, returned path)."""
    logical = str(tmp_path / "ckpt")
    returned = jax_checkpoint.save_pytree(jax_tree(), logical, meta={"lr": 0.01}, backend="orbax")
    jax_checkpoint.wait_for_checkpoints()
    assert returned.endswith(".orbax") and os.path.isdir(returned)
    return logical, returned


@pytest.mark.parametrize("which", ["logical", "returned"])
def test_orbax_checkpoint_load_is_refused(orbax_checkpoint, which):
    path = orbax_checkpoint[0 if which == "logical" else 1]
    with pytest.raises(NotImplementedError, match="Orbax"):
        checkpoint.load_pytree(port_tree(), path)
    with pytest.raises(NotImplementedError, match="Orbax"):
        checkpoint.load_meta(path)
    assert_trees_equal(jax_checkpoint.load_pytree(jax_tree(), path), jax_tree())  # JAX still reads it


def test_missing_checkpoint_is_still_file_not_found(tmp_path):
    """No npz and no Orbax directory: the missing file's own error, as before."""
    for load in (lambda p: checkpoint.load_pytree(port_tree(), p), checkpoint.load_meta):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "absent"))


def test_npz_beside_an_orbax_directory_loads(tmp_path):
    """An npz and an Orbax directory at one logical path: the npz loads, as in JAX."""
    path = str(tmp_path / "both")
    jax_checkpoint.save_pytree(jax_tree(), path, backend="orbax")
    jax_checkpoint.wait_for_checkpoints()
    checkpoint.save_pytree(port_tree(), path, meta={"epochs": 2})
    assert_trees_equal(checkpoint.load_pytree(port_tree(), path), port_tree())
    assert checkpoint.load_meta(path)["epochs"] == 2


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_orbax_save_is_refused_before_writing(tmp_path, monkeypatch, how):
    if how == "environment":
        monkeypatch.setenv("ROBUSTBNNS_CKPT_BACKEND", "orbax")
    with pytest.raises(NotImplementedError, match="Orbax") as info:
        checkpoint.save_pytree(port_tree(), str(tmp_path / "sub" / "ckpt"),
                               backend="orbax" if how == "argument" else None)
    assert "npz" in str(info.value)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_unknown_backend_is_rejected_by_both(tmp_path, monkeypatch, how):
    backend = "bogus" if how == "argument" else None
    if how == "environment":
        monkeypatch.setenv("ROBUSTBNNS_CKPT_BACKEND", "bogus")
    with pytest.raises(ValueError, match="unknown checkpoint backend 'bogus'"):
        jax_checkpoint.save_pytree(jax_tree(), str(tmp_path / "j"), backend=backend)
    with pytest.raises(ValueError, match="unknown checkpoint backend 'bogus'"):
        checkpoint.save_pytree(port_tree(), str(tmp_path / "t"), backend=backend)
    assert os.listdir(tmp_path) == []


def test_npz_backend_round_trips_through_jax(tmp_path, monkeypatch):
    """Port save (``backend="npz"``, over an ``orbax`` variable) -> JAX load ->
    JAX save -> port load, leaves and meta. Meta is compared key by key: a
    process that served surrogate data adds its tag to every save."""
    monkeypatch.setenv("ROBUSTBNNS_CKPT_BACKEND", "orbax")
    meta = {"epochs": 5, "lr": 0.01}
    first = checkpoint.save_pytree(port_tree(), str(tmp_path / "port"), meta=meta, backend="npz")
    assert first.endswith(".npz")
    loaded = jax_checkpoint.load_pytree(jax_tree(), str(tmp_path / "port"))
    assert_trees_equal(loaded, jax_tree())
    assert {k: jax_checkpoint.load_meta(first)[k] for k in meta} == meta
    second = jax_checkpoint.save_pytree(loaded, str(tmp_path / "jax"), meta=meta, backend="npz")
    back = checkpoint.load_pytree(port_tree(), second)
    assert_trees_equal(back, port_tree())
    assert all(torch.is_tensor(v) for v in (back["w"], back["nested"]["b"], back["nested"]["n"]))
    assert {k: checkpoint.load_meta(str(tmp_path / "jax"))[k] for k in meta} == meta


def test_wait_for_checkpoints_returns_none():
    assert wait_for_checkpoints() is None
    assert checkpoint.wait_for_checkpoints is wait_for_checkpoints


def test_checkpoint_module_imports_neither_jax_nor_orbax():
    code = (
        "import sys\n"
        "import robustbnns_tpu_torch.utils.checkpoint\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'orbax', 'robustbnns_tpu')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
