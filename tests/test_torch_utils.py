"""The port's timing, profiling and tree helpers and its package exports
(``utils/timing.py``, ``utils/pytree.py``, ``utils/__init__.py``,
``inference/__init__.py``) against the JAX package's, on the CPU.

The path names must equal JAX's string for string; the timer is checked
against the host clock only (the CPU has no card to wait for).
"""
import importlib
import inspect
import os
import pkgutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robustbnns_tpu.inference as jax_inference
import robustbnns_tpu.utils as jax_utils
import robustbnns_tpu_torch.inference as inference
import robustbnns_tpu_torch.utils as utils
from robustbnns_tpu.inference.svi import MeanFieldPosterior as JaxPosterior
from robustbnns_tpu.utils.pytree import tree_map_with_path_names as jax_tree_map_with_path_names
from robustbnns_tpu_torch.inference.svi import MeanFieldPosterior
from robustbnns_tpu_torch.utils.pytree import tree_map_with_path_names
from robustbnns_tpu_torch.utils.timing import Timer, maybe_profile


def layers(make):
    return tuple({"w": make((3, 2)), "b": make((2,))} for _ in range(2))


@pytest.mark.parametrize("kind", ["layers", "posterior", "nested", "leaf", "none"])
def test_path_names_are_jaxs(kind):
    """The same tree in both packages (tensors here, arrays there): the names
    ``fn`` sees, in order, and the structure it returns."""
    trees = {
        "layers": lambda mk: layers(mk),
        "posterior": lambda mk: (MeanFieldPosterior if mk is torch.ones else JaxPosterior)(layers(mk), layers(mk)),
        "nested": lambda mk: {"b": mk((1,)), "a": [mk((2,)), {"z": mk((1,)), "c": mk((3,))}]},
        "leaf": lambda mk: mk((4,)),
        "none": lambda mk: (None, mk((1,))),
    }
    ours, ref = [], []
    got = tree_map_with_path_names(lambda n, v: ours.append(n) or v.numel(), trees[kind](torch.ones))
    want = jax_tree_map_with_path_names(lambda n, v: ref.append(n) or v.size, trees[kind](jnp.ones))
    assert ours == ref
    assert jax.tree_util.tree_leaves(got) == jax.tree_util.tree_leaves(want)
    if kind == "posterior":  # two NamedTuple classes of one name and fields
        assert isinstance(got, MeanFieldPosterior) and ours[0] == ".loc/0/b"
        got, want = tuple(got), tuple(want)
    assert str(jax.tree_util.tree_structure(got)) == str(jax.tree_util.tree_structure(want))


def test_timer_measures_the_block():
    with Timer() as timer:
        time.sleep(0.02)
    assert 0.02 <= timer.elapsed < 1.0
    with Timer() as again:
        pass
    assert 0 <= again.elapsed < timer.elapsed


def test_maybe_profile_traces_only_with_a_directory(tmp_path):
    """No directory: no profiler, nothing written. A directory: a Chrome trace
    of the block's operations lands in it."""
    with maybe_profile() as prof:
        torch.ones(3).sum()
    assert prof is None
    with maybe_profile(str(tmp_path / "trace")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = os.listdir(tmp_path / "trace")
    assert prof is not None and files and all(f.endswith(".json") for f in files)
    with open(tmp_path / "trace" / files[0]) as f:
        assert "aten::mm" in f.read()


def test_package_exports_cover_jaxs():
    """Every name the JAX package's ``utils`` and ``inference`` export exists
    in the port's; the port adds ``maybe_profile``, ``tree_map_with_path_names``
    and the info tuples."""
    assert set(jax_utils.__all__) <= set(utils.__all__)
    assert set(jax_inference.__all__) <= set(inference.__all__)
    for module in (utils, inference):
        for name in module.__all__:
            assert getattr(module, name) is not None
    post = inference.init_meanfield(torch.Generator().manual_seed(0), layers(torch.ones))
    assert isinstance(post, inference.MeanFieldPosterior)
    assert float(inference.gaussian_kl_to_std_normal(post)) > 0
    w = inference.sample_meanfield(post, torch.Generator().manual_seed(1))
    assert np.all([a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(w), jax.tree_util.tree_leaves(post.loc))])


SUBPACKAGES = ("analysis", "attacks", "data", "inference", "models", "ops", "parallel", "utils")
# Public functions of the JAX package with no torch role: jit and PRNG-key
# machinery (ROADMAP.md, "Modules"). Any other gap fails below.
JAX_ONLY = {
    "predict": {"attach_pure", "split_pure", "normalize_forward", "resolve_sample_keys"},
    "utils.prng": {"make_key", "use_fast_prng"},
}


@pytest.mark.parametrize("name", SUBPACKAGES)
def test_subpackage_exports_cover_jaxs(name):
    """Every name in a JAX subpackage's ``__all__`` is in the port's ``__all__``."""
    ours = importlib.import_module(f"robustbnns_tpu_torch.{name}")
    theirs = importlib.import_module(f"robustbnns_tpu.{name}")
    assert set(theirs.__all__) <= set(ours.__all__)
    assert all(getattr(ours, n) is not None for n in ours.__all__)


def test_every_module_covers_jaxs_but_the_pinned_machinery():
    """For every module of the JAX package, the public functions and classes
    it defines that the port's module of the same path lacks are exactly the
    pinned jit/PRNG machinery."""
    import robustbnns_tpu

    gaps = {}
    for info in pkgutil.walk_packages(robustbnns_tpu.__path__, "robustbnns_tpu."):
        theirs = importlib.import_module(info.name)
        ours = importlib.import_module("robustbnns_tpu_torch" + info.name.removeprefix("robustbnns_tpu"))
        missing = {n for n, v in vars(theirs).items()
                   if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
                   and v.__module__ == info.name and not hasattr(ours, n)}
        if missing:
            gaps[info.name.removeprefix("robustbnns_tpu.")] = missing
    assert gaps == JAX_ONLY
