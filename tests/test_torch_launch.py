"""The hand-written kernels' shared launch path (``ops/build.py``) on the CPU.

:func:`build.launch` runs a C entry point with the device current and its
current stream last, raises naming the entry point on a nonzero
``cudaError`` and counts a launch only once it succeeded; :func:`build.sm_count`
reads a card's properties once per device; ``build.SOURCES``, every
``csrc/*.cu``, holds every source an op binds. The card's own device context, stream and
properties are stood in for here, so the path runs without a card; the
kernels themselves launch through it in ``tests/test_torch_kernels.py``.
"""
import contextlib
import ctypes
import importlib
import types

import pytest
import torch

from robustbnns_tpu_torch.ops import build
from robustbnns_tpu_torch.utils import timing

CUDA = torch.device("cuda", 0)


@pytest.fixture
def fake_card(monkeypatch):
    """A device context and a current stream (handle 7) for ``build.launch``
    where there is no card; returns the devices made current."""
    made_current = []

    def device(d):
        made_current.append(d)
        return contextlib.nullcontext()

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: types.SimpleNamespace(cuda_stream=7))
    return made_current


def entry_point(name, result):
    """A ctypes entry point ``name`` of (pointer, int, stream) that records
    its arguments and returns ``result`` as its ``cudaError``."""
    seen = []
    fn = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)(
        lambda ptr, n, stream: seen.append((ptr, n, stream)) or result)
    fn.__name__ = name
    return fn, seen


@pytest.mark.parametrize("result", [0, 700], ids=["success", "cuda_error"])
def test_launch_counts_a_launch_only_once_it_succeeded(fake_card, result):
    counter = "test_launch.fake"
    fn, seen = entry_point("fake_entry_point", result)
    before = timing.counters().get(counter, 0)
    t = torch.zeros(4)
    if result:
        with pytest.raises(RuntimeError, match="fake_entry_point failed to launch: cudaError 700"):
            build.launch(counter, fn, CUDA, t, 3)
    else:
        build.launch(counter, fn, CUDA, t, 3)
    assert seen == [(t.data_ptr(), 3, 7)]  # a tensor passes its data pointer, the stream comes last
    assert fake_card == [CUDA]
    assert timing.counters().get(counter, 0) - before == (0 if result else 1)


def test_sm_count_reads_each_device_once(monkeypatch):
    reads = []

    def properties(device):
        reads.append(device)
        return types.SimpleNamespace(multi_processor_count=132)

    monkeypatch.setattr(torch.cuda, "get_device_properties", properties)
    build.sm_count.cache_clear()
    try:
        assert [build.sm_count(CUDA) for _ in range(3)] == [132] * 3
        assert reads == [CUDA]
        assert build.sm_count(torch.device("cuda", 1)) == 132 and len(reads) == 2
    finally:
        build.sm_count.cache_clear()


def test_every_bound_source_is_built():
    """The sources that the ops bind entry points from are the sources
    built, one library each."""
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    gc = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv")
    bound = {source for source, _ in sd.SIGNATURES.values()} | {f"{kind.name}.cu" for kind in gc.KINDS.values()}
    assert bound == set(build.SOURCES) and len(build.SOURCES) == 8
