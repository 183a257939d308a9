"""Build, load and launch the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). Libraries go to ``build/kernels/`` at the repo root
(listed in ``.gitignore``), named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one is reused. All sources are compiled
in parallel, one ``nvcc`` process each. ``--use_fast_math`` stays off: it would
change ``logf``/``sinf``/``cosf`` against the plain PyTorch twins.

Every hand-written kernel launches through this module: :func:`bind` types a
C entry point once per process, :func:`check` holds a call's operands to what
the kernels read, :func:`launch` runs an entry point on the device's current
stream and counts it, and :func:`launch_counts` reads every kernel's counter
(:data:`LAUNCH_COUNTERS`, filled by the ops modules). Each entry point returns
a ``cudaError`` and takes the stream as its last argument.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

import torch

from robustbnns_tpu_torch.utils.timing import count, counters, reset_counters

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = tuple(sorted(path.name for path in CSRC.glob("*.cu")))  # one library each

_libraries: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # nvcc's output per source (register and spill report)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return nvcc


def _library_path(source: str) -> Path:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:12]}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source not yet built (all nvcc runs at once) and load all."""
    pending = [s for s in SOURCES if s not in _libraries]
    if not pending:
        return _libraries
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for source in pending:
        target = _library_path(source)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[source] = (tmp, target, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    failures = []
    for source, (tmp, target, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[source] = out
        if proc.returncode != 0:
            failures.append(f"{source}:\n{out}")
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    for source in pending:
        _libraries[source] = ctypes.CDLL(str(_library_path(source)))
    return _libraries


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, building everything at first use."""
    return build_all()[source]


@functools.cache
def bind(source: str, name: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of ``source``'s library, typed once per
    process: ``argtypes`` (the stream last) and a ``cudaError`` result."""
    fn = getattr(library(source), name)
    fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
    return fn


def check(family: str, tensors: Sequence[torch.Tensor], contiguous: bool = True) -> bool:
    """Whether the call is the kernel's: raise unless every tensor is on the
    first one's device; False on the CPU (the plain twin's call); on the card,
    raise unless each is float32, 16-byte aligned and, where ``contiguous``,
    contiguous, then True."""
    device = tensors[0].device
    for t in tensors[1:]:
        if t.device != device:
            raise ValueError(f"all tensors must be on {device}, got one on {t.device}")
    if device.type == "cpu":
        return False
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the {family} kernels take float32, got {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"the {family} kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"the {family} kernels take 16-byte aligned tensors")
    return True


def launch(counter: str, fn, device: torch.device, *args) -> None:
    """``fn(*args, stream)`` with ``device`` current for the runtime, on its
    current stream (a tensor argument passes its data pointer), then one
    launch counted in ``counter``. Raises, naming the entry point, on a
    nonzero ``cudaError``; the counter moves only after a launch that
    succeeded."""
    args = tuple(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: cudaError {err}")
    count(counter)


@functools.cache
def sm_count(device: torch.device) -> int:
    """The card's SMs, read once per device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# launch_counts' key -> the counter that launch() bumps for that kernel
LAUNCH_COUNTERS: dict[str, str] = {}


def launch_counts() -> dict[str, int]:
    """Every hand-written kernel's launches, under :data:`LAUNCH_COUNTERS`' keys."""
    totals = counters()
    return {key: totals.get(name, 0) for key, name in LAUNCH_COUNTERS.items()}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTERS.values():
        reset_counters(name)
