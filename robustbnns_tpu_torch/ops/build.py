"""Build and load the port's CUDA kernels at first use.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). Libraries go to ``build/kernels/`` at the repo root
(listed in ``.gitignore``), named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one is reused. All sources are compiled
in parallel, one ``nvcc`` process each. ``--use_fast_math`` stays off: it would
change ``logf``/``sinf``/``cosf`` against the plain PyTorch twins.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
SOURCES = ("sampled_dense_fwd.cu", "sampled_dense_dx.cu", "sampled_dense_dparams.cu", "sampled_dense_dx_bf16.cu",
           "sampled_dense_xs_bf16.cu", "sampled_dense_dparams_bf16.cu", "grouped_conv.cu",
           "grouped_conv3x3.cu")

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
