"""The dx kernels' CUDA source run on the CPU, against their plain twins.

``csrc/sampled_dense_dx.cu`` is built with g++ against
``tests/cuda_emulation/cuda_runtime.h``, a CPU stand-in for the few CUDA
pieces it uses (one std::thread per CUDA thread, a barrier for
``__syncthreads``; ``cp.async`` becomes a plain copy), and called through
ctypes with the launch plan of ``ops/sampled_dense.dx_plan``. This checks the
kernels' indexing, masking, work split and fixed-order sum of partials at
ragged shapes on a machine without a card; the card itself is checked by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``. Same tolerance as
there: 1e-4 relative plus 1e-4 of the largest entry.
"""
import ctypes
import importlib
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from robustbnns_tpu_torch.ops.build import CSRC

sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")

EMULATION = Path(__file__).parent / "cuda_emulation"
LAUNCH = re.compile(r"([\w:]+(?:<[^<>;]*>)?)<<<([^;]*?)>>>\((.*?)\);", re.S)
CP_ASYNC = {  # the PTX helpers of the source, as plain copies
    "cp_async16": "__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {\n"
                  "  for (int j = 0; j < 4; ++j) smem[j] = valid ? gmem[j] : 0.f;\n}\n",
    "cp_async_commit": "__device__ __forceinline__ void cp_async_commit() {}\n",
    "cp_async_wait_all": "__device__ __forceinline__ void cp_async_wait_all() {}\n",
}


def emulated_source(source: str) -> str:
    """The kernel source with each launch and each cp.async helper replaced."""

    def launch(m):
        grid, threads, _smem, _stream = (p.strip() for p in m.group(2).split(","))
        return f"emulated_launch(dim3({grid}), {threads}, [&] {{ {m.group(1)}({m.group(3)}); }});"

    out = LAUNCH.sub(launch, source)
    for name, body in CP_ASYNC.items():
        one_line = rf"__device__ __forceinline__ void {name}\(\) \{{[^\n]*\}}\n"
        multi_line = rf"__device__ __forceinline__ void {name}\([^)]+\) \{{\n.*?\n\}}\n"
        out, n = re.subn(one_line if name != "cp_async16" else multi_line, body, out, count=1, flags=re.S)
        assert n == 1, name
    return out


@pytest.fixture(scope="module")
def dx_library(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    work = tmp_path_factory.mktemp("dx_emulation")
    src = work / "sampled_dense_dx.cpp"
    src.write_text(emulated_source((CSRC / "sampled_dense_dx.cu").read_text()))
    lib = work / "libdx.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(EMULATION), "-I", str(CSRC), "-o", str(lib), str(src), "-lpthread"],
                   check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    for name in ("sampled_dense_dx", "sampled_dense_xs_dx"):
        getattr(dll, name).argtypes = sd._SIGNATURES[name][1]
        getattr(dll, name).restype = ctypes.c_int
    return dll


def run(dll, g, loc, rho, seed, sms, sum_samples):
    (s, b, o), i = g.shape, loc.shape[0]
    plan = sd.dx_plan(s, b, i, o, sms, sum_samples)
    out = torch.full((b, i) if sum_samples else (s, b, i), float("nan"))
    sp = None if plan.narrow else torch.full_like(rho, float("nan"))
    partials = torch.full(plan.scratch, float("nan")) if plan.scratch else None
    fn = dll.sampled_dense_dx if sum_samples else dll.sampled_dense_xs_dx
    err = fn(g.data_ptr(), loc.data_ptr(), rho.data_ptr(), *(t.data_ptr() if t is not None else None
                                                              for t in (sp, partials)),
             out.data_ptr(), s, b, i, o, seed, plan.n_split, None)
    assert err == 0
    return out


@pytest.mark.parametrize("shape,sms", [
    ((8, 24, 20, 3), 132),  # O = 20: a ragged chunk, O % 4 == 0
    ((130, 37, 10, 5), 132),  # the narrow path over two row tiles
    ((9, 300, 10, 2), 132),  # the narrow path over three input blocks
    ((45, 70, 66, 2), 132),  # O % 4 != 0: plain loads, two input tiles
    ((129, 68, 64, 2), 132),  # two row tiles
    ((20, 33, 40, 40), 132),  # dx at its 48-run cap, dxs split in three
    ((5, 130, 100, 7), 1),  # one run per tile: no partials
    ((45, 70, 66, 2), 1),
], ids=lambda v: "B{}_I{}_O{}_S{}".format(*v) if isinstance(v, tuple) else f"{v}sm")
def test_dx_kernels_match_twins_on_the_cpu(dx_library, shape, sms):
    b, i, o, s = shape
    rng = np.random.default_rng(b * 7919 + i * 31 + o)

    def normal(*dims, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.normal(size=dims) * scale + shift).astype(np.float32))

    g, loc, rho, seed = normal(s, b, o), normal(i, o, scale=0.1), normal(i, o, scale=0.5, shift=-3.0), 2026
    dx = run(dx_library, g, loc, rho, seed, sms, sum_samples=True)
    dxs = run(dx_library, g, loc, rho, seed, sms, sum_samples=False)
    for got, want in ((dx, sd.sampled_dense_dx_plain(g, loc, rho, s, seed)),
                      (dxs, sd.sampled_dense_xs_dx_plain(g, loc, rho, s, seed)),
                      (dx, dxs.sum(0))):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
