"""The CUDA sources of the sampled-dense kernels run on the CPU, against their plain twins.

``csrc/sampled_dense_fwd.cu``, ``csrc/sampled_dense_dx.cu`` and
``csrc/sampled_dense_dparams.cu`` are built with g++ against
``tests/cuda_emulation/cuda_runtime.h``, a CPU stand-in for the few CUDA pieces
they use (one std::thread per CUDA thread, a barrier for ``__syncthreads``, a
per-launch buffer for ``extern __shared__``; ``cp.async`` of
``sampled_dense_common.cuh`` becomes a plain copy; the headers are copied next
to the source), and called through ctypes with the launch plans of
``ops/sampled_dense.fwd_plan``, ``dx_plan`` and ``dparams_plan``. This checks
the kernels' indexing, masking, work split and fixed-order sum of partials at
ragged shapes on a machine without a card; the card itself is checked by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``. Same tolerance as
there: 1e-4 relative plus 1e-4 of the largest entry.

``csrc/sampled_dense_bf16.cu`` (the bf16 variants) is not built here: its
warp-wide ``mma.sync`` has no one-thread-per-CUDA-thread stand-in, so those
kernels are held to their twins on the card only.
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
DYNAMIC_SHARED = re.compile(r"extern __shared__ __align__\(\d+\) float (\w+)\[\];")
CP_ASYNC = {  # the PTX helpers of the source, as plain copies
    "cp_async16": "__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {\n"
                  "  for (int j = 0; j < 4; ++j) smem[j] = valid ? gmem[j] : 0.f;\n}\n",
    "cp_async_commit": "__device__ __forceinline__ void cp_async_commit() {}\n",
    "cp_async_wait_all": "__device__ __forceinline__ void cp_async_wait_all() {}\n",
}


def emulated_source(source: str) -> str:
    """A kernel source with each launch and dynamic shared array replaced."""

    def launch(m):
        grid, threads, smem, _stream = (p.strip() for p in m.group(2).split(","))
        return f"emulated_launch(dim3({grid}), {threads}, {smem}, [&] {{ {m.group(1)}({m.group(3)}); }});"

    source = DYNAMIC_SHARED.sub(r"float* \1 = emulated_dynamic_shared();", source)
    return LAUNCH.sub(launch, source)


def emulated_header(source: str) -> str:
    """The shared header with each cp.async helper replaced by a plain copy."""
    out = source
    for name, body in CP_ASYNC.items():
        one_line = rf"__device__ __forceinline__ void {name}\(\) \{{[^\n]*\}}\n"
        multi_line = rf"__device__ __forceinline__ void {name}\([^)]+\) \{{\n.*?\n\}}\n"
        out, n = re.subn(one_line if name != "cp_async16" else multi_line, body, out, count=1, flags=re.S)
        assert n == 1, name
    return out


def build(tmp_path_factory, source: str, names) -> ctypes.CDLL:
    """``csrc/<source>`` built with g++ next to copies of the headers, the
    shared one emulated (a quoted include finds them there before ``CSRC``)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    work = tmp_path_factory.mktemp(Path(source).stem)
    for header in CSRC.glob("*.cuh"):
        text = header.read_text()
        (work / header.name).write_text(emulated_header(text) if header.name == "sampled_dense_common.cuh" else text)
    src = work / f"{Path(source).stem}.cpp"
    src.write_text(emulated_source((CSRC / source).read_text()))
    lib = work / f"lib{Path(source).stem}.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", str(EMULATION), "-I", str(CSRC), "-o", str(lib), str(src), "-lpthread"],
                   check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    for name in names:
        getattr(dll, name).argtypes = sd._SIGNATURES[name][1]
        getattr(dll, name).restype = ctypes.c_int
    return dll


@pytest.fixture(scope="module")
def dx_library(tmp_path_factory):
    return build(tmp_path_factory, "sampled_dense_dx.cu", ("sampled_dense_dx", "sampled_dense_xs_dx"))


@pytest.fixture(scope="module")
def fwd_library(tmp_path_factory):
    return build(tmp_path_factory, "sampled_dense_fwd.cu", ("sampled_dense_fwd", "sampled_dense_xs_fwd"))


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


def run_fwd(dll, x, loc, rho, bloc, brho, n_samples, seed, sms):
    """One forward call; NaN-filled outputs and scratch, so a missed write shows."""
    b, i = x.shape[-2:]
    o = loc.shape[1]
    plan = sd.fwd_plan(n_samples, b, i, o, sms)
    out = torch.full((n_samples, b, o), float("nan"))
    sp = None if plan.narrow else torch.full_like(rho, float("nan"))
    partials = torch.full(plan.scratch, float("nan")) if plan.scratch else None
    fn = dll.sampled_dense_xs_fwd if x.dim() == 3 else dll.sampled_dense_fwd
    err = fn(x.data_ptr(), loc.data_ptr(), rho.data_ptr(), bloc.data_ptr(), brho.data_ptr(),
             *(t.data_ptr() if t is not None else None for t in (sp, partials)), out.data_ptr(),
             n_samples, b, i, o, seed, plan.n_split, None)
    assert err == 0
    return out, plan


@pytest.mark.parametrize("shape,sms,runs", [
    ((37, 70, 10, 3), 132, 3),  # the head's narrow path, I = 70 ragged over three 32-deep runs
    ((1, 70, 13, 1), 132, 3),  # narrow, one row, O % 4 != 0 in the bias quad
    ((129, 2, 2, 2), 132, 1),  # narrow, two row tiles, O = 2, I = 2: one chunk
    ((5, 200, 10, 40), 132, 7),  # narrow at S = 40
    ((5, 200, 10, 40), 1, 1),  # the same with one run: no partials
    ((37, 70, 66, 2), 132, 5),  # wide, O % 4 != 0 and I % 4 != 0: plain loads, two output tiles
    ((8, 24, 20, 3), 132, 2),  # wide, O = 20: a ragged 64-output tile
    ((129, 2, 32, 1), 132, 1),  # wide, the Half Moons hidden layer: two row tiles, I = 2
    ((1, 200, 68, 1), 132, 13),  # wide, I of 13 chunks, one run each
    ((37, 200, 68, 40), 1, 1),  # wide at S = 40, one run
], ids=lambda v: "B{}_I{}_O{}_S{}".format(*v) if isinstance(v, tuple) else str(v))
def test_fwd_kernels_match_twins_on_the_cpu(fwd_library, shape, sms, runs):
    """Both forwards against their twins, and xs_fwd on a broadcast x equal to fwd."""
    b, i, o, s = shape
    rng = np.random.default_rng(b * 7919 + i * 31 + o)

    def normal(*dims, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.normal(size=dims) * scale + shift).astype(np.float32))

    x, xs = normal(b, i), normal(s, b, i)
    params = (normal(i, o, scale=0.1), normal(i, o, scale=0.5, shift=-3.0),
              normal(o, scale=0.1), normal(o, scale=0.5, shift=-3.0))
    seed = 2026
    out, plan = run_fwd(fwd_library, x, *params, s, seed, sms)
    assert plan.n_split == runs
    out_xs, _ = run_fwd(fwd_library, xs, *params, s, seed, sms)
    broadcast, _ = run_fwd(fwd_library, x.expand(s, b, i).contiguous(), *params, s, seed, sms)
    for got, want in ((out, sd.sampled_dense_fwd_plain(x, *params, s, seed)),
                      (out_xs, sd.sampled_dense_xs_fwd_plain(xs, *params, s, seed))):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    assert torch.equal(broadcast, out)


DPARAMS = ("sampled_dense_dparams", "sampled_dense_xs_dparams")


@pytest.fixture(scope="module")
def dparams_library(tmp_path_factory):
    return build(tmp_path_factory, "sampled_dense_dparams.cu", DPARAMS)


def run_dparams(dll, g, x, rho, brho, seed, sms):
    """One dparams call; NaN-filled outputs and scratch, so a missed write shows."""
    (s, b, o), i = g.shape, rho.shape[0]
    plan = sd.dparams_plan(s, i, o, sms)
    outs = [torch.full((i, o), float("nan")) for _ in range(2)] + [torch.full((o,), float("nan")) for _ in range(2)]
    partials = torch.full(plan.scratch, float("nan")) if plan.scratch else None
    fn = dll.sampled_dense_xs_dparams if x.dim() == 3 else dll.sampled_dense_dparams
    err = fn(g.data_ptr(), x.data_ptr(), rho.data_ptr(), brho.data_ptr(),
             partials.data_ptr() if partials is not None else None, *(t.data_ptr() for t in outs),
             s, b, i, o, seed, plan.n_split, None)
    assert err == 0
    return tuple(outs), plan


def dparams_case(shape):
    b, i, o, s = shape
    rng = np.random.default_rng(b * 7919 + i * 31 + o)

    def normal(*dims, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.normal(size=dims) * scale + shift).astype(np.float32))

    return normal(s, b, o), normal(b, i), normal(s, b, i), normal(i, o, scale=0.5, shift=-3.0), \
        normal(o, scale=0.5, shift=-3.0)


@pytest.mark.parametrize("shape,sms,runs", [
    ((37, 70, 10, 3), 132, 3),  # the head's narrow path, I = 70 ragged over three input blocks
    ((1, 70, 13, 1), 132, 1),  # narrow, one row, O % 4 != 0 in the last quad: no partials
    ((129, 2, 2, 2), 132, 2),  # narrow, O = 2, I = 2, a second 128-row stage of one row
    ((5, 200, 10, 40), 4, 2),  # narrow at S = 40 in two runs of 20 samples
    ((37, 70, 66, 2), 132, 2),  # wide, O % 4 != 0 and I % 4 != 0: plain loads, two output tiles
    ((8, 24, 20, 3), 132, 3),  # wide, O = 20: a ragged 64-output tile
    ((129, 68, 64, 2), 132, 2),  # wide, B = 129: nine chunks, the last of one row
    ((37, 260, 68, 40), 6, 2),  # wide at S = 40: three input tiles, two runs of 20 samples
    ((9, 70, 20, 40), 132, 8),  # wide at S = 40: eight runs of five samples, the largest cluster
    ((45, 70, 66, 2), 1, 1),  # wide, one run: no partials
    ((100, 2, 32, 10), 132, 8),  # wide, the Half Moons hidden layer: I = 2, a cluster of 8 runs
], ids=lambda v: "B{}_I{}_O{}_S{}".format(*v) if isinstance(v, tuple) else str(v))
def test_dparams_kernels_match_twins_on_the_cpu(dparams_library, shape, sms, runs):
    """Both dparams kernels against their twins, and xs_dparams on a broadcast
    x equal to dparams."""
    b, i, o, s = shape
    g, x, xs, rho, brho = dparams_case(shape)
    got, plan = run_dparams(dparams_library, g, x, rho, brho, 2026, sms)
    assert plan.n_split == runs
    got_xs, _ = run_dparams(dparams_library, g, xs, rho, brho, 2026, sms)
    broadcast, _ = run_dparams(dparams_library, g, x.expand(s, b, i).contiguous(), rho, brho, 2026, sms)
    for outs, want in ((got, sd.sampled_dense_dparams_plain(g, x, rho, brho, s, 2026)),
                       (got_xs, sd.sampled_dense_xs_dparams_plain(g, xs, rho, brho, s, 2026))):
        for got_t, want_t in zip(outs, want):
            torch.testing.assert_close(got_t, want_t, rtol=1e-4, atol=1e-4 * float(want_t.abs().max()))
    assert all(torch.equal(a, c) for a, c in zip(broadcast, got))
