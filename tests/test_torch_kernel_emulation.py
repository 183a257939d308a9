"""The CUDA sources of the port's kernels run on the CPU, against their plain twins.

Every ``csrc/*.cu`` source is built with g++ against ``tests/cuda_emulation/``,
a CPU stand-in for the few CUDA pieces they use (``cuda_runtime.h``: one
std::thread per CUDA thread, a barrier for ``__syncthreads``, a per-launch
buffer for ``extern __shared__``, ``__shfl_xor_sync``; ``cuda_bf16.h``: the
round-to-nearest-even bf16 conversions), with two headers of ``csrc/``
rewritten on their way next to the source: ``cp.async`` of
``sampled_dense_common.cuh`` becomes a plain copy (and ``cp.async.wait_group``
of a source nothing), its named barriers (``bar.sync`` and ``bar.arrive``
with an id and a thread count) calls of ``emulated_named_barrier``, and the
inline PTX of ``mma_bf16_16816`` and ``ldmatrix_x4_trans``
(``sampled_dense_mma.cuh``) calls of ``emulated_mma_m16n8k16_bf16`` and
``emulated_ldmatrix_x4_trans``. Those stand-ins and the shuffle exchange the
32 lanes' registers through a per-block buffer between two barriers of the
warp's 32 threads: safe because every lane of a warp reaches each
``mma.sync`` and shuffle in these kernels (in the warp-specialised dx of
``sampled_dense_dx_bf16.cu`` the MMA warps only), which each call asserts;
the named-barrier stand-in asserts that no thread arrives twice at one
instance of a barrier. The kernels are called through ctypes with
the launch plans of ``ops/sampled_dense.fwd_plan``, ``dx_plan``,
``dparams_plan`` (and ``dparams_bf16_plan``: the bf16 parameter-gradient
kernels also at every split, their bias bit-equal to the f32 kernel's) and
``xs_bf16_plan`` (the bf16 forwards and per-sample dx, held further in
``tests/test_torch_xs_bf16.py``), the grouped conv of ``grouped_conv.cu`` in both of its
layouts against ``F.conv2d``, and ResNet-20's grouped 3×3 conv of ``grouped_conv3x3.cu``,
forward and input gradient, against its plain twins. This checks the kernels' indexing, masking, work split,
fixed-order sum of partials, MMA fragment layout and noise-quad ownership at
ragged shapes on a machine without a card; the card itself is checked by
``tests/test_torch_kernels.py`` and ``chip_smoke.py``. Same gates as there:
the f32 kernels 1e-4 relative plus 1e-4 of the largest entry of their twins;
the bf16 kernels that plus 2⁻⁷ of the largest term |x||W_s| for the
forward and input gradient (a W_s that the C library and torch round an f32
ulp apart may land on the other bf16 neighbour), the f32 gate alone for the
parameter gradients (no W_s is rounded there), and nearer their bf16 twins
than a tenth of their distance from the f32 twins.
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
MMA_ASM = re.compile(r"(void mma_bf16_16816\(.*?\)) \{\n  asm volatile\(.*?\n\}\n", re.S)
CP_ASYNC_WAIT = re.compile(r"(void cp_async_wait_pending\(\)) \{\n  asm volatile\(.*?\n\}\n", re.S)
LDMATRIX_ASM = re.compile(r"(void ldmatrix_x4_trans\(.*?\)) \{\n.*?  asm volatile\(.*?\n\}\n", re.S)
CP_ASYNC = {  # the PTX helpers of the source, as plain copies
    "cp_async16": "__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {\n"
                  "  for (int j = 0; j < 4; ++j) smem[j] = valid ? gmem[j] : 0.f;\n}\n",
    "cp_async4": "__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {\n  *smem = *gmem;\n}\n",
    "cp_async_commit": "__device__ __forceinline__ void cp_async_commit() {}\n",
    "cp_async_wait_all": "__device__ __forceinline__ void cp_async_wait_all() {}\n",
}
NAMED_BARRIERS = {"named_barrier_sync": "true", "named_barrier_arrive": "false"}  # bar.sync waits, bar.arrive not


def emulated_source(source: str) -> str:
    """A kernel source with each launch, dynamic shared array and
    ``cp.async.wait_group`` helper replaced."""

    def launch(m):
        grid, threads, smem, _stream = (p.strip() for p in m.group(2).split(","))
        return f"emulated_launch(dim3({grid}), {threads}, {smem}, [&] {{ {m.group(1)}({m.group(3)}); }});"

    source = DYNAMIC_SHARED.sub(r"float* \1 = emulated_dynamic_shared();", source)
    source = CP_ASYNC_WAIT.sub(r"\1 {}\n", source)  # the stand-in's cp.async copies have landed at once
    return LAUNCH.sub(launch, source)


def emulated_header(source: str) -> str:
    """The shared header with each cp.async helper replaced by a plain copy
    (and ``cp.async.wait_group`` by nothing)."""
    out = source
    for name, body in CP_ASYNC.items():
        one_line = rf"__device__ __forceinline__ void {name}\(\) \{{[^\n]*\}}\n"
        multi_line = rf"__device__ __forceinline__ void {name}\([^)]+\) \{{\n.*?\n\}}\n"
        out, n = re.subn(multi_line if name in ("cp_async16", "cp_async4") else one_line, body, out, count=1,
                         flags=re.S)
        assert n == 1, name
    out, n = CP_ASYNC_WAIT.subn(r"\1 {}\n", out)
    assert n == 1
    for name, wait in NAMED_BARRIERS.items():
        out, n = re.subn(rf"(void {name}\(int id, int count\)) \{{\n  asm volatile\(.*?\n\}}\n",
                         rf"\1 {{\n  emulated_named_barrier(id, count, {wait});\n}}\n", out, flags=re.S)
        assert n == 1, name
    return out


def emulated_mma_header(source: str) -> str:
    """The tensor-core header with the inline PTX of ``mma_bf16_16816`` and
    ``ldmatrix_x4_trans`` replaced by their stand-ins."""
    out, n = MMA_ASM.subn(r"\1 {\n  emulated_mma_m16n8k16_bf16(c, a, b);\n}\n", source)
    assert n == 1
    out, n = LDMATRIX_ASM.subn(r"\1 {\n  emulated_ldmatrix_x4_trans(r, row);\n}\n", out)
    assert n == 1
    return out


EMULATED_HEADERS = {"sampled_dense_common.cuh": emulated_header, "sampled_dense_mma.cuh": emulated_mma_header}


def build(tmp_path_factory, source: str, names, directory: Path = CSRC) -> ctypes.CDLL:
    """``<directory>/<source>`` (``csrc/`` unless given) built with g++ next to
    copies of the headers, those with PTX emulated (a quoted include finds
    them there before ``CSRC``). An entry point ``<port name>_partials`` of a
    comparison source is typed as the port's entry point it stands beside."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    work = tmp_path_factory.mktemp(Path(source).stem)
    for header in CSRC.glob("*.cuh"):
        text = header.read_text()
        (work / header.name).write_text(EMULATED_HEADERS.get(header.name, str)(text))
    src = work / f"{Path(source).stem}.cpp"
    src.write_text(emulated_source((directory / source).read_text()))
    lib = work / f"lib{Path(source).stem}.so"
    done = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                           "-I", str(EMULATION), "-I", str(CSRC), "-o", str(lib), str(src), "-lpthread"],
                          capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    for name in names:
        getattr(dll, name).argtypes = sd.SIGNATURES[name.removesuffix("_partials")][1]
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


def run_dparams(dll, g, x, rho, brho, seed, sms, bf16=False, n_split=None):
    """One dparams call (of the bf16 kernels on dparams_bf16_plan with
    ``bf16``; at ``n_split`` runs where given); NaN-filled outputs and
    scratch, so a missed write shows."""
    (s, b, o), i = g.shape, rho.shape[0]
    plan = sd.dparams_bf16_plan(s, b, i, o, sms) if bf16 else sd.dparams_plan(s, i, o, sms)
    outs = [torch.full((i, o), float("nan")) for _ in range(2)] + [torch.full((o,), float("nan")) for _ in range(2)]
    partials = torch.full(plan.scratch, float("nan")) if plan.scratch else None
    name = ("sampled_dense_xs_dparams" if x.dim() == 3 else "sampled_dense_dparams") + ("_bf16" if bf16 else "")
    fn = getattr(dll, name)
    err = fn(g.data_ptr(), x.data_ptr(), rho.data_ptr(), brho.data_ptr(),
             partials.data_ptr() if partials is not None else None, *(t.data_ptr() for t in outs),
             s, b, i, o, seed, plan.n_split if n_split is None else n_split, None)
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


BF16 = ("sampled_dense_dx_bf16",)
XS_BF16 = ("sampled_dense_fwd_bf16", "sampled_dense_xs_fwd_bf16", "sampled_dense_xs_dx_bf16")
DPARAMS_BF16 = ("sampled_dense_dparams_bf16", "sampled_dense_xs_dparams_bf16")


@pytest.fixture(scope="module")
def bf16_library(tmp_path_factory):
    return build(tmp_path_factory, "sampled_dense_dx_bf16.cu", BF16)


@pytest.fixture(scope="module")
def xs_bf16_library(tmp_path_factory):
    return build(tmp_path_factory, "sampled_dense_xs_bf16.cu", XS_BF16)


def run_bf16(lib, name, a, params, out_shape, n_samples, sms, kind):
    """One bf16 forward (``params`` = loc, rho, bloc, brho) or input-gradient
    (loc, rho) call on its plan: ``sampled_dense_dx_bf16.cu``'s dx on
    dx_bf16_plan with its clusters' partials where the plan has them (no
    softplus scratch); the forwards and xs_dx of ``sampled_dense_xs_bf16.cu``
    on xs_bf16_plan (no partials). NaN-filled output and scratch, so a
    missed write shows."""
    b, i, o = a.shape[-2], *params[0].shape
    if name != "dx":
        plan = sd.xs_bf16_plan(n_samples, b, i, o, sms, kind)
        scratch, sp_needed = (), plan.softplus_scratch
    else:
        plan = sd.dx_bf16_plan(n_samples, b, i, o, sms)
        scratch, sp_needed = plan.scratch, False
    out = torch.full(out_shape, float("nan"))
    sp = torch.full_like(params[1], float("nan")) if sp_needed else None
    partials = torch.full(scratch, float("nan")) if scratch else None
    scratch_ptrs = (t.data_ptr() if t is not None else None for t in (sp, partials))
    err = getattr(lib, f"sampled_dense_{name}_bf16")(a.data_ptr(), *(t.data_ptr() for t in params), *scratch_ptrs,
                                                     out.data_ptr(), n_samples, b, i, o, 2026, plan.n_split, None)
    assert err == 0
    return out


@pytest.fixture(scope="module")
def dparams_bf16_library(tmp_path_factory):
    return build(tmp_path_factory, "sampled_dense_dparams_bf16.cu", DPARAMS_BF16)


def assert_bf16_close(kind, got, twin, f32, a, loc, rho, s, seed):
    """The card's gate of a bf16 forward or input-gradient kernel (a W_s may
    round to the other bf16 neighbour), and nearer its bf16 twin than a tenth
    of its distance from the f32 twin."""
    term = sd.bf16_error_scale(kind, a, loc, rho, s, seed, largest=True)
    err = (got - twin).abs()
    assert (err <= 2.0**-7 * term + 1e-4 * twin.abs() + 1e-4 * float(twin.abs().max())).all(), kind
    assert float(err.max()) < 0.1 * float((got - f32).abs().max()), kind


@pytest.mark.parametrize("shape,sms", [
    ((37, 70, 10, 3), 132),  # the head's narrow tiles, I = 70 ragged over 32-deep chunks
    ((1, 70, 13, 1), 132),  # narrow, one row, O % 4 != 0
    ((37, 70, 66, 2), 132),  # wide, O % 4 != 0 and I % 4 != 0: plain loads, two output tiles
    ((129, 24, 20, 2), 1),  # wide, two row tiles, a ragged 64-output tile, one run: no partials
], ids=lambda v: "B{}_I{}_O{}_S{}".format(*v) if isinstance(v, tuple) else f"{v}sm")
def test_bf16_fwd_kernels_match_bf16_twins_on_the_cpu(xs_bf16_library, shape, sms):
    """Both bf16 forwards against their bf16 twins through the m16n8k16 stand-in
    (the kernel of ``sampled_dense_xs_bf16.cu`` on xs_bf16_plan, fwd with x's
    sample stride 0)."""
    b, i, o, s = shape
    rng = np.random.default_rng(b * 7919 + i * 31 + o)

    def normal(*dims, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.normal(size=dims) * scale + shift).astype(np.float32))

    params = (normal(i, o, scale=0.1), normal(i, o, scale=0.5, shift=-3.0),
              normal(o, scale=0.1), normal(o, scale=0.5, shift=-3.0))
    for x, name in ((normal(b, i), "fwd"), (normal(s, b, i), "xs_fwd")):
        out = run_bf16(xs_bf16_library, name, x, params, (s, b, o), s, sms, "fwd")
        twin = getattr(sd, f"sampled_dense_{name}_bf16_plain")(x, *params, s, 2026)
        f32 = getattr(sd, f"sampled_dense_{name}_plain")(x, *params, s, 2026)
        assert_bf16_close(name, out, twin, f32, x, params[0], params[1], s, 2026)


@pytest.mark.parametrize("shape,sms", [
    ((37, 70, 10, 3), 132),  # the narrow tiles (32 inputs), O = 10
    ((45, 70, 66, 2), 132),  # wide, O % 4 != 0: plain loads; dx split into runs, dxs too
    ((129, 40, 20, 2), 1),  # two row tiles, one run: no partials
], ids=lambda v: "B{}_I{}_O{}_S{}".format(*v) if isinstance(v, tuple) else f"{v}sm")
def test_bf16_dx_kernels_match_bf16_twins_on_the_cpu(bf16_library, xs_bf16_library, shape, sms):
    """Both bf16 input gradients against their bf16 twins through the m16n8k16
    stand-in (xs_dx: the kernel of ``sampled_dense_xs_bf16.cu`` on xs_bf16_plan)."""
    b, i, o, s = shape
    rng = np.random.default_rng(b * 7919 + i * 31 + o)

    def normal(*dims, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.normal(size=dims) * scale + shift).astype(np.float32))

    g, loc, rho = normal(s, b, o), normal(i, o, scale=0.1), normal(i, o, scale=0.5, shift=-3.0)
    for name, lib, out_shape in (("dx", bf16_library, (b, i)), ("xs_dx", xs_bf16_library, (s, b, i))):
        out = run_bf16(lib, name, g, (loc, rho), out_shape, s, sms, "dx")
        twin = getattr(sd, f"sampled_dense_{name}_bf16_plain")(g, loc, rho, s, 2026)
        f32 = getattr(sd, f"sampled_dense_{name}_plain")(g, loc, rho, s, 2026)
        assert_bf16_close(name, out, twin, f32, g, loc, rho, s, 2026)


@pytest.mark.parametrize("shape,sms,runs", [
    ((37, 70, 10, 3), 132, 3),  # the head's narrow path, I = 70 ragged over three input blocks
    ((1, 70, 13, 1), 132, 1),  # narrow, one row, O % 4 != 0 in the last quad: no partials
    ((37, 70, 66, 2), 132, 2),  # wide, O % 4 != 0 and I % 4 != 0: plain loads, two output tiles
    ((65, 24, 20, 3), 132, 3),  # wide, O = 20: a ragged 64-output tile, three 32-row chunks, a cluster of 3
    ((9, 130, 20, 9), 132, 8),  # wide, two input tiles, eight runs: the largest cluster, runs of one or two
    ((45, 70, 66, 2), 1, 1),  # wide, one run
], ids=lambda v: "B{}_I{}_O{}_S{}".format(*v) if isinstance(v, tuple) else str(v))
def test_bf16_dparams_kernels_match_bf16_twins_on_the_cpu(dparams_bf16_library, shape, sms, runs):
    """Both bf16 dparams kernels against their bf16 twins at the f32 gate
    (dloc and drho nearer them than a tenth of their distance from the f32
    twins), and xs_dparams on a broadcast x equal to dparams."""
    b, i, o, s = shape
    g, x, xs, rho, brho = dparams_case(shape)
    got, plan = run_dparams(dparams_bf16_library, g, x, rho, brho, 2026, sms, bf16=True)
    assert plan.n_split == runs
    got_xs, _ = run_dparams(dparams_bf16_library, g, xs, rho, brho, 2026, sms, bf16=True)
    broadcast, _ = run_dparams(dparams_bf16_library, g, x.expand(s, b, i).contiguous(), rho, brho, 2026, sms,
                               bf16=True)
    for outs, inp in ((got, x), (got_xs, xs)):
        twin = sd.sampled_dense_dparams_bf16_plain(g, inp, rho, brho, s, 2026)
        f32 = sd.sampled_dense_dparams_plain(g, inp, rho, brho, s, 2026)
        for k, (got_t, want_t, f32_t) in enumerate(zip(outs, twin, f32)):
            torch.testing.assert_close(got_t, want_t, rtol=1e-4, atol=1e-4 * float(want_t.abs().max()))
            if k < 2:
                assert float((got_t - want_t).abs().max()) < 0.1 * float((got_t - f32_t).abs().max()), k
    assert all(torch.equal(a, c) for a, c in zip(broadcast, got))


def check_dparams_bf16(outs, g, inp, rho, brho, s):
    """The gates of ``test_bf16_dparams_kernels_match_bf16_twins_on_the_cpu``."""
    twin = sd.sampled_dense_dparams_bf16_plain(g, inp, rho, brho, s, 2026)
    f32 = sd.sampled_dense_dparams_plain(g, inp, rho, brho, s, 2026)
    for k, (got_t, want_t, f32_t) in enumerate(zip(outs, twin, f32)):
        assert not got_t.isnan().any(), k
        torch.testing.assert_close(got_t, want_t, rtol=1e-4, atol=1e-4 * float(want_t.abs().max()))
        if k < 2:
            assert float((got_t - want_t).abs().max()) < 0.1 * float((got_t - f32_t).abs().max()), k


@pytest.mark.parametrize("shape", [
    (45, 130, 20, 9),  # two ragged chunks, two input tiles (the second of 2 rows), I % 4 != 0: plain loads of x
    (129, 68, 72, 8),  # five chunks (the last of one row): eps quads 1, 2, 1, 2, 2 a chunk; cp.async for both
    (300, 24, 20, 8),  # ten chunks: some draw no eps quad; O = 20 a ragged output tile
    (1, 40, 130, 8),  # one row, one chunk draws all eight quads; three output tiles, O % 4 != 0: plain loads of g
], ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
def test_bf16_dparams_wide_kernel_at_every_split(dparams_bf16_library, dparams_library, shape):
    """The wide bf16 kernel at every run count a cluster takes (1 .. 8 runs of
    the S samples) against the bf16 twins, both variants; the splits differ
    from one another only in the order of their f32 sums; the bias
    cotangents bit-equal to the f32 kernel's at the same split (the same
    sums of the unrounded g in the same order)."""
    b, i, o, s = shape
    g, x, xs, rho, brho = dparams_case(shape)
    first = None
    for n_split in range(1, min(s, sd.DP_MAX_RUNS) + 1):
        got, _ = run_dparams(dparams_bf16_library, g, x, rho, brho, 2026, 132, bf16=True, n_split=n_split)
        got_xs, _ = run_dparams(dparams_bf16_library, g, xs, rho, brho, 2026, 132, bf16=True, n_split=n_split)
        check_dparams_bf16(got, g, x, rho, brho, s)
        check_dparams_bf16(got_xs, g, xs, rho, brho, s)
        f32, _ = run_dparams(dparams_library, g, x, rho, brho, 2026, 132, n_split=n_split)
        assert torch.equal(got[2], f32[2]) and torch.equal(got[3], f32[3]), n_split
        if first is None:
            first = got
        for got_t, first_t in zip(got, first):
            torch.testing.assert_close(got_t, first_t, rtol=1e-5, atol=1e-5 * float(first_t.abs().max()))


@pytest.mark.parametrize("shape", [(128, 784, 1024, 10), (128, 1024, 1024, 10), (128, 1024, 10, 10), (1, 2, 32, 1),
                                   (2048, 784, 1024, 10), (128, 784, 1024, 100), (64, 256, 4000, 2), (45, 130, 66, 9)],
                         ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
@pytest.mark.parametrize("sms", [1, 8, 132])
def test_dparams_bf16_plan_walks_every_unit_and_quad_once(shape, sms):
    """``dparams_bf16_plan``: the f32 kernel's split (so both sum the bias
    over the same runs of samples) and no partials; on the wide path the f32
    kernel's grid, one cluster of at most 8 runs, every (sample, 32-row
    chunk) unit walked once, in order, by the run of its sample, and each
    warp's 8 eps items a lane drawn once a sample, a share with each chunk;
    on the head (O <= 16) 32-input blocks whose ranks, one cluster of at most
    16, hold every run once, in order, none empty."""
    b, i, o, s = shape
    plan, f32 = sd.dparams_bf16_plan(s, b, i, o, sms), sd.dparams_plan(s, i, o, sms)
    assert (plan.narrow, plan.n_split, plan.scratch) == (f32.narrow, f32.n_split, ())
    assert 1 <= plan.n_split <= s
    if plan.narrow:
        assert plan.chunks == -(-b // sd.DP_HEAD_DEPTH) and plan.ranks == min(plan.n_split, sd.DP_HEAD_MAX_RANKS)
        assert plan.grid == (-(-i // sd.DP_HEAD_COLS) + 1, 1, plan.ranks)
        runs = sd.dparams_bf16_head_runs(plan)
        assert [r for rank in runs for r in rank] == list(range(plan.n_split)) and all(runs)
        return
    assert plan.chunks == -(-b // 32) and plan.grid == f32.grid and plan.ranks == plan.n_split
    assert plan.n_split <= sd.DP_MAX_RUNS and plan.grid == (-(-o // sd.DP_COLS), -(-i // sd.DP_ROWS), plan.n_split)
    units = sd.dparams_bf16_units(plan, s)
    assert len(units) == plan.n_split and all(units)
    assert [(u[0], u[1]) for run in units for u in run] == [(si, c) for si in range(s) for c in range(plan.chunks)]
    for si in range(s):
        items = [k for run in units for (us, _, ks) in run if us == si for k in ks]
        assert items == list(range(sd.DP_BF16_EPS_ITEMS))


@pytest.fixture(scope="module")
def grouped_conv_library(tmp_path_factory):
    gc = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv")
    dll = build(tmp_path_factory, "grouped_conv.cu", ())
    dll.grouped_conv_fwd.argtypes = gc.KINDS[(5, 1, 0)].fwd.argtypes
    dll.grouped_conv_dgrad.argtypes = gc.KINDS[(5, 1, 0)].dgrad.argtypes
    dll.grouped_conv_fwd.restype = dll.grouped_conv_dgrad.restype = ctypes.c_int
    return dll


@pytest.mark.parametrize("b_dim,n_draws,hidden", [
    (3, 2, 128),  # an odd batch: the last block's second image is absent
    (2, 1, 256),  # two output-channel tiles of one draw
    (1, 3, 128),  # one image, three draws
], ids=lambda v: str(v))
@pytest.mark.parametrize("nhwc", [False, True], ids=["nchw", "channels_last"])
def test_grouped_conv_kernel_matches_conv2d_on_the_cpu(grouped_conv_library, b_dim, n_draws, hidden, nhwc):
    """``csrc/grouped_conv.cu`` against ``F.conv2d`` with ``groups=S`` (its
    plain version), input and output in one layout: the same 800-term f32
    sums in another order, held to 1e-5 of the largest output (about
    2⁻²⁴·√800 of a sum, with room). The output starts as NaN, so a missed
    store shows."""
    gc = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv")
    rng = np.random.default_rng(b_dim * 7919 + n_draws * 31 + hidden)
    fmt = torch.channels_last if nhwc else torch.contiguous_format
    x = torch.from_numpy(rng.uniform(size=(b_dim, 32 * n_draws, 12, 12)).astype(np.float32))
    x = x.contiguous(memory_format=fmt)
    w = torch.from_numpy((rng.normal(size=(n_draws, 5, 5, 32, hidden)) / np.sqrt(800)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(n_draws, hidden)).astype(np.float32))
    out = torch.full((b_dim, n_draws * hidden, 8, 8), float("nan")).contiguous(memory_format=fmt)
    args = (x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), b_dim, n_draws)
    assert grouped_conv_library.grouped_conv_fwd(*args, hidden, int(nhwc), None) == 0
    want = gc.grouped_conv_plain(x, w, bias)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    assert grouped_conv_library.grouped_conv_fwd(*args, 96, int(nhwc), None) != 0  # N not a multiple of 128


@pytest.mark.parametrize("sms", [1, 132], ids=["two_images_a_block", "one_image_a_block"])
@pytest.mark.parametrize("nhwc", [False, True], ids=["nchw", "channels_last"])
def test_grouped_conv_dgrad_kernel_matches_its_twin_on_the_cpu(grouped_conv_library, sms, nhwc):
    """The input gradient of ``csrc/grouped_conv.cu`` against its plain twin
    (``F.conv_transpose2d`` with ``groups=S``) at B 3 (the last two-image
    block's second image absent), S 2, N 128, g and dx in one layout; with
    one SM the blocks take two images, with 132 one. The same 3,200-term f32
    sums in another order, held to 1e-5 of the largest entry; dx starts as
    NaN, so a missed store shows. An N that is not a multiple of 32 is
    refused."""
    gc = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv")
    b_dim, n_draws, hidden = 3, 2, 128
    rng = np.random.default_rng(2 * sms + nhwc)
    fmt = torch.channels_last if nhwc else torch.contiguous_format
    g = torch.from_numpy(rng.normal(size=(b_dim, n_draws * hidden, 8, 8)).astype(np.float32))
    g = g.contiguous(memory_format=fmt)
    w = torch.from_numpy((rng.normal(size=(n_draws, 5, 5, 32, hidden)) / np.sqrt(800)).astype(np.float32))
    dx = torch.full((b_dim, n_draws * 32, 12, 12), float("nan")).contiguous(memory_format=fmt)
    args = (g.data_ptr(), w.data_ptr(), dx.data_ptr(), b_dim, n_draws)
    assert grouped_conv_library.grouped_conv_dgrad(*args, hidden, int(nhwc), sms, None) == 0
    want = gc.dgrad5x5_plain(g, w)
    torch.testing.assert_close(dx, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    assert grouped_conv_library.grouped_conv_dgrad(*args, 120, int(nhwc), sms, None) != 0  # N not a multiple of 32


@pytest.fixture(scope="module")
def grouped_conv3x3_library(tmp_path_factory):
    kind = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv").KINDS[(3, 1, 1)]
    dll = build(tmp_path_factory, "grouped_conv3x3.cu", ())
    dll.grouped_conv3x3_fwd.argtypes = kind.fwd.argtypes
    dll.grouped_conv3x3_dgrad.argtypes = kind.dgrad.argtypes
    dll.grouped_conv3x3_fwd.restype = dll.grouped_conv3x3_dgrad.restype = ctypes.c_int
    return dll


@pytest.mark.parametrize("shape", [(16, 16, 1), (16, 32, 2), (32, 32, 1), (32, 64, 2), (64, 64, 1)],
                         ids=lambda s: "Ci{}_Co{}_stride{}".format(*s))
def test_grouped_conv3x3_kernel_matches_its_plain_twins_on_the_cpu(grouped_conv3x3_library, shape):
    """``csrc/grouped_conv3x3.cu`` in both modes against its plain twins at
    each of ResNet-20's shapes, B 2, S 2, on the sides the kernel is built
    for: the forward against ``F.conv2d`` with ``groups=S``, the input
    gradient against the rotated conv (stride 1) or the four parity classes
    (stride 2). The same f32 sums of at most 9·64 terms in another order,
    held to 1e-5 of the largest output. The outputs start as NaN, so a missed
    store shows; a shape the kernel does not take is refused."""
    gc = importlib.import_module("robustbnns_tpu_torch.ops.grouped_conv")
    c_in, c_out, stride = shape
    side, b_dim, n_draws = gc.SHAPES3X3[shape], 2, 2
    rng = np.random.default_rng(c_in * 7919 + c_out * 31 + stride)

    def tensor(*dims, scale=1.0):
        return torch.from_numpy((rng.normal(size=dims) * scale).astype(np.float32))

    x = tensor(b_dim, n_draws * c_in, side, side)
    w = tensor(n_draws, 3, 3, c_in, c_out, scale=1 / np.sqrt(9 * c_in))
    bias = tensor(n_draws, c_out)
    g = tensor(b_dim, n_draws * c_out, side // stride, side // stride)
    lib = grouped_conv3x3_library
    out = torch.full((b_dim, n_draws * c_out, side // stride, side // stride), float("nan"))
    assert lib.grouped_conv3x3_fwd(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), b_dim, n_draws,
                                   c_in, c_out, stride, side, None) == 0
    want = gc.grouped_conv_plain(x, w, bias, stride, 1)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    dx = torch.full(x.shape, float("nan"))
    assert lib.grouped_conv3x3_dgrad(g.data_ptr(), w.data_ptr(), dx.data_ptr(), b_dim, n_draws, c_in, c_out, stride,
                                     side, None) == 0
    want = gc.dgrad3x3_plain(g, w, stride)
    torch.testing.assert_close(dx, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    assert lib.grouped_conv3x3_fwd(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), b_dim, n_draws,
                                   c_in, c_out, 3 - stride, side, None) != 0  # not one of the shapes
