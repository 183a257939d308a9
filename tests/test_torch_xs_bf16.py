"""The bf16 per-sample kernels of ``csrc/sampled_dense_xs_bf16.cu`` on the CPU.

The source runs through the g++ emulation of ``tests/test_torch_kernel_emulation.py``
(``tests/cuda_emulation/``: one std::thread per CUDA thread, the blocks of a
cluster at once, ``mma.sync`` and ``ldmatrix`` as block-barrier stand-ins).
Held here:

* ``sampled_dense_xs_fwd_bf16`` and ``sampled_dense_xs_dx_bf16`` against their
  bf16 twins with the gates of ``assert_bf16_close`` (the f32 gate plus 2⁻⁷ of
  the largest term |a||W_s|, and nearer the bf16 twin than a tenth of the
  distance from the f32 twin), at ragged shapes on ``xs_bf16_plan``'s
  geometry, at every split of the runs (1 .. 8, one cluster), on the heads'
  tiles and at S = 1; the outputs NaN-filled first, so a missed store shows;
* the same kernels against JAX's Pallas kernels (interpret mode) on bf16
  values at zero scale, where both form the same exact products (1e-5 of
  their O(1) sums);
* ``xs_bf16_plan``: every chunk covered once, runs of one cluster (at most 8,
  dividing the grid's z), no partials, the softplus scratch on the wide path
  only, and the geometry at model_7's shapes on 132 SMs that ``chip_smoke.py``
  prints;
* the ``ldmatrix.x4.trans`` stand-in: its fragments against the PTX layout,
  and through the ``mma.sync`` stand-in a product with a row-major B.
"""
import ctypes
import importlib
import math
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_kernel_emulation as emulation

from robustbnns_tpu.ops import sampled_dense_xs as jax_sampled_dense_xs
from robustbnns_tpu_torch.ops.build import CSRC

sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")

XS_BF16 = ("sampled_dense_xs_fwd_bf16", "sampled_dense_xs_dx_bf16")
SEED = 2026


@pytest.fixture(scope="module")
def xs_library(tmp_path_factory):
    return emulation.build(tmp_path_factory, "sampled_dense_xs_bf16.cu", XS_BF16)


def layer(shape, kind):
    """Seeded inputs: a (xs for the forward, g for dx) and the layer's params."""
    b, i, o, s = shape
    rng = np.random.default_rng(b * 7919 + i * 31 + o + s)

    def normal(*dims, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.normal(size=dims) * scale + shift).astype(np.float32))

    params = (normal(i, o, scale=0.1), normal(i, o, scale=0.5, shift=-3.0),
              normal(o, scale=0.1), normal(o, scale=0.5, shift=-3.0))
    if kind == "fwd":
        return normal(s, b, i), params
    return normal(s, b, o), params[:2]


def run_xs(dll, kind, a, params, n_samples, n_split):
    """One call (NaN-filled output and softplus scratch), as the wrapper
    makes it: the scratch only where the plan asks for it, no partials."""
    b_dim = a.shape[1]
    i_dim, o_dim = params[0].shape
    plan = sd.xs_bf16_plan(n_samples, b_dim, i_dim, o_dim, 132, kind)
    out = torch.full((n_samples, b_dim, o_dim if kind == "fwd" else i_dim), float("nan"))
    sp = torch.full_like(params[1], float("nan")) if plan.softplus_scratch else None
    err = getattr(dll, f"sampled_dense_xs_{kind}_bf16")(
        a.data_ptr(), *(t.data_ptr() for t in params), sp.data_ptr() if sp is not None else None, None,
        out.data_ptr(), n_samples, b_dim, i_dim, o_dim, SEED, n_split, None)
    assert err == 0
    return out


def check_against_twins(kind, got, a, params, n_samples):
    twin = getattr(sd, f"sampled_dense_xs_{kind}_bf16_plain")(a, *params, n_samples, SEED)
    f32 = getattr(sd, f"sampled_dense_xs_{kind}_plain")(a, *params, n_samples, SEED)
    assert not got.isnan().any()
    emulation.assert_bf16_close(f"xs_{kind}", got, twin, f32, a, params[0], params[1], n_samples, SEED)


@pytest.mark.parametrize("kind,shape,sms,runs", [
    ("fwd", (37, 70, 66, 2), 132, 5),  # wide, O % 4 != 0 and I % 4 != 0: plain loads, two column tiles
    ("fwd", (129, 64, 20, 1), 1, 1),  # wide, two row tiles, a ragged 64-column tile, S = 1: one run
    ("fwd", (9, 64, 20, 2), 2, 2),  # wide, four chunks in two runs
    ("fwd", (9, 130, 20, 1), 1, 3),  # wide, nine chunks in three runs
    ("fwd", (9, 256, 40, 2), 132, 8),  # wide, sixteen chunks in eight runs: the largest cluster
    ("fwd", (37, 70, 10, 3), 132, 2),  # the head's tiles, softplus inline, I ragged over two 64-deep chunks
    ("fwd", (1, 200, 13, 1), 132, 4),  # the head, one row, O % 4 != 0 in the bias quad, S = 1
    ("fwd", (20, 512, 10, 1), 132, 8),  # the head, eight chunks in eight runs, as at model_7
    ("dx", (37, 66, 70, 2), 132, 5),  # wide, O % 4 != 0 and I % 4 != 0: plain loads, two column tiles
    ("dx", (129, 40, 20, 1), 1, 1),  # wide, two row tiles, two chunks of O, S = 1
    ("dx", (9, 20, 48, 1), 1, 3),  # wide, three chunks of O in three runs
    ("dx", (9, 40, 256, 1), 132, 8),  # wide, sixteen chunks of O in eight runs
    ("dx", (37, 70, 10, 3), 132, 1),  # the head: one 16-deep chunk of O, softplus inline
    ("dx", (130, 65, 13, 1), 132, 1),  # the head, two row tiles, O % 4 != 0, S = 1
], ids=lambda v: "B{}_I{}_O{}_S{}".format(*v) if isinstance(v, tuple) else str(v))
def test_xs_bf16_kernels_match_bf16_twins_on_the_cpu(xs_library, kind, shape, sms, runs):
    """Each kernel on the plan's geometry against its bf16 twin."""
    b, i, o, s = shape
    plan = sd.xs_bf16_plan(s, b, i, o, sms, kind)
    assert plan.n_split == runs
    a, params = layer(shape, kind)
    check_against_twins(kind, run_xs(xs_library, kind, a, params, s, plan.n_split), a, params, s)


@pytest.mark.parametrize("kind,shape", [
    ("fwd", (20, 128, 36, 2)),  # wide: eight 16-deep chunks of I
    ("dx", (20, 36, 128, 2)),  # wide: eight 16-deep chunks of O
    ("fwd", (20, 512, 10, 1)),  # the head: eight 64-deep chunks of I
], ids=lambda v: "B{}_I{}_O{}_S{}".format(*v) if isinstance(v, tuple) else str(v))
def test_xs_bf16_kernels_at_every_split(xs_library, kind, shape):
    """Every run count a cluster takes, 1 .. 8, against the twins; the splits
    differ from one another only in the order of their f32 sums."""
    b, i, o, s = shape
    a, params = layer(shape, kind)
    outs = [run_xs(xs_library, kind, a, params, s, n) for n in range(1, sd.XS_MAX_RUNS + 1)]
    for got in outs:
        check_against_twins(kind, got, a, params, s)
    for got in outs[1:]:
        torch.testing.assert_close(got, outs[0], rtol=1e-5, atol=1e-5 * float(outs[0].abs().max()))


def bf16_values(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float()


@pytest.mark.parametrize("kind,shape", [
    ("fwd", (37, 70, 66, 2)), ("fwd", (37, 70, 10, 3)), ("dx", (37, 66, 70, 2)), ("dx", (37, 70, 10, 3)),
], ids=lambda v: "B{}_I{}_O{}_S{}".format(*v) if isinstance(v, tuple) else str(v))
def test_xs_bf16_kernels_match_jax_at_zero_scale(xs_library, kind, shape, monkeypatch):
    """bf16-valued xs (or g), loc and bloc, rho = -30: W_s is loc to the bit
    in both packages, so the kernel and JAX's interpret-mode Pallas kernel
    under ROBUSTBNNS_KERNEL_PRECISION=default form the same exact products."""
    monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "default")
    b, i, o, s = shape
    rng = np.random.default_rng(11)
    xs, g = bf16_values(rng.normal(size=(s, b, i))), bf16_values(rng.normal(size=(s, b, o)))
    loc, bloc = bf16_values(rng.normal(size=(i, o)) * 0.1), bf16_values(rng.normal(size=(o,)) * 0.1)
    rho, brho = torch.full((i, o), -30.0), torch.full((o,), -30.0)
    args = (loc.numpy(), rho.numpy(), bloc.numpy(), brho.numpy(), s, SEED)
    plan = sd.xs_bf16_plan(s, b, i, o, 132, kind)
    if kind == "fwd":
        want = jax_sampled_dense_xs(xs.numpy(), *args)
        got = run_xs(xs_library, kind, xs, (loc, rho, bloc, brho), s, plan.n_split)
    else:
        _, vjp = jax.vjp(lambda x: jax_sampled_dense_xs(x, *args), xs.numpy())
        want = vjp(jnp.asarray(g.numpy()))[0]
        got = run_xs(xs_library, kind, g, (loc, rho), s, plan.n_split)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["fwd", "dx"])
@pytest.mark.parametrize("shape", [(128, 1024, 1024, 10), (128, 1024, 10, 10), (37, 70, 66, 2), (2048, 784, 1024, 10),
                                   (128, 784, 1024, 100), (1, 200, 13, 1), (64, 256, 4000, 2), (9, 40, 256, 1)],
                         ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
@pytest.mark.parametrize("sms", [1, 8, 132])
def test_xs_bf16_plan_covers_every_chunk_once_in_one_cluster(kind, shape, sms):
    """The runs of a tile cover each chunk of the contraction once, in order,
    none empty; there are at most 8 (one cluster) and they divide the grid's
    z; the grid covers every tile; no partials; softplus(rho) in a scratch on
    the wide path only."""
    b, i, o, s = shape
    plan = sd.xs_bf16_plan(s, b, i, o, sms, kind)
    k_dim, n_dim = (i, o) if kind == "fwd" else (o, i)
    assert plan.narrow == (o <= 16) and plan.softplus_scratch == (not plan.narrow)
    assert plan.chunks == math.ceil(k_dim / plan.depth)
    runs = sd.xs_bf16_chunk_runs(plan)
    assert [c for r in runs for c in r] == list(range(plan.chunks)) and all(len(r) for r in runs)
    assert 1 <= plan.n_split <= sd.XS_MAX_RUNS and plan.grid[2] % plan.n_split == 0
    assert plan.grid == (math.ceil(n_dim / plan.cols), s, math.ceil(b / sd.XS_ROWS) * plan.n_split)
    assert not hasattr(plan, "scratch")  # the runs sum in their cluster: no partials
    tiles = plan.grid[0] * plan.grid[1] * plan.grid[2] // plan.n_split
    if tiles >= sd.XS_BLOCKS_PER_SM * sms:
        assert plan.n_split == 1


def test_xs_bf16_plan_at_model_7():
    """The geometry ``chip_smoke.py`` [precision] prints for model_7 (B = 128,
    S = 10) on the H100's 132 SMs."""
    hidden = {kind: sd.xs_bf16_plan(10, 128, 1024, 1024, 132, kind) for kind in ("fwd", "dx")}
    for plan in hidden.values():
        assert (plan.n_split, plan.grid, plan.cols, plan.depth, plan.chunks) == (3, (16, 10, 3), 64, 16, 64)
    head_fwd = sd.xs_bf16_plan(10, 128, 1024, 10, 132, "fwd")
    assert (head_fwd.n_split, head_fwd.grid, head_fwd.cols, head_fwd.depth, head_fwd.chunks) == (8, (1, 10, 8), 16, 64,
                                                                                                   16)
    head_dx = sd.xs_bf16_plan(10, 128, 1024, 10, 132, "dx")
    assert (head_dx.n_split, head_dx.grid, head_dx.cols, head_dx.depth, head_dx.chunks) == (1, (16, 10, 1), 64, 16, 1)
    with pytest.raises(ValueError):
        sd.xs_bf16_plan(10, 128, 1024, 10, 132, "dparams")


LDMATRIX_PROBE = r"""
#include "sampled_dense_mma.cuh"

namespace {
// lane l: r[0..3] of ldmatrix_x4_trans over the 16 x kStride bf16 matrix m
// (row-major, rows 16-byte aligned), addressed as sampled_dense_xs_bf16.cu
// addresses Bs for n8 tiles 0 and 1; then with A (16 x 16, row-major bf16
// pairs in fragment order) the two m16n8k16 products into c.
constexpr int kStride = 24;
__global__ void ldmatrix_probe(const uint16_t* m, const uint32_t* a_frags, uint32_t* frags, float* c) {
  extern __shared__ __align__(16) float dyn[];
  uint16_t* bs = reinterpret_cast<uint16_t*>(dyn);
  const int lane = threadIdx.x;
  for (int k = lane; k < 16 * kStride; k += 32) bs[k] = m[k];
  __syncthreads();
  uint32_t r[4];
  sampled_dense::ldmatrix_x4_trans(r, bs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kStride + 8 * (lane >> 4));
  for (int j = 0; j < 4; ++j) frags[4 * lane + j] = r[j];
  const uint32_t a[4] = {a_frags[4 * lane], a_frags[4 * lane + 1], a_frags[4 * lane + 2], a_frags[4 * lane + 3]};
  float acc[2][4] = {};
  const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
  sampled_dense::mma_bf16_16816(acc[0], a, b0);
  sampled_dense::mma_bf16_16816(acc[1], a, b1);
  for (int t = 0; t < 2; ++t)
    for (int e = 0; e < 4; ++e) c[(2 * t + e / 2) * 64 + lane * 2 + e % 2] = acc[t][e];
}
}  // namespace

extern "C" int probe(const uint16_t* m, const uint32_t* a_frags, uint32_t* frags, float* c) {
  const int grid = 1;
  ldmatrix_probe<<<grid, 32, 16 * kStride * 2, nullptr>>>(m, a_frags, frags, c);
  return 0;
}
"""


@pytest.fixture(scope="module")
def ldmatrix_library(tmp_path_factory):
    gxx = emulation.shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the CPU")
    work = Path(tmp_path_factory.mktemp("ldmatrix"))
    for header in CSRC.glob("*.cuh"):
        (work / header.name).write_text(emulation.EMULATED_HEADERS.get(header.name, str)(header.read_text()))
    src = work / "ldmatrix_probe.cpp"
    src.write_text(emulation.emulated_source(LDMATRIX_PROBE))
    lib = work / "libldmatrix_probe.so"
    done = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-I",
                           str(emulation.EMULATION), "-I", str(work), "-o", str(lib), str(src), "-lpthread"],
                          capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    dll.probe.argtypes = [ctypes.c_void_p] * 4
    return dll


def test_ldmatrix_x4_trans_stand_in_follows_the_ptx_layout_and_feeds_the_mma(ldmatrix_library):
    """Lane 4 gq + tq receives in r[j] the elements (2tq, gq) and (2tq + 1,
    gq) of matrix j (rows from lanes 8j .. 8j+7), the first in the low half;
    so a row-major (k, n) B loaded as sampled_dense_xs_bf16.cu loads it gives
    the m16n8k16 B fragments of n8 tiles 0 and 1, and A B comes out exact."""
    rng = np.random.default_rng(5)
    bmat = bf16_values(rng.normal(size=(16, 24))).to(torch.bfloat16)  # (k, n), 24 bf16 a row
    amat = bf16_values(rng.normal(size=(16, 16))).to(torch.bfloat16)
    bits = lambda t: t.view(torch.int16).numpy().astype(np.uint16)  # noqa: E731
    mb, ma = bits(bmat), bits(amat)
    a_frags = np.zeros((32, 4), np.uint32)  # a[0]: (gq, 2tq ..), a[1]: (gq + 8, ..), a[2]: (gq, 2tq + 8 ..), a[3]
    for lane in range(32):
        gq, tq = divmod(lane, 4)
        for reg, (row, col) in enumerate(((gq, 2 * tq), (gq + 8, 2 * tq), (gq, 2 * tq + 8), (gq + 8, 2 * tq + 8))):
            a_frags[lane, reg] = int(ma[row, col]) | int(ma[row, col + 1]) << 16
    frags = np.zeros((32, 4), np.uint32)
    c = np.zeros((4, 64), np.float32)
    m_flat, a_flat = np.ascontiguousarray(mb), np.ascontiguousarray(a_frags)
    assert ldmatrix_library.probe(m_flat.ctypes.data, a_flat.ctypes.data, frags.ctypes.data, c.ctypes.data) == 0
    for lane in range(32):
        gq, tq = divmod(lane, 4)
        for j in range(4):
            k, n = 2 * tq + 8 * (j & 1), gq + 8 * (j >> 1)
            assert frags[lane, j] == int(mb[k, n]) | int(mb[k + 1, n]) << 16, (lane, j)
    want = amat.double() @ bmat[:, :16].double()  # exact: 16 products of bf16 values, f32 sums of O(1)
    got = np.zeros((16, 16))
    for lane in range(32):
        gq, tq = divmod(lane, 4)
        for t in range(2):
            for e in range(4):
                got[gq + 8 * (e // 2), 8 * t + 2 * tq + e % 2] = c[2 * t + e // 2, 2 * lane + e % 2]
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-5)
