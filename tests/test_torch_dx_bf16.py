"""The bf16 dx kernel of ``csrc/sampled_dense_dx_bf16.cu`` on the CPU.

dx = Σ_s bf16(g_s) bf16(W_s)ᵀ, the Pallas ``_bwd_dx_kernel`` under
``Precision.DEFAULT``. The source runs through the g++ emulation of
``tests/test_torch_kernel_emulation.py`` (``tests/cuda_emulation/``: one
std::thread per CUDA thread; ``mma.sync`` exchanging the registers of one
warp, here the MMA warps only; ``bar.sync`` and ``bar.arrive`` on named
barriers, asserting that no thread arrives twice at one instance; the blocks
of a cluster at once). Held here:

* the kernel against its bf16 twin with the gates of ``assert_bf16_close``
  (the f32 gate plus 2⁻⁷ of the largest term |g||W_s|, and nearer the bf16
  twin than a tenth of the distance from the f32 twin), at ragged shapes on
  ``dx_bf16_plan``'s geometry (the narrow 16-deep units, a run across
  chunks of O, plain loads where O % 4 != 0, two row tiles, a tile's runs in
  several clusters whose partial tiles the pass sums) and at every split of a
  tile's units (1 .. 8 runs wide, 1 .. 16 narrow: clusters of one block or a
  pair, one to sixteen clusters a tile); the output NaN-filled first, so a
  missed store shows; bit-identical repeats;
* the kernel against JAX's Pallas ``_bwd_dx_kernel`` (interpret mode, the
  VJP of ``sampled_dense`` in x) under ROBUSTBNNS_KERNEL_PRECISION=default on
  bf16 values at zero scale, where both form the same exact products (1e-5 of
  their O(1) sums);
* ``dx_bf16_plan``: every unit (chunk of O, sample) of a tile walked once, in
  order, by one run,
  none empty; clusters that divide the runs, at most a pair; a partials
  scratch exactly when a tile has more than one cluster; and model_7's plan on
  the H100's 132 SMs, which ``chip_smoke.py`` prints;
* the earlier (partials) design, moved to
  ``scripts/comparison_kernels/sampled_dense_bf16_partials.cu`` for
  ``chip_smoke.py`` to time beside the kernel, still builds and meets the same
  twin.
"""
import importlib
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_kernel_emulation as emulation

from robustbnns_tpu.ops import sampled_dense as jax_sampled_dense

sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")

SEED = 2026
COMPARISON = Path(__file__).resolve().parents[1] / "scripts" / "comparison_kernels"


@pytest.fixture(scope="module")
def dx_library(tmp_path_factory):
    return emulation.build(tmp_path_factory, "sampled_dense_dx_bf16.cu", ("sampled_dense_dx_bf16",))


def layer(shape):
    """Seeded g (S, B, O), loc and rho (I, O)."""
    b, i, o, s = shape
    rng = np.random.default_rng(b * 7919 + i * 31 + o + s)

    def normal(*dims, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.normal(size=dims) * scale + shift).astype(np.float32))

    return normal(s, b, o), normal(i, o, scale=0.1), normal(i, o, scale=0.5, shift=-3.0)


def run_dx(dll, g, loc, rho, n_samples, n_split, name="sampled_dense_dx_bf16"):
    """One call at ``n_split`` runs a tile, as the wrapper makes it: the
    clusters' partial tiles where the runs form more than one cluster, no
    softplus scratch; output and scratch NaN-filled."""
    (_, b_dim, o_dim), i_dim = g.shape, loc.shape[0]
    cluster = sd.dx_bf16_cluster(n_split)
    out = torch.full((b_dim, i_dim), float("nan"))
    partials = torch.full((n_split // cluster, b_dim, i_dim), float("nan")) if n_split > cluster else None
    err = getattr(dll, name)(g.data_ptr(), loc.data_ptr(), rho.data_ptr(), None,
                             partials.data_ptr() if partials is not None else None, out.data_ptr(),
                             n_samples, b_dim, i_dim, o_dim, SEED, n_split, None)
    assert err == 0
    return out


def check_against_twins(got, g, loc, rho, n_samples):
    assert not got.isnan().any()
    twin = sd.sampled_dense_dx_bf16_plain(g, loc, rho, n_samples, SEED)
    f32 = sd.sampled_dense_dx_plain(g, loc, rho, n_samples, SEED)
    emulation.assert_bf16_close("dx", got, twin, f32, g, loc, rho, n_samples, SEED)


@pytest.mark.parametrize("shape,sms,runs,clusters", [
    ((37, 70, 66, 2), 132, 2, 1),  # wide, O % 4 != 0 and I % 4 != 0: plain loads, two input tiles, a pair
    ((130, 65, 20, 3), 132, 2, 1),  # wide, two row tiles, a ragged 64-deep unit, three input tiles
    ((1, 40, 130, 3), 132, 2, 1),  # one row, O % 4 != 0: plain loads, three units a sample
    ((37, 70, 10, 3), 132, 2, 1),  # the narrow head: 16-deep units
    ((9, 130, 13, 2), 132, 2, 1),  # narrow, O % 4 != 0, three input tiles
    ((20, 36, 256, 2), 1, 1, 1),  # one run of 8 units over four chunks: the ring wraps twice
    ((8, 64, 640, 3), 132, 6, 3),  # six runs in three pairs: the partial tiles' pass
], ids=lambda v: "B{}_I{}_O{}_S{}".format(*v) if isinstance(v, tuple) else str(v))
def test_dx_bf16_kernel_matches_bf16_twin_on_its_plan(dx_library, shape, sms, runs, clusters):
    """The kernel on the plan's geometry against its bf16 twin; bit-identical
    on a second call."""
    b, i, o, s = shape
    plan = sd.dx_bf16_plan(s, b, i, o, sms)
    assert (plan.n_split, plan.n_split // plan.cluster) == (runs, clusters)
    g, loc, rho = layer(shape)
    got = run_dx(dx_library, g, loc, rho, s, plan.n_split)
    check_against_twins(got, g, loc, rho, s)
    assert torch.equal(got, run_dx(dx_library, g, loc, rho, s, plan.n_split))


@pytest.mark.parametrize("shape", [
    (9, 36, 256, 2),  # wide: 8 units of 64 outputs, one a run at 8 runs
    (21, 40, 10, 16),  # the narrow head: 16 units of 16 outputs, one a run at 16 runs
], ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
def test_dx_bf16_kernel_at_every_split(dx_library, shape):
    """Every run count up to the tile's units (8 wide, 16 narrow): clusters
    of one block or a pair, and 2 .. 16 clusters a tile with their pass;
    against the twins, and within the reordering of their f32 sums of one
    another."""
    b, i, o, s = shape
    g, loc, rho = layer(shape)
    units = s * math.ceil(o / (sd.DXB_NARROW_DEPTH if o <= sd.NARROW_MAX_O else sd.DXB_DEPTH))
    outs = [run_dx(dx_library, g, loc, rho, s, n) for n in range(1, min(16, units) + 1)]
    for got in outs:
        check_against_twins(got, g, loc, rho, s)
    for got in outs[1:]:
        torch.testing.assert_close(got, outs[0], rtol=1e-5, atol=1e-5 * float(outs[0].abs().max()))


def bf16_values(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float()


@pytest.mark.parametrize("shape", [(37, 70, 66, 2), (37, 70, 10, 3), (1, 40, 130, 3)],
                         ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
def test_dx_bf16_kernel_matches_jax_at_zero_scale(dx_library, shape, monkeypatch):
    """bf16-valued g and loc, rho = -30: W_s is loc to the bit in both
    packages, so the kernel and the VJP in x of JAX's interpret-mode
    ``sampled_dense`` (its ``_bwd_dx_kernel``) under
    ROBUSTBNNS_KERNEL_PRECISION=default form the same exact products."""
    monkeypatch.setenv("ROBUSTBNNS_KERNEL_PRECISION", "default")
    b, i, o, s = shape
    rng = np.random.default_rng(13)
    x, g = bf16_values(rng.normal(size=(b, i))), bf16_values(rng.normal(size=(s, b, o)))
    loc, bloc = bf16_values(rng.normal(size=(i, o)) * 0.1), bf16_values(rng.normal(size=(o,)) * 0.1)
    rho, brho = torch.full((i, o), -30.0), torch.full((o,), -30.0)
    args = (loc.numpy(), rho.numpy(), bloc.numpy(), brho.numpy(), s, SEED)
    _, vjp = jax.vjp(lambda a: jax_sampled_dense(a, *args), x.numpy())
    want = np.asarray(vjp(jnp.asarray(g.numpy()))[0])
    got = run_dx(dx_library, g, loc, rho, s, sd.dx_bf16_plan(s, b, i, o, 132).n_split)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert float(np.abs(want).max()) > 0.5


@pytest.mark.parametrize("shape", [(128, 784, 1024, 10), (128, 1024, 10, 1), (37, 784, 13, 3), (1, 784, 1024, 10),
                                   (128, 784, 1024, 100), (2048, 784, 1024, 10), (64, 256, 4000, 2), (9, 36, 256, 2),
                                   (8, 64, 640, 3), (5, 2, 32, 7)],
                         ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
@pytest.mark.parametrize("sms", [1, 8, 132])
def test_dx_bf16_plan_walks_every_unit_once_in_one_run(shape, sms):
    """The runs of a tile cover each unit (chunk of O, sample) once, in
    order, none empty; at most DXB_MAX_SPLIT runs in clusters of at most
    DXB_MAX_CLUSTER blocks that divide them; the grid covers every tile; a
    partials scratch of one tile a cluster exactly when a tile has more
    than one."""
    b, i, o, s = shape
    plan = sd.dx_bf16_plan(s, b, i, o, sms)
    assert plan.narrow == (o <= 16) and not hasattr(plan, "softplus_scratch")
    assert plan.depth == (16 if plan.narrow else 64) and plan.chunks == math.ceil(o / plan.depth)
    assert plan.units == s * plan.chunks
    runs = sd.dx_bf16_unit_runs(plan)
    assert [u for r in runs for u in r] == list(range(plan.units)) and all(len(r) for r in runs)
    assert 1 <= plan.n_split <= min(sd.DXB_MAX_SPLIT, plan.units)
    assert 1 <= plan.cluster <= sd.DXB_MAX_CLUSTER and plan.n_split % plan.cluster == 0
    assert plan.grid == (math.ceil(i / sd.DXB_COLS), math.ceil(b / sd.DXB_ROWS), plan.n_split)
    clusters = plan.n_split // plan.cluster
    assert plan.scratch == ((clusters, b, i) if clusters > 1 else ())
    if sms == 1:
        assert plan.n_split == 1


def test_dx_bf16_plan_at_model_7():
    """The geometry ``chip_smoke.py`` [precision] prints for model_7's first
    layer (B = 128, S = 10, 784 -> 1024) on the H100's 132 SMs: 13 input
    tiles x 10 runs of 16 units (130 blocks, one an SM), each tile's runs in
    five pairs whose partial tiles the pass sums."""
    plan = sd.dx_bf16_plan(10, 128, 784, 1024, 132)
    assert (plan.n_split, plan.cluster, plan.grid, plan.scratch, plan.units) == (
        10, 2, (13, 1, 10), (5, 128, 784), 160)
    assert [len(r) for r in sd.dx_bf16_unit_runs(plan)] == [16] * 10


@pytest.fixture(scope="module")
def partials_library(tmp_path_factory):
    return emulation.build(tmp_path_factory, "sampled_dense_bf16_partials.cu", ("sampled_dense_dx_bf16_partials",),
                           directory=COMPARISON)


@pytest.mark.parametrize("shape", [(45, 70, 66, 2), (37, 70, 10, 3)], ids=lambda s: "B{}_I{}_O{}_S{}".format(*s))
def test_partials_design_still_builds_and_meets_the_twin(partials_library, shape):
    """The earlier design on its own plan (dx_plan: partial planes and their
    pass) against the bf16 twin, as ``chip_smoke.py`` times it."""
    b, i, o, s = shape
    g, loc, rho = layer(shape)
    plan = sd.dx_plan(s, b, i, o, 132, True)
    out = torch.full((b, i), float("nan"))
    sp = torch.full_like(rho, float("nan"))
    partials = torch.full(plan.scratch, float("nan")) if plan.scratch else None
    err = partials_library.sampled_dense_dx_bf16_partials(
        g.data_ptr(), loc.data_ptr(), rho.data_ptr(), sp.data_ptr(),
        partials.data_ptr() if partials is not None else None, out.data_ptr(), s, b, i, o, SEED, plan.n_split, None)
    assert err == 0
    check_against_twins(out, g, loc, rho, s)


@pytest.mark.parametrize("source,constant,value", [
    ("sampled_dense_dx_bf16.cu", "kDxRows", sd.DXB_ROWS),
    ("sampled_dense_dx_bf16.cu", "kDxMaxCluster", sd.DXB_MAX_CLUSTER),
    ("sampled_dense_dx_bf16.cu", "kDxNarrowO", sd.NARROW_MAX_O),
    ("sampled_dense_dparams_bf16.cu", "kHeadDepth", sd.DP_HEAD_DEPTH),
    ("sampled_dense_dparams_bf16.cu", "kHeadMaxRanks", sd.DP_HEAD_MAX_RANKS),
    ("sampled_dense_dparams_bf16.cu", "kHeadWarps", sd.DP_HEAD_COLS // 16),
], ids=lambda v: v if isinstance(v, str) else str(v))
def test_plan_constants_match_the_sources(source, constant, value):
    """The plans' geometry is the kernels' own: each constant a plan assumes
    (tile rows, cluster and rank limits, chunk depth, inputs a head block)
    reads the same in its CUDA source, whose launcher derives the clusters
    and ranks from n_split alone."""
    from robustbnns_tpu_torch.ops.build import CSRC

    text = (CSRC / source).read_text()
    assert f"constexpr int {constant} = {value};" in text
