#!/usr/bin/env python3
"""Where the time of the dx kernels, or with ``--fwd`` of the forward kernels,
``--dparams`` of the parameter-gradient kernels, ``--dparams-bf16`` of their
bf16 variants, ``--xs-bf16`` of the bf16 per-sample kernels, ``--fwd-bf16``
of the bf16 shared-input forward, ``--dx-bf16`` of the bf16 dx or
``--dparams-bf16-head`` of the bf16 dparams head, goes on the card: the kernels of
``csrc/sampled_dense_dx.cu`` (``sampled_dense_fwd.cu``,
``sampled_dense_dparams.cu``, ``sampled_dense_dparams_bf16.cu``,
``sampled_dense_xs_bf16.cu``, ``sampled_dense_dx_bf16.cu``, and the earlier
designs under ``scripts/comparison_kernels/``) rebuilt with one part cut out
at a time, timed
with ``chip_smoke.py``'s device-time yardstick at the main path's shapes.

    python3 scripts/torch_dx_probe.py [--fwd | --dparams | --dparams-bf16 | --xs-bf16 | --fwd-bf16 | --dx-bf16
                                       | --dparams-bf16-head] [--diagnose] [SASS_DIR]
    python3 scripts/torch_dx_probe.py --family=xs_bf16 --diagnose [--every-split]

``--family=NAME`` probes one entry of ``FAMILIES``; ``--every-split`` runs the
diagnostics at every split, not only the planned one.

Variants: ``full``, the kernel as committed, and ``no-noise``, with each
Philox quad and Box-Muller of the wide kernel replaced by a constant quad (a
text substitution of the source; it computes a wrong result), each at the
split the plan (``dx_plan``, ``fwd_plan``, ``dparams_plan``) picks and at the
other splits listed in ``FAMILIES``. ``--diagnose`` adds, at the planned split, variants that
time parts of the FFMA loop and compute a wrong result. For dx and fwd:
``w-broadcast`` (every lane reads the same W float4s), ``all-broadcast`` (the
same for the other operand, g^T or x^T, too), ``one-stage`` (only the first
work unit or chunk is fetched and drawn: no noise, staging or loads after it),
``one-stage-no-sync`` (and no barrier per unit) and
``all-broadcast-one-stage-no-sync``. For dparams: ``loop-alone`` (no
per-sample epilogue: no noise and no running sums, so the compiler drops the
FFMAs too: staging and barriers alone), ``one-stage`` (only the first chunk
fetched), ``one-stage-loop-alone`` and ``unrolled-epilogue`` (the epilogue's
loop over rows unrolled, a right result: its 16 Philox quads inline),
``epilogue-unroll-2`` and ``epilogue-unroll-4`` (unrolled by 2 or 4), and
``ffma-unroll-4`` and ``ffma-unroll-8`` (the chunk's 16-step FFMA loop
unrolled by 4 or 8, not fully; right results).

``--dparams-bf16`` probes two designs of the wide bf16 dparams kernels. The
earlier one (``dparams_bf16_shared_sums``:
``scripts/comparison_kernels/sampled_dense_dparams_bf16_shared_sums.cu``;
``no-noise`` replaces the quad that ``noise_pair`` draws): ``no-bias`` (no
block sums the bias), ``bias-from-global`` (the bias threads read g's rows
from global memory, not the chunk's f32 copy in shared memory; a right
result), ``no-epilogue`` (no per-sample noise and running sums; the MMAs
stay), ``one-stage`` (only each sample's first chunk staged: the loads and
the staging's shared stores after it cut) and ``one-stage-no-epilogue``. The
committed one (``dparams_bf16``): ``no-noise``; diagnostics described at
``DP_NO_NOISE``, with blocks an SM and active clusters; the narrow head
shape is timed as committed only. ``--fwd-bf16``: the partials design of
the shared-input forward (``fwd_bf16_partials``) and the committed one
(``fwd_bf16``, ``sampled_dense_xs_bf16.cu`` with x's sample stride 0), with
the ``--xs-bf16`` families' diagnostics.

``--dx-bf16`` probes two designs of the bf16 dx at 784→1024: the partials
design (``dx_bf16_partials``:
``scripts/comparison_kernels/sampled_dense_bf16_partials.cu`` on ``dx_plan``,
with the partials diagnostics below) and the warp-specialised one
(``dx_bf16``, ``sampled_dense_dx_bf16.cu`` on ``dx_bf16_plan``, at splits of
8 .. 20 runs): ``no-noise``; diagnostics described at ``DXB_NOISE`` (no
products, no cluster sum, empty, no pass over the partial tiles, the stage count, the copy
lookahead, the draw warps a block, 128-input tiles, smaller clusters, two
blocks an SM), with blocks an SM and active clusters, and the noise floor.
``--dparams-bf16-head`` probes two designs of the bf16 dparams head at
1024→10: the partials design (``dparams_bf16_head_partials``,
``scripts/comparison_kernels/sampled_dense_dparams_bf16_narrow_partials.cu``)
and the current one (``dparams_bf16_head``): ``no-noise``; diagnostics
described at ``HEAD_NOISE`` (no products, no bias, no cluster sum, empty, the
chunk depth, the warps a block, the ranks a cluster), with blocks an SM and
active clusters.

``--xs-bf16`` probes two designs of xs_fwd and xs_dx, each at 1024→1024 and
the 1024→10 head (every variant at the heads too). The partials design
(``xs_bf16_partials``: ``scripts/comparison_kernels/sampled_dense_bf16_partials.cu``
with ``chip_smoke.PARTIALS_BF16`` appended, on ``fwd_plan`` and ``dx_plan``):
``no-noise``; diagnostics ``one-stage`` (the first chunk or unit alone staged
and drawn), ``no-sum-pass`` (the partials' sum kernel removed),
``no-softplus-pass`` and ``no-sum-no-softplus-pass``; with the noise floor of
each shape (``chip_smoke.NOISE_FLOOR_CU``). The committed design
(``xs_bf16``, on ``xs_bf16_plan``): ``no-noise``; diagnostics
``no-cluster-sum`` (each rank stores its rows of rank 0's tile alone),
``one-stage``, ``inline-softplus`` (a right result), ``empty``,
``no-epilogue``, ``no-mma``, ``no-noise-no-mma``, ``no-softplus-pass``,
``two-blocks-an-sm`` and ``draw-first`` (a right result), described at
``XS_NO_CLUSTER_SUM``; and each wide instance's blocks an SM and active
clusters of 1, 2, 3, 4 and 8 (``cudaOccupancyMaxActiveClusters``). All but
those marked right compute a wrong result.

It also counts the SASS instructions of one ``normal4`` (a Philox4x32-10 and
two Box-Muller pairs: four normals) from a one-line probe kernel with
``cuobjdump``, in all and on the path a thread runs, the noise's cost in
instructions per normal.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 128, 10
NOISE = ("const float4 z = normal4(seed, s, i, o >> 2);",
         "const float4 z = make_float4(0.5f, -0.25f, 1.5f, -1.0f);")
W_BROADCAST = [("&wt[buf][k][4 * tc]", "&wt[buf][k][0]"), ("&wt[buf][k][32 + 4 * tc]", "&wt[buf][k][32]")]
NO_SYNC = [("    __syncthreads();\n    buf ^= 1;", "    buf ^= 1;")]
DP_NOISE = [(f"const float4 {z} = normal4(seed, s, i, (o0 + {o}4 * tc) >> 2);",
             f"const float4 {z} = make_float4(0.5f, -0.25f, 1.5f, -1.0f);") for z, o in (("za", ""), ("zb", "32 + "))]
DP_FFMA_LOOP = "#pragma unroll\n    for (int k = 0; k < kDpDepth; ++k) {\n      const float4 xa"
DP_UNROLLED = ("#pragma unroll 1\n    for (int r = 0; r < 8; ++r) {", "#pragma unroll\n    for (int r = 0; r < 8; ++r) {")
DP_EPILOGUE = ("if ((u + 1) % C == 0) finish_sample((int)(u / C));", "")
DP_ONE_STAGE = ("if (u + 1 < u_end) fetch(u + 1, buf ^ 1);", "if (u == u_begin && u + 1 < u_end) fetch(u + 1, buf ^ 1);")
BF_NOISE = ("const float4 z = normal4(seed, s, i, q_base + 2 * (2 * m + odd) + (tq >> 1));",
            "const float4 z = make_float4(0.5f, -0.25f, 1.5f, -1.0f);")
BF_NO_BIAS = ("const bool bias = blockIdx.y == 0 && tid < kWideCols && o0 + tid < O;", "const bool bias = false;")
BF_BIAS_FROM_GLOBAL = ("for (int k = 0; k < rows; ++k) db += gf[k * kGfStride + tid];",
                       "for (int k = 0; k < rows; ++k) db += gs[(size_t)(b0 + k) * O + o0 + tid];")
BF_NO_EPILOGUE = ("#pragma unroll 1\n    for (int r = 0; r < 4; ++r) {", "#pragma unroll 1\n    for (int r = 0; r < 0; ++r) {")
BF_ONE_STAGE = ("      stage_t<kWideRows, kWideThreads>(as, nullptr, xs, B, I, b0, i0);\n"
                "      stage_t<kWideCols, kWideThreads>(bs, gf, gs, B, O, b0, o0);\n",
                "      if (c == 0) stage_t<kWideRows, kWideThreads>(as, nullptr, xs, B, I, b0, i0);\n"
                "      if (c == 0) stage_t<kWideCols, kWideThreads>(bs, gf, gs, B, O, b0, o0);\n")


def family(source: str, shapes, row_operand: str, unit: str) -> dict:
    """A kernel source's probe: its shapes (name, I, O, splits to try), its
    swaps. ``row_operand``: the shared array read per row group (gt, xt);
    ``unit``: the loop variable of the work units (u, c)."""
    a_broadcast = [(f"&{row_operand}[buf][k][8 * tr]", f"&{row_operand}[buf][k][0]"),
                   (f"&{row_operand}[buf][k][8 * tr + 4]", f"&{row_operand}[buf][k][4]")]
    one_stage = [(f"if (more) fetch({unit} + 1);", f"if (more && {unit} == {unit}_begin) fetch({unit} + 1);"),
                 (f"if (more) stage({unit} + 1, buf ^ 1);",
                  f"if (more && {unit} == {unit}_begin) stage({unit} + 1, buf ^ 1);")]
    return {
        "source": source, "shapes": shapes,
        "variants": {"full": (), "no-noise": (NOISE,)},
        "diagnostics": {  # timing only: each computes a wrong result
            "w-broadcast": tuple(W_BROADCAST),
            "all-broadcast": tuple(W_BROADCAST + a_broadcast),
            "one-stage": tuple(one_stage),
            "one-stage-no-sync": tuple(one_stage + NO_SYNC),
            "all-broadcast-one-stage-no-sync": tuple(W_BROADCAST + a_broadcast + one_stage + NO_SYNC),
        },
    }


FAMILIES = {
    "dx": family("sampled_dense_dx.cu", (("sampled_dense_dx", 784, 1024, (20, 40)),
                                         ("sampled_dense_xs_dx", 1024, 1024, (2, 3, 4))), "gt", "u"),
    "fwd": family("sampled_dense_fwd.cu", (("sampled_dense_fwd", 784, 1024, (1, 2, 4)),
                                           ("sampled_dense_xs_fwd", 1024, 1024, (1, 2, 4))), "xt", "c"),
    "dparams": {
        "source": "sampled_dense_dparams.cu",
        "shapes": (("sampled_dense_dparams", 784, 1024, (1, 2, 3, 4, 5, 8)),
                   ("sampled_dense_xs_dparams", 1024, 1024, (1, 2, 3, 4, 5, 8)),
                   ("sampled_dense_xs_dparams", 1024, 10, (2, 5, 10))),
        "variants": {"full": (), "no-noise": tuple(DP_NOISE)},
        "diagnostics": {
            "loop-alone": (DP_EPILOGUE,),
            "one-stage": (DP_ONE_STAGE,),
            "one-stage-loop-alone": (DP_ONE_STAGE, DP_EPILOGUE),
            "unrolled-epilogue": (DP_UNROLLED,),
            **{f"epilogue-unroll-{n}": ((DP_UNROLLED[0], DP_UNROLLED[0].replace("unroll 1", f"unroll {n}")),)
               for n in (2, 4)},
            **{f"ffma-unroll-{n}": ((DP_FFMA_LOOP, DP_FFMA_LOOP.replace("unroll", f"unroll {n}", 1)),)
               for n in (4, 8)},
        },
    },
    "dparams_bf16_shared_sums": {
        "source": "sampled_dense_dparams_bf16_shared_sums.cu", "dir": "scripts/comparison_kernels",
        "suffix": "_shared_sums",
        "shapes": (("sampled_dense_dparams_bf16_shared_sums", 784, 1024, (1, 2, 4)),
                   ("sampled_dense_xs_dparams_bf16_shared_sums", 1024, 1024, (1, 2, 4))),
        "variants": {"full": (), "no-noise": (BF_NOISE,)},
        "diagnostics": {
            "no-bias": (BF_NO_BIAS,),
            "bias-from-global": (BF_BIAS_FROM_GLOBAL,),
            "no-epilogue": (BF_NO_EPILOGUE,),
            "one-stage": (BF_ONE_STAGE,),
            "one-stage-no-epilogue": (BF_ONE_STAGE, BF_NO_EPILOGUE),
            "one-stage-no-epilogue-no-bias": (BF_ONE_STAGE, BF_NO_EPILOGUE, BF_NO_BIAS),
        },
    },
}
# The partials design of the bf16 forwards and dx
# (scripts/comparison_kernels/sampled_dense_bf16_partials.cu with
# chip_smoke.PARTIALS_BF16 appended): as committed, without the noise, with one
# staged chunk, without the partials' sum pass or the softplus pass
PARTIALS_ONE_STAGE = [("    stage_a<kDepth>(as, xs, B, I, b0, i0);", "    if (c == c_begin) stage_a<kDepth>(as, xs, B, I, b0, i0);"),
                  ("    for (int f = tid; f < kDepth * kQuads; f += kThreads) {",
                   "    for (int f = tid; c == c_begin && f < kDepth * kQuads; f += kThreads) {"),
                  ("    stage_a<kDepth>(as, g + (size_t)s * B * O, B, O, b0, o0);",
                   "    if (u == u_begin) stage_a<kDepth>(as, g + (size_t)s * B * O, B, O, b0, o0);"),
                  ("    for (int f = tid; f < kCols * kQuads; f += kThreads) {",
                   "    for (int f = tid; u == u_begin && f < kCols * kQuads; f += kThreads) {")]
PARTIALS_NO_SUM_PASS = ("    sum_partials_kernel<<<elementwise_blocks(n), 256, 0, stream>>>(partials, out, n, n_split);", "")
PARTIALS_NO_SOFTPLUS_PASS = ("  softplus_kernel<<<elementwise_blocks(n_params), 256, 0, stream>>>(rho, sp, n_params);", "")
XS_SHAPES = (("xs_fwd", 1024, 1024, (1, 2, 3, 4)), ("xs_dx", 1024, 1024, (1, 2, 3, 4)),
             ("xs_fwd", 1024, 10, ()), ("xs_dx", 1024, 10, ()))
PARTIALS_DIAGNOSTICS = {
    "one-stage": tuple(PARTIALS_ONE_STAGE),
    "no-sum-pass": (PARTIALS_NO_SUM_PASS,),
    "no-softplus-pass": (PARTIALS_NO_SOFTPLUS_PASS,),
    "no-sum-no-softplus-pass": (PARTIALS_NO_SUM_PASS, PARTIALS_NO_SOFTPLUS_PASS),
}
FAMILIES["xs_bf16_partials"] = {
    "source": "sampled_dense_bf16_partials.cu", "dir": "scripts/comparison_kernels", "append": "PARTIALS_BF16",
    "suffix": "_partials",
    "shapes": tuple((f"sampled_dense_{k}_bf16_partials", i, o, splits) for k, i, o, splits in XS_SHAPES),
    "variants": {"full": (), "no-noise": (NOISE,)},
    "diagnostics": PARTIALS_DIAGNOSTICS,
}
FAMILIES["fwd_bf16_partials"] = {
    "source": "sampled_dense_bf16_partials.cu", "dir": "scripts/comparison_kernels", "append": "PARTIALS_BF16",
    "suffix": "_partials",
    "shapes": (("sampled_dense_fwd_bf16_partials", 784, 1024, (2, 3, 4)),),
    "variants": {"full": (), "no-noise": (NOISE,)},
    "diagnostics": PARTIALS_DIAGNOSTICS,
}
# The redesigned bf16 per-sample kernels (sampled_dense_xs_bf16.cu): as
# committed, without the noise; at the planned split also without the runs'
# sum over the cluster, with the first two chunks alone copied and drawn, with softplus
# inline on the wide path (no softplus pass; a right result), with nothing
# after the two first chunks' copies ("empty"), without the epilogue, without
# the products (and without the noise), without the softplus pass, with two
# blocks an SM (up to 128 registers) instead of three, and with each chunk's
# draw before its products in program order (a right result)
XS_NO_CLUSTER_SUM = ("    for (int k = 1; k < n_split; ++k) {", "    for (int k = 1; k < 1; ++k) {")
XS_ONE_STAGE = [("    if (c + 2 < c_end)\n      fetch<", "    if (c + 2 < c_end && c < 0)\n      fetch<"),
                ("    if (c + 1 < c_end) {\n", "    if (c + 1 < c_end && c < 0) {\n")]
XS_WIDE_LAUNCH = ("  softplus_kernel<<<elementwise_blocks(n_params), 256, 0, stream>>>(rho, sp, n_params);\n"
                  "  return launch_tiles<kFwd, 64, 16, false, kSharedA>(a, loc, sp,")
XS_INLINE_SOFTPLUS = (XS_WIDE_LAUNCH, "  return launch_tiles<kFwd, 64, 16, true, kSharedA>(a, loc, rho,")
XS_EMPTY = ("  for (int c = c_begin; c < c_end; ++c) {", "  if (n_split > 0) return;\n  for (int c = c_begin; c < c_end; ++c) {")
XS_NO_EPILOGUE = ("  // Park the tile", "  if (n_split > 0) return;\n  // Park the tile")
XS_MMA = ("    mma_stage<kFwd, kCols, kDepth>(stages + it % kXsStages * L::kStage, bs + it % 2 * L::kBHalves, acc);\n")
XS_DRAW = ("    if (c + 1 < c_end) {\n      const float* next = stages + (it + 1) % kXsStages * L::kStage;\n"
           "      draw_w<kFwd, kCols, kDepth, kInlineSoftplus>(bs + (it + 1) % 2 * L::kBHalves, next, seed, s, I, O, n0,\n"
           "                                                   (c + 1) * kDepth);\n    }\n")
XS_DRAW_FIRST = (XS_MMA + XS_DRAW, XS_DRAW + XS_MMA)
XS_NO_MMA = (XS_MMA, "")
XS_NO_SOFTPLUS_PASS = ("  softplus_kernel<<<elementwise_blocks(n_params), 256, 0, stream>>>(rho, sp, n_params);\n", "")
XS_TWO_BLOCKS_AN_SM = ("__launch_bounds__(kXsThreads, 3)", "__launch_bounds__(kXsThreads, 2)")
# Appended to the full build: blocks an SM and active clusters of each wide instance
XS_OCCUPANCY = """
extern "C" int xs_occupancy(int fwd, int n_split, int* blocks, int* clusters) {
  using namespace sampled_dense;
  auto* kernel = fwd ? xs_bf16_kernel<true, 64, 16, false> : xs_bf16_kernel<false, 64, 16, false>;
  const int bytes = fwd ? XsLayout<true, 64, 16>::kBytes : XsLayout<false, 64, 16>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kXsThreads, bytes);
  cudaLaunchAttribute cluster_dims;
  cluster_dims.id = cudaLaunchAttributeClusterDimension;
  cluster_dims.val.clusterDim.x = 1, cluster_dims.val.clusterDim.y = 1, cluster_dims.val.clusterDim.z = n_split;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(16, 10, n_split);
  config.blockDim = dim3(kXsThreads);
  config.dynamicSmemBytes = bytes;
  config.attrs = &cluster_dims;
  config.numAttrs = 1;
  if (!err) err = cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
  return (int)err;
}
"""
FAMILIES["xs_bf16"] = {
    "source": "sampled_dense_xs_bf16.cu",
    "shapes": (("sampled_dense_xs_fwd_bf16", 1024, 1024, (1, 2, 3, 4, 6, 8)),
               ("sampled_dense_xs_dx_bf16", 1024, 1024, (1, 2, 3, 4, 6, 8)),
               ("sampled_dense_xs_fwd_bf16", 1024, 10, (2, 4, 8)), ("sampled_dense_xs_dx_bf16", 1024, 10, ())),
    "variants": {"full": (), "no-noise": (NOISE,)},
    "diagnostics": {
        "no-cluster-sum": (XS_NO_CLUSTER_SUM,),
        "one-stage": tuple(XS_ONE_STAGE),
        "inline-softplus": (XS_INLINE_SOFTPLUS,),
        "empty": (XS_EMPTY,),
        "no-epilogue": (XS_NO_EPILOGUE,),
        "no-mma": (XS_NO_MMA,),
        "no-noise-no-mma": (NOISE, XS_NO_MMA),
        "no-softplus-pass": (XS_NO_SOFTPLUS_PASS,),
        "two-blocks-an-sm": (XS_TWO_BLOCKS_AN_SM,),
        "draw-first": (XS_DRAW_FIRST,),
    },
    "append_full": "XS_OCCUPANCY",
}
# The shared-input forward: the same source and diagnostics at fwd's shape
FAMILIES["fwd_bf16"] = {
    **FAMILIES["xs_bf16"],
    "shapes": (("sampled_dense_fwd_bf16", 784, 1024, (1, 2, 3, 4, 6, 8)),),
}
# The redesigned wide bf16 dparams kernels (sampled_dense_dparams_bf16.cu): as
# committed, without the noise; at the planned split also without the runs'
# sum over the cluster, with the first two units alone copied, without the
# products, without the noise and the products, without the bias, without the
# per-sample epilogue (so without the products, whose results it alone
# reads), with nothing after the prologue ("empty"), with each chunk's share
# of the noise drawn after its products ("draw-last") or two quads at a time
# ("draw-unroll-2"), with the bias summed by the last input tile's blocks
# ("bias-last-tile"; these three right results); and the wide kernel's
# blocks an SM and active clusters of 1, 2, 3, 4 and 8
DP_NO_NOISE = ("const float4 z = i < I && o < O ? normal4(seed, s, i, o >> 2) : make_float4(0.f, 0.f, 0.f, 0.f);",
               "const float4 z = make_float4(0.5f, -0.25f, 1.5f, -1.0f);")
DP_PEER = "\n      const float* peer = cluster.map_shared_rank(park, k);"
DP_NO_CLUSTER_SUM = ("    for (int k = 1; k < n_split; ++k) {" + DP_PEER, "    for (int k = 1; k < 1; ++k) {" + DP_PEER)
DP_BF16_ONE_STAGE = ("    if (u + 2 < U)\n      fetch_unit", "    if (u + 2 < U && u < 0)\n      fetch_unit")
DP_NO_MMA = ("    mma_unit(stage, wm, wn, acc);\n", "")
DP_NO_BIAS = ("const bool bias = blockIdx.y == 0 && tid < kWideCols && o0 + tid < O;", "const bool bias = false;")
DP_BIAS_LAST_TILE = (DP_NO_BIAS[0], DP_NO_BIAS[0].replace("blockIdx.y == 0", "blockIdx.y == gridDim.y - 1"))
DP_NO_EPILOGUE = ("    if (c == C - 1) {  // the sample's last", "    if (c == C - 1 && c < 0) {  // the sample's last")
DP_EMPTY = ("  for (int u = 0; u < U; ++u) {", "  if (n_split > 0) return;\n  for (int u = 0; u < U; ++u) {")
DP_MMA = "    mma_unit(stage, wm, wn, acc);\n"
DP_DRAW = ("    for (int k = kEpsQuads * c / C; k < kEpsQuads * (c + 1) / C; ++k) "
           "draw_eps(eps, seed, s, I, O, i_w, o_w, k);\n")
DP_STAGE = "    const float* stage = stages + u % kWideStages * kStageFloats;\n"
DP_DRAW_LAST = (DP_DRAW + DP_STAGE + DP_MMA, DP_STAGE + DP_MMA + DP_DRAW)
DP_DRAW_UNROLL_2 = (DP_DRAW, "#pragma unroll 2\n" + DP_DRAW)
DP_OCCUPANCY = """
extern "C" int dparams_occupancy(int per_sample, int n_split, int* blocks, int* clusters) {
  using namespace sampled_dense;
  auto* kernel = per_sample ? dparams_bf16_wide_kernel<true> : dparams_bf16_wide_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideSmemBytes);
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kWideThreads, kWideSmemBytes);
  cudaLaunchAttribute cluster_dims;
  cluster_dims.id = cudaLaunchAttributeClusterDimension;
  cluster_dims.val.clusterDim.x = 1, cluster_dims.val.clusterDim.y = 1, cluster_dims.val.clusterDim.z = n_split;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(16, 8, n_split);
  config.blockDim = dim3(kWideThreads);
  config.dynamicSmemBytes = kWideSmemBytes;
  config.attrs = &cluster_dims;
  config.numAttrs = 1;
  if (!err) err = cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
  return (int)err;
}
"""
FAMILIES["dparams_bf16"] = {
    "source": "sampled_dense_dparams_bf16.cu",
    "shapes": (("sampled_dense_dparams_bf16", 784, 1024, (1, 2, 3, 4, 8)),
               ("sampled_dense_xs_dparams_bf16", 1024, 1024, (1, 2, 3, 4, 8)),
               ("sampled_dense_xs_dparams_bf16", 1024, 10, (2, 5, 10))),
    "variants": {"full": (), "no-noise": (DP_NO_NOISE,)},
    "diagnostics": {
        "no-cluster-sum": (DP_NO_CLUSTER_SUM,),
        "one-stage": (DP_BF16_ONE_STAGE,),
        "no-mma": (DP_NO_MMA,),
        "no-noise-no-mma": (DP_NO_NOISE, DP_NO_MMA),
        "no-bias": (DP_NO_BIAS,),
        "no-epilogue": (DP_NO_EPILOGUE,),
        "empty": (DP_EMPTY,),
        "draw-last": (DP_DRAW_LAST,),
        "bias-last-tile": (DP_BIAS_LAST_TILE,),
        "draw-unroll-2": (DP_DRAW_UNROLL_2,),
    },
    "append_full": "DP_OCCUPANCY",
}
FAMILIES["dx_bf16_partials"] = {
    "source": "sampled_dense_bf16_partials.cu", "dir": "scripts/comparison_kernels", "suffix": "_partials",
    "shapes": (("sampled_dense_dx_bf16_partials", 784, 1024, (20,)),),
    "variants": {"full": (), "no-noise": (NOISE,)},
    "diagnostics": PARTIALS_DIAGNOSTICS,
}
# The warp-specialised bf16 dx (sampled_dense_dx_bf16.cu): as committed, without
# the noise; at the planned split also without the products, without both,
# without the cluster sum, with nothing in the unit loop ("empty"), without the
# pass over the pairs' partial tiles, with 3 stages, copies 1 or 3 units
# ahead, 8 draw warps a block (four quads a thread),
# 32-deep units, 128-input
# tiles (8 MMA warps of 16 rows), clusters of at most 4 or 8 blocks (fewer
# partial tiles a tile; the partials buffer is sized for any) and two blocks
# an SM (at most 80 registers a thread, 51 with 16 draw warps); the stage,
# ahead, warp, depth, tile and cluster swaps compute a right result.
# Appended to the full build: blocks an SM and active clusters of 1, 2, 4, 5
# and 8 blocks.
DXB_NOISE = ("    z[j] = normal4(seed, s, i, o >> 2);", "    z[j] = make_float4(0.5f, -0.25f, 1.5f, -1.0f);")
DXB_NO_MMA = ("      mma_unit_dx<kCols, kDepth>(stages + slot * L::kStage, mw, acc);\n", "")
DXB_NO_CLUSTER_SUM = ("    for (int k = 1; k < cluster_size; ++k) {", "    for (int k = 1; k < 1; ++k) {")
DXB_EMPTY = ("  const int U = (int)(total * (run + 1) / n_split - u_begin);",
             "  const int U = 0 * (int)(total * (run + 1) / n_split - u_begin);")
DXB_CONST = {name: f"constexpr int {name} = {value};" for name, value in (
    ("kDxStages", 4), ("kDxAhead", 2), ("kDxDrawWarps", 16), ("kDxMaxCluster", 2))}
DX_OCCUPANCY = """
extern "C" int dx_occupancy(int cluster_size, int* blocks, int* clusters) {
  using namespace sampled_dense;
  using L = DxLayout<64, 32>;
  auto* kernel = dx_bf16_ws_kernel<64, 32>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, L::kThreads, L::kBytes);
  cudaLaunchAttribute cluster_dims;
  cluster_dims.id = cudaLaunchAttributeClusterDimension;
  cluster_dims.val.clusterDim.x = 1, cluster_dims.val.clusterDim.y = 1, cluster_dims.val.clusterDim.z = cluster_size;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(13, 1, 40);
  config.blockDim = dim3(L::kThreads);
  config.dynamicSmemBytes = L::kBytes;
  config.attrs = &cluster_dims;
  config.numAttrs = 1;
  if (!err) err = cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
  return (int)err;
}
"""
FAMILIES["dx_bf16"] = {
    "source": "sampled_dense_dx_bf16.cu",
    "shapes": (("sampled_dense_dx_bf16", 784, 1024, (8, 10, 12, 13, 16, 20)),),
    "variants": {"full": (), "no-noise": (DXB_NOISE,)},
    "diagnostics": {
        "no-mma": (DXB_NO_MMA,),
        "no-noise-no-mma": (DXB_NOISE, DXB_NO_MMA),
        "no-cluster-sum": (DXB_NO_CLUSTER_SUM,),
        "empty": (DXB_EMPTY,),
        "no-pass": (("  sum_partials_kernel<<<elementwise_blocks(n), 256, 0, stream>>>(partials, dx, n, clusters);\n", ""),),
        "stages-3": ((DXB_CONST["kDxStages"], "constexpr int kDxStages = 3;"),),
        "ahead-1": ((DXB_CONST["kDxAhead"], "constexpr int kDxAhead = 1;"),),
        "ahead-3": ((DXB_CONST["kDxAhead"], "constexpr int kDxAhead = 3;"),),
        "draw-warps-8": ((DXB_CONST["kDxDrawWarps"], "constexpr int kDxDrawWarps = 8;"),),
        "depth-32": (("launch_dx_tiles<kCols, 64>(", "launch_dx_tiles<kCols, 32>("),),
        "cols-128": (("return sampled_dense::launch_dx_bf16<64>(", "return sampled_dense::launch_dx_bf16<128>("),),
        "max-cluster-4": ((DXB_CONST["kDxMaxCluster"], "constexpr int kDxMaxCluster = 4;"),),
        "max-cluster-8": ((DXB_CONST["kDxMaxCluster"], "constexpr int kDxMaxCluster = 8;"),),

        "two-blocks-an-sm": (("__launch_bounds__(DxLayout<kCols, kDepth>::kThreads, 1)",
                              "__launch_bounds__(DxLayout<kCols, kDepth>::kThreads, 2)"),),
    },
    "append_full": "DX_OCCUPANCY",
}
# The bf16 dparams head (O <= 16) of sampled_dense_dparams_bf16.cu, and its
# earlier design (scripts/comparison_kernels/sampled_dense_dparams_bf16_narrow_partials.cu:
# as committed, without the noise): as committed, without the noise; at the
# planned split also without the products, without both, without the bias,
# without the cluster sum, with nothing in the chunk loop ("empty"), 32-row
# chunks, 4 warps (64 inputs) a block, and ranks of at most 8 or 5
# blocks (ranks that hold two runs' bias subtotals); the chunk, warp and rank
# swaps compute a right result. Appended to the full build: blocks an SM and
# active clusters of 2, 5, 8, 10 and 16 ranks.
HEAD_NOISE = ("eps[h] = i < I && 4 * tq < O ? normal4(seed, s, i, tq) : make_float4(0.f, 0.f, 0.f, 0.f);",
              "eps[h] = make_float4(0.5f, -0.25f, 1.5f, -1.0f);")
HEAD_NO_MMA = ("      mma_head(stages + u % kHeadStages * kHeadStage, warp, acc);\n", "")
HEAD_NO_BIAS = ("    head_bias(stages, subtotals, g, S, B, I, O, seed, n_split, r_begin, s_begin, s_end);\n", "")
HEAD_NO_CLUSTER_SUM = ("for (int k = 1; k < n_ranks; ++k) {  // unrolled", "for (int k = 1; k < 1; ++k) {  // unrolled")
HEAD_EMPTY = ("  const int U = (s_end - s_begin) * C;", "  const int U = 0 * (s_end - s_begin) * C;")
HEAD_CONST = {name: f"constexpr int {name} = {value};" for name, value in (
    ("kHeadDepth", 64), ("kHeadWarps", 2), ("kHeadMaxRanks", 16))}
HEAD_OCCUPANCY = """
extern "C" int head_occupancy(int ranks, int* blocks, int* clusters) {
  using namespace sampled_dense;
  auto* kernel = dparams_bf16_head_kernel<true>;
  const int bytes = (kHeadRegion + 2 * 2 * kNarrowO) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kHeadThreads, bytes);
  cudaLaunchAttribute cluster_dims;
  cluster_dims.id = cudaLaunchAttributeClusterDimension;
  cluster_dims.val.clusterDim.x = 1, cluster_dims.val.clusterDim.y = 1, cluster_dims.val.clusterDim.z = ranks;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(32, 1, ranks);
  config.blockDim = dim3(kHeadThreads);
  config.dynamicSmemBytes = bytes;
  config.attrs = &cluster_dims;
  config.numAttrs = 1;
  if (!err) err = cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
  return (int)err;
}
"""
FAMILIES["dparams_bf16_head_partials"] = {
    "source": "sampled_dense_dparams_bf16_narrow_partials.cu", "dir": "scripts/comparison_kernels",
    "suffix": "_partials", "head": True,
    "shapes": (("sampled_dense_xs_dparams_bf16_partials", 1024, 10, (1, 5)),),
    "variants": {"full": (), "no-noise": (BF_NOISE,)},
    "diagnostics": {},
}
FAMILIES["dparams_bf16_head"] = {
    "source": "sampled_dense_dparams_bf16.cu", "head": True,
    "shapes": (("sampled_dense_xs_dparams_bf16", 1024, 10, (1, 2, 5)),
               ("sampled_dense_dparams_bf16", 1024, 10, ())),
    "variants": {"full": (), "no-noise": (HEAD_NOISE,)},
    "diagnostics": {
        "no-mma": (HEAD_NO_MMA,),
        "no-noise-no-mma": (HEAD_NOISE, HEAD_NO_MMA),
        "no-bias": (HEAD_NO_BIAS,),
        "no-cluster-sum": (HEAD_NO_CLUSTER_SUM,),
        "empty": (HEAD_EMPTY,),
        "depth-32": ((HEAD_CONST["kHeadDepth"], "constexpr int kHeadDepth = 32;"),),
        "warps-4": ((HEAD_CONST["kHeadWarps"], "constexpr int kHeadWarps = 4;"),),
        "max-ranks-8": ((HEAD_CONST["kHeadMaxRanks"], "constexpr int kHeadMaxRanks = 8;"),),
        "max-ranks-5": ((HEAD_CONST["kHeadMaxRanks"], "constexpr int kHeadMaxRanks = 5;"),),
    },
    "append_full": "HEAD_OCCUPANCY",
}
NOISE_PROBE = """#include "sampled_dense_common.cuh"
extern "C" __global__ void noise_probe(float4* out, uint32_t seed) {
  out[blockIdx.x * blockDim.x + threadIdx.x] = sampled_dense::normal4(seed, blockIdx.x, threadIdx.x, 7u);
}
"""


def start_variant(build, fam: dict, swaps, workdir: str, tag: str):
    """nvcc on the family's source with ``swaps`` applied, in the background."""
    with open(os.path.join(REPO, fam["dir"], fam["source"]) if "dir" in fam else build.CSRC / fam["source"]) as f:
        source = f.read()
    for old, new in swaps:
        if old not in source:
            raise RuntimeError(f"probe {tag}: the source no longer holds {old!r}")
        source = source.replace(old, new)
    if "append" in fam:
        import chip_smoke

        source += getattr(chip_smoke, fam["append"])
    if tag == "full" and "append_full" in fam:
        source += globals()[fam["append_full"]]
    stem = fam["source"].split(".")[0] + fam.get("suffix", "")
    path = os.path.join(workdir, f"{stem}_{tag}.cu")
    with open(path, "w") as f:
        f.write(source)
    lib = os.path.join(workdir, f"lib{stem}_{tag}.so")
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", lib, path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return stem, lib, proc


def finish_variant(sd, fam: dict, started, tag: str) -> ctypes.CDLL:
    stem, lib, proc = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"probe {tag}: nvcc failed:\n{out}")
    for line in out.splitlines():
        if "Used" in line or "spill" in line:
            print(f"[probe] build {stem} {tag}: {line.strip()}")
    dll = ctypes.CDLL(lib)
    for name, *_ in fam["shapes"]:
        getattr(dll, name).argtypes = sd._SIGNATURES[name.removesuffix(fam.get("suffix", ""))][1]
    return dll


def noise_instructions(build, workdir: str, out_dir: str | None) -> tuple[int, int] | None:
    """SASS instructions of the probe kernel around one normal4, all of them
    and its fast path (:func:`count_sass`), or None without cuobjdump; the
    listing goes to ``out_dir`` when one is given."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        return None
    src, cubin = os.path.join(workdir, "noise_probe.cu"), os.path.join(workdir, "noise_probe.cubin")
    with open(src, "w") as f:
        f.write(NOISE_PROBE)
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-cubin",
                    "-I", str(build.CSRC), "-o", cubin, src], check=True)
    sass = subprocess.run([cuobjdump, "-sass", cubin], check=True, capture_output=True, text=True).stdout
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "normal4_probe.sass"), "w") as f:
            f.write(sass)
    return count_sass(sass)


def count_sass(sass: str) -> tuple[int, int]:
    """(all instructions, instructions on the fast path to the first EXIT) of a
    cuobjdump listing. The fast path leaves out NOPs, branches and the
    fall-through blocks behind a forward ``@!P BRA`` that hold a loop, a call
    or local memory: the never-taken Payne-Hanek reduction of sinf/cosf for
    |x| > 105615 and the slow path of sqrtf."""
    ins = []
    for line in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4})\*/\s+(.*?)\s*;", line)
        if m:
            ins.append((int(m.group(1), 16), m.group(2)))
    slow = set()
    for addr, text in ins:
        m = re.match(r"@!P\d BRA 0x([0-9a-f]+)", text)
        if m and int(m.group(1), 16) > addr:
            region = [(a, t) for a, t in ins if addr < a < int(m.group(1), 16)]
            if any(k in t for _, t in region for k in ("CALL", "STL", "LDG")):
                slow.update(a for a, _ in region)
    exit_at = next(a for a, t in ins if t.startswith("EXIT"))
    skip = ("NOP", "BRA", "BSSY", "BSYNC")
    total = sum(1 for _, t in ins if not t.startswith(skip))
    fast = sum(1 for a, t in ins if a <= exit_at and a not in slow and not t.startswith(skip))
    return total, fast


def planned_split(sd, fam: dict, name: str, i_dim: int, o_dim: int, sms: int) -> int:
    """The split the port's plan picks for ``name`` of ``fam`` at B, S."""
    if fam["source"] == "sampled_dense_xs_bf16.cu":
        return sd.xs_bf16_plan(S, B, i_dim, o_dim, sms, "fwd" if "fwd" in name else "dx").n_split
    if fam["source"] == "sampled_dense_dx_bf16.cu":
        return sd.dx_bf16_plan(S, B, i_dim, o_dim, sms).n_split
    if "dparams_bf16" in name:
        return sd.dparams_bf16_plan(S, B, i_dim, o_dim, sms).n_split
    if "dparams" in name:
        return sd.dparams_plan(S, i_dim, o_dim, sms).n_split
    if "_dx" in name:
        return sd.dx_plan(S, B, i_dim, o_dim, sms, "xs_dx" not in name).n_split
    return sd.fwd_plan(S, B, i_dim, o_dim, sms).n_split


def probe_family(torch, build, sd, kind: str, diagnose: bool, workdir: str, sms: int, rows: list,
                 every_split: bool = False) -> None:
    """Time every variant of ``FAMILIES[kind]`` at its shapes and splits."""
    from chip_smoke import _layer_inputs, device_ms

    fam = FAMILIES[kind]
    tag_line = f"[{kind}-probe]"
    variants = {**fam["variants"], **(fam["diagnostics"] if diagnose else {})}
    started = {tag: start_variant(build, fam, swaps, workdir, tag) for tag, swaps in variants.items()}
    libs = {tag: finish_variant(sd, fam, job, tag) for tag, job in started.items()}
    xs_family = kind.startswith(("xs_bf16", "fwd_bf16"))
    for name, i_dim, o_dim, splits in fam["shapes"]:
        gen = torch.Generator(device="cuda").manual_seed(99)
        loc, rho, bloc, brho = _layer_inputs(torch, gen, i_dim, o_dim)
        sp = torch.empty_like(rho)
        planned = planned_split(sd, fam, name, i_dim, o_dim, sms)
        if "dparams" in name:
            g = torch.randn((S, B, o_dim), generator=gen, device="cuda")
            x = torch.rand((S, B, i_dim) if name.startswith("sampled_dense_xs_dparams") else (B, i_dim),
                           generator=gen, device="cuda")
            outs = [torch.empty((i_dim, o_dim), device="cuda") for _ in range(2)] + \
                [torch.empty((o_dim,), device="cuda") for _ in range(2)]
            head = (g.data_ptr(), x.data_ptr(), rho.data_ptr(), brho.data_ptr())
            scratch = lambda n: (n, 2, i_dim + 1, o_dim)  # noqa: E731
        elif "_dx" in name:
            summed = "xs_dx" not in name
            g = torch.randn((S, B, o_dim), generator=gen, device="cuda")
            outs = [torch.empty((B, i_dim) if summed else (S, B, i_dim), device="cuda")]
            lead = (S,) if not summed else ()
            head = (g.data_ptr(), loc.data_ptr(), rho.data_ptr(), sp.data_ptr())
            scratch = lambda n: (n, *lead, B, i_dim)  # noqa: E731  (dx_bf16: room for any cluster count)
        else:
            x = torch.rand((S, B, i_dim) if "xs_fwd" in name else (B, i_dim), generator=gen, device="cuda")
            outs = [torch.empty((S, B, o_dim), device="cuda")]
            head = (x.data_ptr(), loc.data_ptr(), rho.data_ptr(), bloc.data_ptr(), brho.data_ptr(),
                    sp.data_ptr())
            scratch = lambda n: (n, S, B, o_dim)  # noqa: E731
        if fam["source"] == "sampled_dense_xs_bf16.cu" or ("dparams_bf16" in name and o_dim > 16):
            scratch = lambda n: None  # noqa: E731  (the runs of a tile sum in their cluster)
        for n_split in sorted(set(splits) | {planned}):
            shape = scratch(n_split)
            part = torch.empty(shape, device="cuda") if n_split > 1 and shape else None

            def call(dll, n_split=n_split, part=part):
                stream = torch.cuda.current_stream().cuda_stream  # the capture stream in a graph
                err = getattr(dll, name)(*head, part.data_ptr() if part is not None else None,
                                         *(t.data_ptr() for t in outs), S, B, i_dim, o_dim, 5, n_split,
                                         stream)
                if err:
                    raise RuntimeError(f"{name}: cudaError {err}")

            for tag, dll in libs.items():
                only = fam.get("diagnostic_splits", {}).get(tag)
                if only is not None:
                    if n_split not in only:
                        continue
                elif tag in fam["diagnostics"] and n_split != planned and not every_split:
                    continue
                if o_dim <= 16 and tag != "full" and not xs_family and not fam.get("head"):
                    continue
                ms = device_ms(torch, lambda dll=dll: call(dll))
                rows.append({"kernel": name, "shape": f"I={i_dim} O={o_dim}", "n_split": n_split,
                             "planned": n_split == planned, "variant": tag, "ms": ms})
                print(f"{tag_line} {name} B={B} S={S} I={i_dim} O={o_dim} n_split {n_split}"
                      f"{' (planned)' if n_split == planned else ''}: {tag} {ms:.4f} ms")
        if fam.get("append_full") in ("DX_OCCUPANCY", "HEAD_OCCUPANCY"):
            dx = fam["append_full"] == "DX_OCCUPANCY"
            occ = libs["full"].dx_occupancy if dx else libs["full"].head_occupancy
            occ.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            for size in ((1, 2, 4, 5, 8) if dx else (2, 5, 8, 10, 16)):
                blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
                err = occ(size, ctypes.byref(blocks), ctypes.byref(clusters))
                print(f"{tag_line} {name} I={i_dim} O={o_dim}: {blocks.value} blocks an SM, "
                      f"{clusters.value} active clusters of {size} (cudaError {err})")
        elif "append_full" in fam and o_dim > 16:
            dparams = fam["append_full"] == "DP_OCCUPANCY"
            occ = libs["full"].dparams_occupancy if dparams else libs["full"].xs_occupancy
            occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            for n_split in (1, 2, 3, 4, 8):
                blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
                first = int("xs_dparams" in name) if dparams else int("fwd" in name)
                err = occ(first, n_split, ctypes.byref(blocks), ctypes.byref(clusters))
                print(f"{tag_line} {name} I={i_dim} O={o_dim}: {blocks.value} blocks an SM, "
                      f"{clusters.value} active clusters of {n_split} (cudaError {err})")
        if kind.endswith("_partials") or kind in ("dx_bf16", "dparams_bf16_head") or \
                (kind == "dparams_bf16" and o_dim > 16):
            from chip_smoke import noise_floor_ms

            floor = noise_floor_ms(torch, S, i_dim, o_dim)
            rows.append({"kernel": "noise_floor", "shape": f"I={i_dim} O={o_dim}", "ms": floor})
            print(f"{tag_line} noise floor B={B} S={S} I={i_dim} O={o_dim}: {floor:.4f} ms "
                  f"({S * i_dim * o_dim} normals)")


def main() -> None:
    args = sys.argv[1:]
    family = next((a.split("=", 1)[1] for a in args if a.startswith("--family=")), None)
    kinds = ([family] if family else ["fwd"] if "--fwd" in args else ["dparams"] if "--dparams" in args else
             ["dparams_bf16_shared_sums", "dparams_bf16"] if "--dparams-bf16" in args else
             ["xs_bf16_partials", "xs_bf16"] if "--xs-bf16" in args else
             ["fwd_bf16_partials", "fwd_bf16"] if "--fwd-bf16" in args else
             ["dx_bf16_partials", "dx_bf16"] if "--dx-bf16" in args else
             ["dparams_bf16_head_partials", "dparams_bf16_head"] if "--dparams-bf16-head" in args else ["dx"])
    diagnose = "--diagnose" in args
    sass_dir = next((a for a in args if not a.startswith("--")), None)
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    from chip_smoke import phase_device, start_extra_build, NOISE_FLOOR_CU

    phase_device(torch)
    from robustbnns_tpu_torch.ops import build

    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kinds = [k for k in kinds if k in FAMILIES]
    rows = []
    with tempfile.TemporaryDirectory(prefix="kernel_probe_") as workdir:
        start_extra_build("noise_floor", NOISE_FLOOR_CU, workdir)
        n_instr = noise_instructions(build, workdir, sass_dir)
        if n_instr:
            print(f"[probe] normal4 probe kernel: {n_instr[0]} SASS instructions, {n_instr[1]} on "
                  "the fast path, for 4 normals (with the probe's own indexing and store)")
        for kind in kinds:
            probe_family(torch, build, sd, kind, diagnose, workdir, sms, rows, "--every-split" in args)
    print(json.dumps({f"{'_'.join(kinds)}_probe": rows, "normal4_sass_instructions": n_instr}))


if __name__ == "__main__":
    main()
