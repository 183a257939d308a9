#!/usr/bin/env python3
"""Where the time of the dx kernels, or with ``--fwd`` of the forward kernels,
``--dparams`` of the parameter-gradient kernels, ``--dparams-bf16`` of their
bf16 variants or ``--xs-bf16`` of the bf16 per-sample kernels, goes on the
card: the kernels of ``csrc/sampled_dense_dx.cu`` (``sampled_dense_fwd.cu``,
``sampled_dense_dparams.cu``, ``sampled_dense_dparams_bf16.cu``,
``sampled_dense_xs_bf16.cu``) rebuilt with one part cut out at a time, timed
with ``chip_smoke.py``'s device-time yardstick at the main path's shapes.

    python3 scripts/torch_dx_probe.py [--fwd | --dparams | --dparams-bf16 | --xs-bf16] [--diagnose] [SASS_DIR]
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
unrolled by 4 or 8, not fully; right results). For dparams-bf16 (``no-noise``
replaces the quad that ``noise_pair`` draws): ``no-bias`` (no block sums
the bias), ``bias-from-global`` (the bias threads read g's rows from global
memory, not the chunk's f32 copy in shared memory; a right result),
``no-epilogue`` (no per-sample noise and running sums; the MMAs
stay), ``one-stage`` (only each sample's first chunk staged: the loads and
the staging's shared stores after it cut) and ``one-stage-no-epilogue``. The
narrow head shape is timed as committed only.

``--xs-bf16`` probes two designs of xs_fwd and xs_dx, each at 1024→1024 and
the 1024→10 head (every variant at the heads too). The partials design
(``xs_bf16_partials``: ``sampled_dense_bf16.cu`` with
``chip_smoke.PARTIALS_XS_BF16`` appended, on ``fwd_plan`` and ``dx_plan``):
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
    "dparams_bf16": {
        "source": "sampled_dense_dparams_bf16.cu",
        "shapes": (("sampled_dense_dparams_bf16", 784, 1024, (1, 2, 4)),
                   ("sampled_dense_xs_dparams_bf16", 1024, 1024, (1, 2, 4)),
                   ("sampled_dense_xs_dparams_bf16", 1024, 10, (2, 5, 10))),
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
# The partials design of the bf16 per-sample kernels (sampled_dense_bf16.cu with
# chip_smoke.PARTIALS_XS_BF16 appended): as committed, without the noise, with one
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
FAMILIES["xs_bf16_partials"] = {
    "source": "sampled_dense_bf16.cu", "append": "PARTIALS_XS_BF16", "suffix": "_partials",
    "shapes": tuple((f"sampled_dense_{k}_bf16_partials", i, o, splits) for k, i, o, splits in XS_SHAPES),
    "variants": {"full": (), "no-noise": (NOISE,)},
    "diagnostics": {
        "one-stage": tuple(PARTIALS_ONE_STAGE),
        "no-sum-pass": (PARTIALS_NO_SUM_PASS,),
        "no-softplus-pass": (PARTIALS_NO_SOFTPLUS_PASS,),
        "no-sum-no-softplus-pass": (PARTIALS_NO_SUM_PASS, PARTIALS_NO_SOFTPLUS_PASS),
    },
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
                  "  return launch_tiles<kFwd, 64, 16, false>(a, loc, sp,")
XS_INLINE_SOFTPLUS = (XS_WIDE_LAUNCH, "  return launch_tiles<kFwd, 64, 16, true>(a, loc, rho,")
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
NOISE_PROBE = """#include "sampled_dense_common.cuh"
extern "C" __global__ void noise_probe(float4* out, uint32_t seed) {
  out[blockIdx.x * blockDim.x + threadIdx.x] = sampled_dense::normal4(seed, blockIdx.x, threadIdx.x, 7u);
}
"""


def start_variant(build, fam: dict, swaps, workdir: str, tag: str):
    """nvcc on the family's source with ``swaps`` applied, in the background."""
    source = (build.CSRC / fam["source"]).read_text()
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
        return sd.xs_bf16_plan(S, B, i_dim, o_dim, sms, "fwd" if "xs_fwd" in name else "dx").n_split
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
    xs_family = kind.startswith("xs_bf16")
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
            scratch = lambda n: (n, *lead, B, i_dim)  # noqa: E731
        else:
            x = torch.rand((S, B, i_dim) if "xs_fwd" in name else (B, i_dim), generator=gen, device="cuda")
            outs = [torch.empty((S, B, o_dim), device="cuda")]
            head = (x.data_ptr(), loc.data_ptr(), rho.data_ptr(), bloc.data_ptr(), brho.data_ptr(),
                    sp.data_ptr())
            scratch = lambda n: (n, S, B, o_dim)  # noqa: E731
        if fam["source"] == "sampled_dense_xs_bf16.cu":
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
                if o_dim <= 16 and tag != "full" and not xs_family:
                    continue
                ms = device_ms(torch, lambda dll=dll: call(dll))
                rows.append({"kernel": name, "shape": f"I={i_dim} O={o_dim}", "n_split": n_split,
                             "planned": n_split == planned, "variant": tag, "ms": ms})
                print(f"{tag_line} {name} B={B} S={S} I={i_dim} O={o_dim} n_split {n_split}"
                      f"{' (planned)' if n_split == planned else ''}: {tag} {ms:.4f} ms")
        if "append_full" in fam and o_dim > 16:
            occ = libs["full"].xs_occupancy
            occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
            for n_split in (1, 2, 3, 4, 8):
                blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
                err = occ(int("xs_fwd" in name), n_split, ctypes.byref(blocks), ctypes.byref(clusters))
                print(f"{tag_line} {name} I={i_dim} O={o_dim}: {blocks.value} blocks an SM, "
                      f"{clusters.value} active clusters of {n_split} (cudaError {err})")
        if xs_family and kind == "xs_bf16_partials":
            from chip_smoke import noise_floor_ms

            floor = noise_floor_ms(torch, S, i_dim, o_dim)
            rows.append({"kernel": "noise_floor", "shape": f"I={i_dim} O={o_dim}", "ms": floor})
            print(f"{tag_line} noise floor B={B} S={S} I={i_dim} O={o_dim}: {floor:.4f} ms "
                  f"({S * i_dim * o_dim} normals)")


def main() -> None:
    args = sys.argv[1:]
    family = next((a.split("=", 1)[1] for a in args if a.startswith("--family=")), None)
    kinds = ([family] if family else ["fwd"] if "--fwd" in args else ["dparams"] if "--dparams" in args else
             ["dparams_bf16"] if "--dparams-bf16" in args else ["xs_bf16_partials", "xs_bf16"] if "--xs-bf16" in args
             else ["dx"])
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
    kinds = [k for k in kinds if k in FAMILIES and (build.CSRC / FAMILIES[k]["source"]).exists()]
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
