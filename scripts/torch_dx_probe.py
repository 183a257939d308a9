#!/usr/bin/env python3
"""Where the time of the dx kernels, or with ``--fwd`` of the forward kernels,
goes on the card: the kernels of ``csrc/sampled_dense_dx.cu`` (or
``csrc/sampled_dense_fwd.cu``) rebuilt with one part cut out at a time, timed
with ``chip_smoke.py``'s device-time yardstick at the main path's wide shapes.

    python3 scripts/torch_dx_probe.py [--fwd] [--diagnose] [SASS_DIR]

Variants: ``full``, the kernel as committed, and ``no-noise``, with each
Philox quad and Box-Muller of the wide kernel replaced by a constant quad (a
text substitution of the source; it computes a wrong result), each at the
split the plan (``dx_plan``, ``fwd_plan``) picks and at the other splits
listed in ``FAMILIES``. ``--diagnose`` adds, at the planned split, variants that
time parts of the FFMA loop and compute a wrong result: ``w-broadcast`` (every
lane reads the same W float4s), ``all-broadcast`` (the same for the other
operand, g^T or x^T, too), ``one-stage`` (only the first work unit or chunk is
fetched and drawn: no noise, staging or loads after it), ``one-stage-no-sync``
(and no barrier per unit) and ``all-broadcast-one-stage-no-sync``.

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


def family(source: str, shapes, row_operand: str, unit: str, splits: dict) -> dict:
    """A kernel source's probe: its wide shapes, its swaps and the splits to try.
    ``row_operand``: the shared array read per row group (gt, xt); ``unit``:
    the loop variable of the work units (u, c)."""
    a_broadcast = [(f"&{row_operand}[buf][k][8 * tr]", f"&{row_operand}[buf][k][0]"),
                   (f"&{row_operand}[buf][k][8 * tr + 4]", f"&{row_operand}[buf][k][4]")]
    one_stage = [(f"if (more) fetch({unit} + 1);", f"if (more && {unit} == {unit}_begin) fetch({unit} + 1);"),
                 (f"if (more) stage({unit} + 1, buf ^ 1);",
                  f"if (more && {unit} == {unit}_begin) stage({unit} + 1, buf ^ 1);")]
    return {
        "source": source, "shapes": shapes, "splits": splits,
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
    "dx": family("sampled_dense_dx.cu", (("sampled_dense_dx", 784, 1024), ("sampled_dense_xs_dx", 1024, 1024)),
                 "gt", "u", {"sampled_dense_dx": (20, 40), "sampled_dense_xs_dx": (2, 3, 4)}),
    "fwd": family("sampled_dense_fwd.cu", (("sampled_dense_fwd", 784, 1024), ("sampled_dense_xs_fwd", 1024, 1024)),
                  "xt", "c", {"sampled_dense_fwd": (1, 2, 4), "sampled_dense_xs_fwd": (1, 2, 4)}),
}
NOISE_PROBE = """#include "sampled_dense_common.cuh"
extern "C" __global__ void noise_probe(float4* out, uint32_t seed) {
  out[blockIdx.x * blockDim.x + threadIdx.x] = sampled_dense::normal4(seed, blockIdx.x, threadIdx.x, 7u);
}
"""


def build_variant(build, sd, fam: dict, swaps, workdir: str, tag: str) -> ctypes.CDLL:
    source = (build.CSRC / fam["source"]).read_text()
    for old, new in swaps:
        if old not in source:
            raise RuntimeError(f"probe {tag}: the source no longer holds {old!r}")
        source = source.replace(old, new)
    stem = fam["source"].split(".")[0]
    path = os.path.join(workdir, f"{stem}_{tag}.cu")
    with open(path, "w") as f:
        f.write(source)
    lib = os.path.join(workdir, f"lib{stem}_{tag}.so")
    done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", lib, path],
                          check=True, capture_output=True, text=True)
    for line in done.stdout.splitlines() + done.stderr.splitlines():
        if "Used" in line or "spill" in line:
            print(f"[probe] build {stem} {tag}: {line.strip()}")
    dll = ctypes.CDLL(lib)
    for name, _, _ in fam["shapes"]:
        getattr(dll, name).argtypes = sd._SIGNATURES[name][1]
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


def main() -> None:
    args = sys.argv[1:]
    kind = "fwd" if "--fwd" in args else "dx"
    diagnose = "--diagnose" in args
    sass_dir = next((a for a in args if not a.startswith("--")), None)
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    from chip_smoke import _layer_inputs, device_ms, phase_device

    phase_device(torch)
    from robustbnns_tpu_torch.ops import build

    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fam = FAMILIES[kind]
    tag_line = f"[{kind}-probe]"
    rows = []
    with tempfile.TemporaryDirectory(prefix=f"{kind}_probe_") as workdir:
        n_instr = noise_instructions(build, workdir, sass_dir)
        if n_instr:
            print(f"{tag_line} normal4 probe kernel: {n_instr[0]} SASS instructions, {n_instr[1]} on "
                  "the fast path, for 4 normals (with the probe's own indexing and store)")
        variants = {**fam["variants"], **(fam["diagnostics"] if diagnose else {})}
        libs = {tag: build_variant(build, sd, fam, swaps, workdir, tag) for tag, swaps in variants.items()}
        for name, i_dim, o_dim in fam["shapes"]:
            gen = torch.Generator(device="cuda").manual_seed(99)
            loc, rho, bloc, brho = _layer_inputs(torch, gen, i_dim, o_dim)
            sp = torch.empty_like(rho)
            if kind == "dx":
                summed = name == "sampled_dense_dx"
                g = torch.randn((S, B, o_dim), generator=gen, device="cuda")
                planned = sd.dx_plan(S, B, i_dim, o_dim, sms, summed).n_split
                out = torch.empty((B, i_dim) if summed else (S, B, i_dim), device="cuda")
                lead = (S,) if not summed else ()
                head = (g.data_ptr(), loc.data_ptr(), rho.data_ptr(), sp.data_ptr())
                scratch = lambda n: (n, *lead, B, i_dim)  # noqa: E731
            else:
                x = torch.rand((S, B, i_dim) if name == "sampled_dense_xs_fwd" else (B, i_dim),
                               generator=gen, device="cuda")
                planned = sd.fwd_plan(S, B, i_dim, o_dim, sms).n_split
                out = torch.empty((S, B, o_dim), device="cuda")
                head = (x.data_ptr(), loc.data_ptr(), rho.data_ptr(), bloc.data_ptr(), brho.data_ptr(),
                        sp.data_ptr())
                scratch = lambda n: (n, S, B, o_dim)  # noqa: E731
            for n_split in sorted(set(fam["splits"][name]) | {planned}):
                part = torch.empty(scratch(n_split), device="cuda") if n_split > 1 else None

                def call(dll, n_split=n_split, part=part):
                    stream = torch.cuda.current_stream().cuda_stream  # the capture stream in a graph
                    err = getattr(dll, name)(*head, part.data_ptr() if part is not None else None,
                                             out.data_ptr(), S, B, i_dim, o_dim, 5, n_split, stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")

                for tag, dll in libs.items():
                    if tag in fam["diagnostics"] and n_split != planned:
                        continue
                    ms = device_ms(torch, lambda dll=dll: call(dll))
                    rows.append({"kernel": name, "shape": f"I={i_dim} O={o_dim}", "n_split": n_split,
                                 "planned": n_split == planned, "variant": tag, "ms": ms})
                    print(f"{tag_line} {name} B={B} S={S} I={i_dim} O={o_dim} n_split {n_split}"
                          f"{' (planned)' if n_split == planned else ''}: {tag} {ms:.4f} ms")
    print(json.dumps({f"{kind}_probe": rows, "normal4_sass_instructions": n_instr}))


if __name__ == "__main__":
    main()
