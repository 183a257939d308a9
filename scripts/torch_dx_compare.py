#!/usr/bin/env python3
"""Time an earlier version of ``csrc/sampled_dense_dx.cu`` against the current
one on the card, with ``chip_smoke.py``'s device-time yardstick.

    python3 scripts/torch_dx_compare.py OLD_SOURCE.cu

``OLD_SOURCE.cu`` is the earlier kernel file (one kernel per call, the
C interface ``sampled_dense_dx(g, loc, rho, dx, S, B, I, O, seed, stream)``
and ``sampled_dense_xs_dx(..., s_per_block, stream)``), for example the
parent commit's file unpacked with ``git show``. It is built with the current
``ops/build.py`` flags against the current ``sampled_dense_common.cuh`` (which
the redesign left unchanged). At the main path's shapes (B = 128, S = 10) the
two versions run in turns, old, new, new, old, each held to the plain twin;
one line per shape and version, then a JSON line.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = (("sampled_dense_dx", 784, 1024), ("sampled_dense_xs_dx", 1024, 1024),
          ("sampled_dense_xs_dx", 1024, 10))
B, S = 128, 10


def build_old(source: str, workdir: str) -> ctypes.CDLL:
    from robustbnns_tpu_torch.ops import build

    lib = os.path.join(workdir, "libold_dx.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", lib, source],
                   check=True)
    dll = ctypes.CDLL(lib)
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    dll.sampled_dense_dx.argtypes = [p] * 4 + [i] * 4 + [u, p]
    dll.sampled_dense_xs_dx.argtypes = [p] * 4 + [i] * 4 + [u, i, p]
    return dll


def old_call(torch, dll, name, g, loc, rho, seed):
    """One call of the old kernel, with its old launch geometry (one block per
    tile and sample group, groups capped at one block per SM)."""
    (s, b, o), i = g.shape, loc.shape[0]
    out = torch.empty((b, i) if name == "sampled_dense_dx" else (s, b, i), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    if name == "sampled_dense_dx":
        err = dll.sampled_dense_dx(g.data_ptr(), loc.data_ptr(), rho.data_ptr(), out.data_ptr(),
                                   s, b, i, o, seed, stream)
    else:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        tiles = -(-b // 128) * -(-i // 16)
        groups = max(1, min(s, sms // tiles))
        err = dll.sampled_dense_xs_dx(g.data_ptr(), loc.data_ptr(), rho.data_ptr(), out.data_ptr(),
                                      s, b, i, o, seed, -(-s // groups), stream)
    if err:
        raise RuntimeError(f"old {name} failed to launch: cudaError {err}")
    return out


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    from chip_smoke import ATOL_OF_MAX, RTOL, _layer_inputs, call_ms, check_close, device_ms, phase_device

    phase_device(torch)
    sd = importlib.import_module("robustbnns_tpu_torch.ops.sampled_dense")
    seed = 20261016
    rows = []
    with tempfile.TemporaryDirectory(prefix="dx_compare_") as workdir:
        dll = build_old(os.path.abspath(sys.argv[1]), workdir)
        for name, i_dim, o_dim in SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(1234 + i_dim + o_dim)
            loc, rho, _, _ = _layer_inputs(torch, gen, i_dim, o_dim)
            g = torch.randn((S, B, o_dim), generator=gen, device="cuda")
            ref = getattr(sd, f"{name}_plain")(g, loc, rho, S, seed)
            runs = {"old": lambda: old_call(torch, dll, name, g, loc, rho, seed),
                    "new": lambda: getattr(sd, name)(g, loc, rho, S, seed)}
            times = {"old": [], "new": []}
            calls = {"old": [], "new": []}
            for version in ("old", "new", "new", "old"):
                check_close(f"{version} {name}", runs[version](), ref, RTOL, ATOL_OF_MAX * float(ref.abs().max()))
                times[version].append(device_ms(torch, runs[version]))
                calls[version].append(call_ms(torch, runs[version]))
            for version in ("old", "new"):
                row = {"kernel": name, "version": version, "shape": f"B={B} S={S} I={i_dim} O={o_dim}",
                       "ms": statistics.mean(times[version]), "ms_runs": times[version],
                       "call_ms": statistics.mean(calls[version])}
                rows.append(row)
                print(f"[dx-compare] {name} {row['shape']} {version}: device {row['ms']:.4f} ms "
                      f"(runs {', '.join(f'{t:.4f}' for t in times[version])}), call {row['call_ms']:.4f} ms")
    print(json.dumps({"dx_compare": rows}))


if __name__ == "__main__":
    main()
