#!/usr/bin/env python3
"""Time an earlier version of ``csrc/sampled_dense_fwd.cu`` against the current
one on the card, with ``chip_smoke.py``'s device-time yardstick.

    python3 scripts/torch_fwd_compare.py EARLIER_TREE/robustbnns_tpu_torch/csrc/sampled_dense_fwd.cu

The earlier file is the first design: one kernel per call with the C interface
``sampled_dense_fwd(x, loc, rho, bloc, brho, out, S, B, I, O, seed,
s_per_block, stream)`` (and ``sampled_dense_xs_fwd`` alike), samples spread
over blocks until 128 x 16 tiles fill the SMs once. Give it inside its own
unpacked tree: a quoted include finds that tree's ``sampled_dense_common.cuh``
next to it first. It is built with the current ``ops/build.py`` flags. At the
main path's shapes (B = 128, S = 10) the two versions run in turns, old, new,
new, old, each held to the plain twin; one line per shape and version, then a
JSON line.
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
SHAPES = (("sampled_dense_fwd", 784, 1024), ("sampled_dense_xs_fwd", 1024, 1024),
          ("sampled_dense_xs_fwd", 1024, 10))
B, S = 128, 10


def build_old(source: str, workdir: str) -> ctypes.CDLL:
    from robustbnns_tpu_torch.ops import build

    lib = os.path.join(workdir, "libold_fwd.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, source], check=True)
    dll = ctypes.CDLL(lib)
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    for name in ("sampled_dense_fwd", "sampled_dense_xs_fwd"):
        getattr(dll, name).argtypes = [p] * 6 + [i] * 4 + [u, i, p]
    return dll


def old_call(torch, dll, name, x, loc, rho, bloc, brho, seed):
    """One call of the old kernel with its old launch geometry."""
    (b, i), o = x.shape[-2:], loc.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = -(-b // 128) * -(-o // 16)
    groups = max(1, min(S, sms // tiles))
    out = torch.empty((S, b, o), device="cuda")
    err = getattr(dll, name)(x.data_ptr(), loc.data_ptr(), rho.data_ptr(), bloc.data_ptr(), brho.data_ptr(),
                             out.data_ptr(), S, b, i, o, seed, -(-S // groups),
                             torch.cuda.current_stream().cuda_stream)
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
    with tempfile.TemporaryDirectory(prefix="fwd_compare_") as workdir:
        dll = build_old(os.path.abspath(sys.argv[1]), workdir)
        for name, i_dim, o_dim in SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(1234 + i_dim + o_dim)
            params = _layer_inputs(torch, gen, i_dim, o_dim)
            x = torch.rand((S, B, i_dim) if name == "sampled_dense_xs_fwd" else (B, i_dim),
                           generator=gen, device="cuda")
            ref = getattr(sd, f"{name}_plain")(x, *params, S, seed)
            runs = {"old": lambda: old_call(torch, dll, name, x, *params, seed),
                    "new": lambda: getattr(sd, name)(x, *params, S, seed)}
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
                print(f"[fwd-compare] {name} {row['shape']} {version}: device {row['ms']:.4f} ms "
                      f"(runs {', '.join(f'{t:.4f}' for t in times[version])}), call {row['call_ms']:.4f} ms")
    print(json.dumps({"fwd_compare": rows}))


if __name__ == "__main__":
    main()
