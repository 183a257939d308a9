#!/usr/bin/env python3
"""Time an earlier version of ``csrc/sampled_dense_dparams.cu`` against the
current one on the card, with ``chip_smoke.py``'s device-time yardstick.

    python3 scripts/torch_dparams_compare.py EARLIER_TREE/robustbnns_tpu_torch/csrc/sampled_dense_dparams.cu

The earlier file is the first design: one kernel per call, 64 x 64 tiles (16 x
16 when O <= 16) that loop over every sample, with the C interface
``sampled_dense_dparams(g, x, rho, brho, dloc, drho, dbloc, dbrho, S, B, I, O,
seed, stream)`` (and ``sampled_dense_xs_dparams`` alike). Give it inside its
own unpacked tree: a quoted include finds that tree's
``sampled_dense_common.cuh`` next to it first. It is built with the current
``ops/build.py`` flags. At the main path's shapes (B = 128, S = 10) the two
versions run in turns, old, new, new, old, each held to the plain twin; one
line per shape and version, then a JSON line.
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
SHAPES = (("sampled_dense_dparams", 784, 1024), ("sampled_dense_xs_dparams", 1024, 1024),
          ("sampled_dense_xs_dparams", 1024, 10))
B, S = 128, 10


def build_old(source: str, workdir: str) -> ctypes.CDLL:
    from robustbnns_tpu_torch.ops import build

    lib = os.path.join(workdir, "libold_dparams.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, source], check=True)
    dll = ctypes.CDLL(lib)
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    for name in ("sampled_dense_dparams", "sampled_dense_xs_dparams"):
        getattr(dll, name).argtypes = [p] * 8 + [i] * 4 + [u, p]
    return dll


def old_call(torch, dll, name, g, x, rho, brho, seed):
    """One call of the old kernel, which takes no scratch and no plan."""
    (_, b, o), i = g.shape, rho.shape[0]
    outs = [torch.empty((i, o), device="cuda") for _ in range(2)] + [torch.empty((o,), device="cuda")
                                                                     for _ in range(2)]
    err = getattr(dll, name)(g.data_ptr(), x.data_ptr(), rho.data_ptr(), brho.data_ptr(),
                             *(t.data_ptr() for t in outs), S, b, i, o, seed,
                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old {name} failed to launch: cudaError {err}")
    return tuple(outs)


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
    with tempfile.TemporaryDirectory(prefix="dparams_compare_") as workdir:
        dll = build_old(os.path.abspath(sys.argv[1]), workdir)
        for name, i_dim, o_dim in SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(1234 + i_dim + o_dim)
            _, rho, _, brho = _layer_inputs(torch, gen, i_dim, o_dim)
            g = torch.randn((S, B, o_dim), generator=gen, device="cuda")
            x = torch.rand((S, B, i_dim) if name == "sampled_dense_xs_dparams" else (B, i_dim),
                           generator=gen, device="cuda")
            refs = getattr(sd, f"{name}_plain")(g, x, rho, brho, S, seed)
            runs = {"old": lambda: old_call(torch, dll, name, g, x, rho, brho, seed),
                    "new": lambda: getattr(sd, name)(g, x, rho, brho, S, seed)}
            times = {"old": [], "new": []}
            calls = {"old": [], "new": []}
            for version in ("old", "new", "new", "old"):
                for k, (got, ref) in enumerate(zip(runs[version](), refs)):
                    check_close(f"{version} {name} output {k}", got, ref, RTOL, ATOL_OF_MAX * float(ref.abs().max()))
                times[version].append(device_ms(torch, runs[version]))
                calls[version].append(call_ms(torch, runs[version]))
            for version in ("old", "new"):
                row = {"kernel": name, "version": version, "shape": f"B={B} S={S} I={i_dim} O={o_dim}",
                       "ms": statistics.mean(times[version]), "ms_runs": times[version],
                       "call_ms": statistics.mean(calls[version])}
                rows.append(row)
                print(f"[dparams-compare] {name} {row['shape']} {version}: device {row['ms']:.4f} ms "
                      f"(runs {', '.join(f'{t:.4f}' for t in times[version])}), call {row['call_ms']:.4f} ms")
    print(json.dumps({"dparams_compare": rows}))


if __name__ == "__main__":
    main()
