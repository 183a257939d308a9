"""Readings for the limits of a cell's check, on the card at the cell's size.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 --seconds <s> [--control]

For each seed, in one process: the cell's set-up and a window of ``--seconds``
(long enough to finish the batches the check keeps), then the check's
numbers for the program (the lower readings), and with ``--control`` for
the reference in TF32 put in the program's place (the control) and, for a
training cell, for each planted fault of its kind (``FAULTS``). One JSON
line a seed on standard output. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--control", action="store_true")
    args = parser.parse_args(argv)
    import torch

    spec = harness.cell_spec(args.workload)
    kind = importlib.import_module(f"benchmark.kinds.{spec['traffic']['kind']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        start = time.perf_counter()
        cell = kind.Cell(spec, seed, "cuda")
        window = cell.window(args.seconds)
        cell.release()
        checked = time.perf_counter()
        out = {"workload": args.workload, "seed": seed, "units": window["units"], "program": cell.check(),
               "check_s": time.perf_counter() - checked}
        if args.control:
            out["tf32"] = cell.check("tf32")
            for fault in getattr(kind, "FAULTS", ()):
                out[fault] = cell.check(fault)
        out["seconds"] = time.perf_counter() - start
        print(json.dumps({k: harness.finite(v) if isinstance(v, float) else v for k, v in out.items()}), flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
