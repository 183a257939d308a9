"""The benchmark's harness, driven by ``BENCHMARK.json`` and the files it names.

A cell (``workloads`` entry) names a configuration (``configs`` entry, whose
``file`` is ``benchmark/configs/<name>.json``) and a traffic mix
(``benchmark/traffic/<name>.json``, whose ``kind`` names the driver
``benchmark/kinds/<kind>.py``); its limits are ``benchmark/limits/<cell>.json``.
Each metric is read by ``benchmark/metrics/<metric>.py`` (``read(ctx)``,
``None`` where it finds nothing to read). A cell reports each end-to-end
metric that lists it (or lists no cells) with ``--trace 0``, and each
per-layer metric that lists it (or, listing none, moves an end-to-end metric
the cell reports) with ``--trace 1``.

A run: set-up, the window, with ``--trace 1`` a profiled stretch after it,
the program's state freed, the check against the reference, a look at
``sys.modules``, then the result as the last line of standard output.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "robustbnns_tpu")


def process_start() -> float:
    """This process's start, in seconds since the epoch (Linux ``/proc``), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str) -> dict:
    """Everything a run of ``workload`` reads, found by name."""
    manifest = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    bench = os.path.join(ROOT, "benchmark")
    end_to_end = [m["name"] for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    per_layer = [m["name"] for m in manifest["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in end_to_end)]
    return {
        "workload": workload,
        "chips": cell["chips"],
        "config": _json(os.path.join(ROOT, config["file"])),
        "traffic": _json(os.path.join(bench, "traffic", cell["traffic"] + ".json")),
        "limits": _json(os.path.join(bench, "limits", workload + ".json")),
        "end_to_end": end_to_end,
        "per_layer": per_layer,
        "units": {m["name"]: m["unit"] for m in manifest["end_to_end"] + manifest["per_layer"]},
        "metrics_dir": os.path.join(bench, "metrics"),
    }


def read_metric(metrics_dir: str, name: str, ctx: dict):
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", os.path.join(metrics_dir, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, started: float) -> dict:
    """One run of a cell on ``device``; returns the result's fields."""
    import torch

    from benchmark import trace as tracing

    cuda = torch.device(device).type == "cuda"
    kind = importlib.import_module(f"benchmark.kinds.{spec['traffic']['kind']}")
    cell = kind.Cell(spec, seed, device)
    window = cell.window(seconds)
    ctx = {"config": spec["config"], "traffic": spec["traffic"], "window": window,
           "setup_s": cell.window_start - started, "trace": None}
    if trace:
        ctx["trace"] = tracing.profile(cell.stretch, device)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    cell.release()
    check_start = time.time()
    checks = cell.check()
    print(f"benchmark: set-up {ctx['setup_s']:.3f} s, window {window['seconds']:.3f} s, "
          f"check {time.time() - check_start:.3f} s", file=sys.stderr)
    names = spec["per_layer"] if trace else spec["end_to_end"]
    metrics = {}
    for name in names:
        value = read_metric(spec["metrics_dir"], name, ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": spec["units"][name]}
    result = {
        "correct": all(checks[name] <= limit for name, limit in spec["limits"].items()),
        "attempted": window["attempted"],
        "failed": window["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": spec["chips"], "memory_peak_bytes": memory_peak},
    }
    if trace:
        result["device"].update(busy_s=ctx["trace"]["busy_s"], window_s=ctx["trace"]["window_s"])
        result["breakdown"] = {"device_ops": tracing.top(ctx["trace"]["device_ops"]),
                               "idle_gaps": tracing.top(ctx["trace"]["idle_gaps"])}
    result["checks"] = {name: {"value": finite(checks[name]), "limit": limit} for name, limit in spec["limits"].items()}
    return result


def finite(value):
    """``value``, or its name where JSON has no number for it."""
    return value if math.isfinite(value) else str(value)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or why not."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    import argparse

    started = process_start()
    parser = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on this machine's card.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    spec = cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is False: this benchmark runs on an NVIDIA card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"benchmark: {args.workload} needs {spec['chips']} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        importlib.import_module("robustbnns_tpu_torch")
    except ImportError as e:
        print(f"benchmark: the program under test, robustbnns_tpu_torch, is not here: {e}", file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", started)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}: the port must not load JAX or the JAX package", file=sys.stderr)
        return 3
    print(f"benchmark: {args.workload} seed {args.seed} on {card()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result, allow_nan=False))
    return 0
