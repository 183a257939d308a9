"""A configuration, a traffic mix, a cell and a per-layer metric added to a
copy of the harness by new files and new ``BENCHMARK.json`` entries alone,
which the harness then finds by name and runs."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

PROBE = """
import json, sys, time
sys.path[:0] = [{copy!r}, {root!r}]
from benchmark import harness
assert harness.__file__.startswith({copy!r}), harness.__file__
spec = harness.cell_spec("model_t.pgd.tiny")
result = harness.run_cell(spec, 5, 0.05, True, "cpu", time.time())
print(json.dumps(result))
"""


def test_a_cell_added_by_files_alone(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), copy / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    bench = copy / "benchmark"
    with open(bench / "configs" / "model_7.json") as f:
        config = dict(json.load(f), name="model_t", hidden_size=16)
    (bench / "configs" / "model_t.json").write_text(json.dumps(config))
    traffic = {"kind": "pgd", "why": "a tiny mix", "n_samples": 2, "batch_size": 4, "iterations": 40,
               "epsilon": 0.3, "pool_batches": 2, "warmup_iterations": 1,
               "trace": {"min_batches": 1, "min_seconds": 0.0}, "check": {"batches": 1, "iterations": 2}}
    (bench / "traffic" / "pgd.tiny.json").write_text(json.dumps(traffic))
    (bench / "limits" / "model_t.pgd.tiny.json").write_text(json.dumps({"probs_gap": 3e-6, "grad_gap": 1e-3,
                                                                         "step_mismatch": 0.0}))
    (bench / "metrics" / "pgd.batches.py").write_text(
        "def read(ctx):\n    return ctx['window']['units'] / ctx['traffic']['batch_size']\n")
    manifest["configs"].append({"name": "model_t", "source": "https://example.org/model_t",
                                "file": "benchmark/configs/model_t.json", "reduced": [], "why": "tiny"})
    manifest["workloads"].append({"name": "model_t.pgd.tiny", "config": "model_t", "traffic": "pgd.tiny",
                                  "chips": 1, "why": "tiny"})
    manifest["per_layer"].append({"name": "pgd.batches", "unit": "batches", "better": "higher",
                                  "source": "host_clock", "layer": "attack loop", "moves": "pgd_images_per_s",
                                  "workloads": ["model_t.pgd.tiny"]})
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        if metric["name"] in ("pgd_images_per_s", "pgd_mfu"):
            metric["workloads"].append("model_t.pgd.tiny")
    (copy / "BENCHMARK.json").write_text(json.dumps(manifest))

    out = subprocess.run([sys.executable, "-c", PROBE.format(copy=str(copy), root=ROOT)], capture_output=True,
                         text=True, timeout=600, cwd=copy, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result
    assert set(result["metrics"]) == {"pgd.batches", "pgd_mfu"}
    assert result["metrics"]["pgd.batches"]["unit"] == "batches"
    assert result["metrics"]["pgd.batches"]["value"] >= 1
