"""What a run loads: never JAX nor the JAX package, and the reference never
the program. Top-level module names are compared whole: the program's name,
``robustbnns_tpu_torch``, begins with the JAX package's."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from conftest import ROOT

from benchmark import harness

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{name.split(".")[0] for name in sys.modules}})))
"""


def _loaded(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT, body=body)], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_neither_jax_nor_either_package():
    loaded = _loaded("import benchmark.reference.arch_fc2, benchmark.reference.arch_conv, "
                     "benchmark.reference.svi, benchmark.reference.compare, benchmark.reference.precision")
    assert not loaded & {"jax", "jaxlib", "flax", "robustbnns_tpu", "robustbnns_tpu_torch"}


def test_the_entry_point_loads_no_jax():
    loaded = _loaded("import runpy; runpy.run_path('benchmark/run.py', run_name='not_main')")
    assert not loaded & set(harness.FORBIDDEN)


def test_a_whole_run_loads_no_jax():
    body = ("import sys, time; sys.path.insert(0, 'benchmark/tests'); from conftest import tiny_spec, run_tiny; "
            "run_tiny(tiny_spec('model_7.pgd.s100'))")
    loaded = _loaded(body)
    assert "robustbnns_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "robustbnns_tpu_torch_extra", sys)
    assert "robustbnns_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "model_7.pgd.s100", "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
