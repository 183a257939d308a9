"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
against the files that the harness finds by that name."""
from __future__ import annotations

import json
import os
import re

import pytest
from conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    MANIFEST = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert len(json.dumps(MANIFEST)) < 64 * 1024
    full_check = 2 + 14 * 24
    assert full_check * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MANIFEST["configs"] + MANIFEST["workloads"] + METRICS, ids=lambda e: e["name"])
def test_names_units_and_keys(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        allowed = {"name", "unit", "better", "source", "workloads", "bound", "layer", "moves"}
        assert set(entry) <= allowed
    for key in ("why", "layer", "source"):
        if key in entry:
            assert TEXT.match(entry[key])


def test_names_are_unique():
    for group in (MANIFEST["configs"], MANIFEST["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in names
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_what_it_must():
    for cell in MANIFEST["workloads"]:
        assert cell["chips"] in (1, 4) and TEXT.match(cell["why"])
        e2e = [m["name"] for m in MANIFEST["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = [m for m in MANIFEST["per_layer"] if cell["name"] in m.get("workloads", [])]
        assert per_layer, cell["name"]
    pairs = [(c["config"], c["traffic"]) for c in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(c["chips"] == 4 for c in MANIFEST["workloads"]) <= max(1, len(pairs) // 4)


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_per_layer_moves_a_metric_that_its_cells_report(metric):
    moved = next(m for m in MANIFEST["end_to_end"] if m["name"] == metric["moves"])
    assert metric["moves"] != "setup_s"
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", [cell])
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def test_layers_are_named_alike():
    layers = {m["layer"] for m in MANIFEST["per_layer"]}
    assert layers <= {"attack loop", "SVI trainer", "predictive", "conv trunk", "kernels", "device"}


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda c: c["name"])
def test_the_files_of_each_cell_are_there(cell):
    bench = os.path.join(ROOT, "benchmark")
    config = next(c for c in MANIFEST["configs"] if c["name"] == cell["config"])
    assert config["file"] == f"benchmark/configs/{config['name']}.json"
    with open(os.path.join(ROOT, config["file"])) as f:
        body = json.load(f)
    assert body["name"] == config["name"] and config["reduced"] == []
    with open(os.path.join(bench, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    assert os.path.exists(os.path.join(bench, "kinds", traffic["kind"] + ".py"))
    assert os.path.exists(os.path.join(bench, "reference", f"arch_{body['architecture']}.py"))
    assert os.path.exists(os.path.join(bench, "work", f"arch_{body['architecture']}.py"))
    with open(os.path.join(bench, "limits", cell["name"] + ".json")) as f:
        assert json.load(f)


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda c: c["name"])
def test_each_cell_holds_every_number_its_check_gives(cell):
    import importlib

    with open(os.path.join(ROOT, "benchmark", "traffic", cell["traffic"] + ".json")) as f:
        kind = importlib.import_module(f"benchmark.kinds.{json.load(f)['kind']}")
    with open(os.path.join(ROOT, "benchmark", "limits", cell["name"] + ".json")) as f:
        assert list(json.load(f)) == list(kind.CHECKS)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_its_reader(metric):
    assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", metric["name"] + ".py"))


def test_configs_are_used_and_own_their_files():
    used = {c["config"] for c in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(files) == len(set(files))
