"""BENCHMARK.json against the benchmark's contract, and every cell's files
found by name."""

import json
import os
import re

import pytest

from srbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths(bench):
    assert set(bench) == KEYS
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.rstrip("/").endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert _line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    cells = []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        cells.append(w["name"])
    metrics = []
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells)
        metrics.append(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        assert m["moves"] in [e["name"] for e in bench["end_to_end"]]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert "setup_s" in metrics
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = {m["name"] for m in run.cell_metrics(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = run.cell_metrics(bench, w["name"], True)
        assert layer and all(m["moves"] in e2e for m in layer)


def test_each_cells_files_are_found_by_name(bench):
    import importlib

    for w in bench["workloads"]:
        _, entry, cell, config = run.load_cell(w["name"])
        assert cell["name"] == w["name"] and cell["config"] == w["config"]
        assert config["name"] == w["config"]
        assert importlib.import_module(
            f"srbench.drivers.{cell['driver']}").Driver
        for m in run.cell_metrics(bench, w["name"], True):
            assert callable(run.load_reader(m["name"]))
        assert set(cell["checks"]) and all(
            isinstance(v, float) and v > 0 for v in cell["checks"].values())
    for c in bench["configs"]:
        assert c["file"].startswith("srbench/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["reduced"] == c["reduced"]
        assert set(data["changed"]) >= set(c["reduced"])


def test_without_a_card_it_fails_and_prints_no_result():
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "srbench.run", "--workload", "dip-x8-f32",
         "--seed", str(2 ** 31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA is not available" in proc.stderr
