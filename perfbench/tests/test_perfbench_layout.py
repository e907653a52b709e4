"""``BENCHMARK.json`` and the files it names."""

import json
import os
import re
import shutil

import pytest

from perfbench.harness.bench import load_benchmark, load_module, resolve

from .conftest import ROOT

BENCH = load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = ([c["name"] for c in BENCH["configs"]] + WORKLOADS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(WORKLOADS)) == len(WORKLOADS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(WORKLOADS) // 4)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"transitions_per_s", "setup_s"}
    for m in e2e.values():
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert e2e["setup_s"]["bound"] == 0.25


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves(workload):
    """A cell's configuration, traffic, limits, entry and metric readers are
    found by name; it reports setup_s, another end-to-end metric and a
    per-layer one; each per-layer metric's ``moves`` is one it reports."""
    cell = resolve(workload)
    assert cell.traffic["why"] and cell.limits
    entry = load_module("entries", cell.config["entry"])
    assert hasattr(entry, "Cell") and hasattr(entry, "DRY")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(load_module("metrics", m["name"]).read)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_configs_name_their_files():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/")
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert "assumed" in conf


def test_per_layer_metric_layers_are_named_once():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"], m["layer"])
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_new_traffic_file_is_a_new_cell(tmp_path):
    """A traffic file and a workloads entry, dropped into a copy, make a
    cell that resolves with no file edited."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    tr = json.loads((tmp_path / "perfbench/traffic/final-2m.json")
                    .read_text())
    tr.update(num_chains=1048576, why="half the chains")
    (tmp_path / "perfbench/traffic/final-1m.json").write_text(json.dumps(tr))
    (tmp_path / "perfbench/limits/glmcmc-1m.json").write_text(
        (tmp_path / "perfbench/limits/glmcmc-final.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "glmcmc-1m",
                               "config": "mixture2d-glmcmc",
                               "traffic": "final-1m", "chips": 1,
                               "why": "half the chains"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = resolve("glmcmc-1m", root=str(tmp_path))
    assert cell.traffic["num_chains"] == 1048576
    assert {m["name"] for m in cell.per_layer} == {"device.idle_share"}
