"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs[].file``), a traffic mix
(``perfbench/traffic/<traffic>.json``) and its limits for ``correct``
(``perfbench/limits/<cell>.json``); a configuration names its entry
(``perfbench/entries/<entry>.py``); a per-layer metric is read by
``perfbench/metrics/<metric>.py``.  Adding a cell, a mix or a metric adds
files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)                 # perfbench/
ROOT = os.path.dirname(PKG)                 # the checkout


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list      # the metric entries this cell reports
    per_layer: list


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, workload: str) -> bool:
    """Whether a metric is reported in ``workload``."""
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` with its configuration, traffic and limits;
    ``KeyError`` for a name that ``BENCHMARK.json`` lacks."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    pkg = os.path.join(root, "perfbench")
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_json(os.path.join(root, conf["file"])),
        traffic=_json(os.path.join(pkg, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(pkg, "limits", workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if reports(m, workload)])


def load_module(kind: str, name: str, root: str = ROOT):
    """``perfbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(root, "perfbench", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
