"""The per-layer metrics that read the program's spans and byte counters,
on traced CPU dry runs at the entries' tiny sizes (``DRY``)."""

import json
import os
import subprocess
import sys

import pytest

from perfbench.harness.bench import load_benchmark, load_module, resolve

from .conftest import ROOT

BENCH = load_benchmark()
SPAN_SOURCES = ("program_span", "program_counter")
SPAN_METRICS = [m["name"] for m in BENCH["per_layer"]
                if m["source"] in SPAN_SOURCES]
ADAPT = ("adapt.density_ms", "adapt.redraw_ms", "adapt.select_ms",
         "adapt.pool_ms")

# one traced dry run in this process's child: the result line, and the
# window's span records (name, parent, nbytes, host ms) that the readers read
_SCRIPT = r"""
import io, json, sys, contextlib
sys.path.insert(0, {root!r})
from perfbench.harness.main import main
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = main({argv!r}, 0.0)
from glabc_tpu_torch.utils import profiling
recs = [[r.name, r.parent, r.nbytes, r.host_ms] for r in profiling.spans()]
print(json.dumps({{"rc": rc, "out": json.loads(buf.getvalue().splitlines()[-1]),
                  "spans": recs}}))
"""


def _traced_dry_run(workload):
    argv = ["--workload", workload, "--seed", "3000000019", "--seconds",
            "1", "--trace", "1", "--cpu-dry-run"]
    p = subprocess.run([sys.executable, "-c",
                        _SCRIPT.format(root=ROOT, argv=argv)],
                       capture_output=True, text=True, timeout=600, cwd=ROOT,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["rc"] == 0 and got["out"]["correct"] is True
    return got["out"], got["spans"]


@pytest.fixture(scope="module")
def dry():
    """``{cell: (result line, span records)}``, each run once."""
    return {}


def _run(dry, workload):
    if workload not in dry:
        dry[workload] = _traced_dry_run(workload)
    return dry[workload]


def test_span_metrics_are_per_layer_entries_with_workloads():
    assert len(SPAN_METRICS) == 8
    for m in BENCH["per_layer"]:
        if m["name"] in SPAN_METRICS:
            assert m["workloads"] and m["moves"] == "transitions_per_s"
            assert callable(load_module("metrics", m["name"]).read)


@pytest.mark.parametrize("workload", ["glmcmc-final", "aglmcmc-shared",
                                      "aglmcmc-shared-mesh4"])
def test_traced_dry_run_reports_every_span_metric(dry, workload):
    out, _ = _run(dry, workload)
    want = {m["name"] for m in resolve(workload).per_layer
            if m["source"] in SPAN_SOURCES}
    assert want and want <= set(out["metrics"])
    for name in want:
        v = out["metrics"][name]["value"]
        assert v == v and v >= 0, (name, v)      # a number, not NaN
    # no K5 launch on the CPU: the device trace's epoch reads nothing
    assert "adapt.epoch_ms" not in out["metrics"]


def test_driver_io_mb_is_the_dry_shapes_bytes(dry):
    out, _ = _run(dry, "glmcmc-final")
    entry = load_module("entries", "glmcmc_fused")
    C, d = entry.DRY["num_chains"], 2
    # theta0 and y0 up; the final states and three float64 counters down
    want = d * 4 + C * d * 4 + C * d * 4 + 3 * C * 8
    assert out["metrics"]["driver.io_mb"]["value"] == pytest.approx(
        want * 1e-6, rel=1e-12)


def test_adapt_phases_add_up_within_the_epochs(dry):
    out, recs = _run(dry, "aglmcmc-shared")
    parts = [out["metrics"][m]["value"] for m in ADAPT]
    assert all(p > 0 for p in parts)
    epochs = [i for i, r in enumerate(recs) if r[0] == "glabc.epoch"]
    runs = {i for i, r in enumerate(recs) if r[0].startswith("glabc.run.")}
    repack = [r for r in recs if r[0] == "glabc.epoch.pool" and r[1] in runs]
    host = (sum(recs[i][3] for i in epochs)
            + sum(r[3] for r in repack)) / len(epochs)
    assert sum(parts) <= host * (1 + 1e-9)


def test_mesh_collective_mb_is_the_dry_shapes_bytes(dry):
    out, _ = _run(dry, "aglmcmc-shared-mesh4")
    cell = resolve("aglmcmc-shared-mesh4")
    entry = load_module("entries", "aglmcmc_fused_mixed")
    dr, s = entry.DRY, cell.config["sampler"]
    world, d = cell.chips, 2
    chains = dr["num_chains_per_rank"] * world
    seg = round(dr["step_size"] / cell.traffic["global_frequency"])
    rows = chains * seg * s["batch_size"]
    epochs = (dr["num_ite"] - 1) // seg - 1          # a job's
    # each epoch: the anneal's count (int64), the gathers of every rank's
    # discrepancies (float32) and weights (float64), the support's sum;
    # each job: its three float64 counters gathered
    epoch = 8 + rows * 4 + rows * 8 + dr["shared_support"] * d * 4
    want = epoch + 3 * chains * 8 / epochs
    assert out["metrics"]["mesh.collective_mb"]["value"] == pytest.approx(
        want * 1e-6, rel=1e-12)
