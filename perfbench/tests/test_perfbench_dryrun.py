"""Each cell, run on the CPU at its entry's tiny sizes, prints one line of
the contract's keys, and comes out correct."""

import pytest

from perfbench.harness.bench import load_benchmark

from .conftest import run_cli

BENCH = load_benchmark()
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH["workloads"]])
def test_dry_run_prints_one_line(workload):
    rc, out, err = run_cli("--workload", workload, "--seed", "3000000001",
                           "--seconds", "1", "--trace", "0",
                           "--cpu-dry-run")
    assert rc == 0, err[-3000:]
    assert KEYS <= set(out) and list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert set(out["metrics"]) == e2e
    assert out["metrics"]["transitions_per_s"]["value"] > 0
    chips = {w["name"]: w["chips"] for w in BENCH["workloads"]}[workload]
    assert out["device"]["count"] == chips
    assert "check " in err.strip().splitlines()[-1]


def test_traced_dry_run_has_window_and_breakdown():
    rc, out, err = run_cli("--workload", "aglmcmc-shared", "--seed", "5",
                           "--seconds", "1", "--trace", "1",
                           "--cpu-dry-run")
    assert rc == 0, err[-3000:]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10


def test_same_seed_same_inputs():
    """A seed gives the same inputs, another seed others."""
    import numpy as np
    import torch

    from perfbench.harness.bench import load_module, resolve
    from perfbench.harness.main import Ctx

    cell = resolve("glmcmc-final")
    entry = load_module("entries", "glmcmc_fused")
    y0 = []
    for seed in (2**33 + 5, 2**33 + 5, 7):
        c = entry.Cell(Ctx(cell, seed, torch.device("cpu"), None, 0, 1,
                           True))
        c.setup()
        y0.append(c.y0)
    assert np.array_equal(y0[0], y0[1]) and not np.array_equal(y0[0], y0[2])
    assert entry.job_seed(2**33 + 5, 3) == entry.job_seed(2**33 + 5, 3)


def test_no_card_no_result():
    """Without ``--cpu-dry-run`` and without a card the run fails and
    prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, out, _ = run_cli("--workload", "glmcmc-final", "--seed", "1",
                         "--seconds", "1", "--trace", "0")
    assert rc != 0 and out is None


def test_unknown_workload_fails():
    rc, out, _ = run_cli("--workload", "no-such-cell", "--seed", "1",
                         "--seconds", "1", "--trace", "0")
    assert rc != 0 and out is None


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and perfbench/ the run
    fails and prints no result."""
    import os
    import shutil

    from .conftest import ROOT

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for workload in ("glmcmc-final", "aglmcmc-shared-mesh4"):
        rc, out, _ = run_cli("--workload", workload, "--seed", "1",
                             "--seconds", "1", "--trace", "0",
                             "--cpu-dry-run", cwd=str(tmp_path))
        assert rc != 0 and out is None
