"""The control comes out not correct: the reference, computed in bfloat16
(the precision below the configurations' float32) and put in the
program's place, fails every number that decides ``correct``, while sound
runs pass them.  On the CPU at the entries' tiny sizes; with the ``gpu``
marker at each cell's own size on the card."""

import pytest

from perfbench.harness.bench import load_benchmark, resolve

from .conftest import run_cli

WORKLOADS = [w["name"] for w in load_benchmark()["workloads"]]


def _readings(workload, kinds, dry=True, seconds="1"):
    args = ["--workload", workload, "--seed", "1", "--seconds", seconds,
            "--calibrate", kinds]
    rc, out, err = run_cli(*args, *(["--cpu-dry-run"] if dry else []),
                           timeout=3600)
    assert rc == 0, err[-3000:]
    return out["calibration"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_every_number(workload):
    limits = resolve(workload).limits
    got = _readings(workload, "sound:5,6;control:7,8")
    for numbers in got["sound"].values():
        assert all(numbers[k] <= v for k, v in limits.items()), numbers
    for numbers in got["control"].values():
        assert all(numbers[k] > v for k, v in limits.items()), numbers


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_on_the_card(cuda, workload):
    """At the cell's own size, three control seeds."""
    import torch

    if torch.cuda.device_count() < resolve(workload).chips:
        pytest.skip("needs more cards")
    limits = resolve(workload).limits
    got = _readings(workload, "control:11,12,13", dry=False, seconds="5")
    for numbers in got["control"].values():
        assert any(numbers[k] > v for k, v in limits.items()), numbers
