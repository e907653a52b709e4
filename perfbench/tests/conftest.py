"""Shared helpers of the benchmark's tests: runs of ``perfbench/run.py``
on the CPU at the entries' tiny sizes."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_cli(*args, timeout=600, cwd=ROOT):
    """``perfbench/run.py`` in a fresh process: ``(rc, last stdout line as
    JSON or None, stderr)``."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    run = os.path.join(cwd, "perfbench", "run.py")
    p = subprocess.run([sys.executable, run, *args], capture_output=True,
                       text=True, timeout=timeout, cwd=cwd, env=env)
    lines = p.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if lines else None
    return p.returncode, out, p.stderr


@pytest.fixture
def cuda():
    """Skips a test that needs a card when none is present (decided when
    the test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
