"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Names are compared by their
top-level part (before the first dot), whole: the port's name begins with
the JAX package's."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "glabc_tpu"}

_SCRIPT = r"""
import io, json, sys, contextlib
sys.path.insert(0, {root!r})
from perfbench.harness.main import main
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = main({argv!r}, 0.0)
import perfbench.harness.trace, perfbench.harness.peaks
for m in ("k1_roofline", "device.idle_share", "adapt.epoch_ms",
          "mesh.nccl_share"):
    from perfbench.harness.bench import load_module
    load_module("metrics", m)
print(json.dumps({{"rc": rc, "modules": sorted({{k.split(".")[0]
                                                for k in sys.modules}})}}))
"""


def _modules(code):
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["glmcmc-final", "aglmcmc-shared"])
def test_a_run_loads_no_jax(workload):
    argv = ["--workload", workload, "--seed", "1", "--seconds", "1",
            "--trace", "1", "--cpu-dry-run"]
    got = _modules(_SCRIPT.format(root=ROOT, argv=argv))
    assert got["rc"] == 0
    assert not FORBIDDEN & set(got["modules"])
    assert "glabc_tpu_torch" in got["modules"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, %r)\n"
            "import perfbench.reference.glmcmc, perfbench.reference.aglmcmc\n"
            "import perfbench.harness.compare, perfbench.harness.peaks\n"
            "print(json.dumps({'modules': sorted({k.split('.')[0] "
            "for k in sys.modules})}))" % ROOT)
    got = set(_modules(code)["modules"])
    assert not (FORBIDDEN | {"glabc_tpu_torch"}) & got


def _imported(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_sources_name_no_forbidden_module():
    files = glob.glob(os.path.join(ROOT, "perfbench", "**", "*.py"),
                      recursive=True)
    assert files
    for f in files:
        bad = FORBIDDEN & _imported(f)
        if os.sep + "reference" + os.sep in f:
            bad |= {"glabc_tpu_torch"} & _imported(f)
        assert not bad, (f, bad)


def test_a_run_with_jax_loaded_prints_no_result():
    pytest.importorskip("jax")
    code = ("import sys; sys.path.insert(0, %r); import jax\n"
            "from perfbench.harness.main import main\n"
            "sys.exit(main(['--workload', 'glmcmc-final', '--seed', '1', "
            "'--seconds', '1', '--trace', '0', '--cpu-dry-run'], 0.0))"
            % ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "jax" in p.stderr
