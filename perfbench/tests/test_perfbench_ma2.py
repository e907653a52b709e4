"""The ``ma2-k8`` cell on the CPU at its entry's tiny sizes (``DRY``): a
fault planted in K8's answers (a step that returns its state unchanged,
half of the chains left unchanged, an answer altered by 1e-3) comes out not
correct, a sound run correct; a traced run reads the spans of the call, and
its ``driver.io_mb`` is the bytes worked out from the shapes."""

import pytest
import torch

from perfbench.harness.bench import load_module, resolve
from perfbench.harness.main import parse, run_rank

from .test_perfbench_spans import _traced_dry_run

CELL = "ma2-k8"


def _run(seed=123457):
    opts = parse(["--workload", CELL, "--seed", str(seed), "--seconds",
                  "1", "--trace", "0", "--cpu-dry-run"])
    return run_rank(opts, resolve(CELL), 0, 1, None, 0.0)


def k8_fault(kind):
    from glabc_tpu_torch.ops.kernels.generic_kernel import GenericFusedGLMCMC

    run = GenericFusedGLMCMC.run

    def faulty(self, seed, theta, y, logk, *, step0=0, chain0=0):
        th, yy, lk, hist, stats = run(self, seed, theta, y, logk,
                                      step0=step0, chain0=chain0)
        if kind == "unchanged":
            zero = type(stats)(*(torch.zeros_like(s) for s in stats))
            return theta, y, logk, hist, zero
        if kind == "half":
            h = theta.shape[1] // 2
            th, yy, lk = th.clone(), yy.clone(), lk.clone()
            th[:, h:], yy[:, h:], lk[h:] = theta[:, h:], y[:, h:], logk[h:]
            return th, yy, lk, hist, stats
        return th + 1e-3, yy, lk, hist, stats         # altered

    return faulty


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_k8_fault_is_not_correct(monkeypatch, kind):
    from glabc_tpu_torch.ops.kernels.generic_kernel import GenericFusedGLMCMC

    monkeypatch.setattr(GenericFusedGLMCMC, "run", k8_fault(kind))
    out = _run()
    assert out["correct"] is False, out["checks"]


def test_sound_run_is_correct():
    assert _run()["correct"] is True


def test_traced_dry_run_reads_the_driver_spans():
    out, recs = _traced_dry_run(CELL)
    want = {m["name"] for m in resolve(CELL).per_layer
            if m["source"] in ("program_span", "program_counter")}
    assert want == {"driver.io_ms", "driver.io_mb",
                    "device.idle_in_driver_share"}
    assert want <= set(out["metrics"])
    # no K8 launch on the CPU: the device trace's roofline reads nothing
    assert "k8_roofline" not in out["metrics"]
    assert any(r[0] == "glabc.run.fused_program" for r in recs)
    C, d, Y = load_module("entries", "glmcmc_program").DRY["num_chains"], 2, 3
    # theta0 and y0 up; the final states and three float64 counters down
    want_b = d * 4 + C * Y * 4 + C * d * 4 + 3 * C * 8
    assert out["metrics"]["driver.io_mb"]["value"] == pytest.approx(
        want_b * 1e-6, rel=1e-12)


def test_op_counts_are_chip_smokes():
    """The frozen copies in ``harness/ma2_ops.py`` count what
    ``chip_smoke.py``'s functions count."""
    chip_smoke = pytest.importorskip("chip_smoke")
    from perfbench.harness import ma2_ops

    for T in (1, 16, 37, 100):
        assert ma2_ops.ma2_sim_ops(T) == chip_smoke.ma2_sim_ops(T)
        assert ma2_ops.ma2_local_ops(T) == chip_smoke.ma2_local_ops(T)
        for B in (1, 5):
            for kind in ("global", "local"):
                assert ma2_ops.ma2_step_ops(T, B, kind) == \
                    chip_smoke.ma2_step_ops(T, B, kind)
