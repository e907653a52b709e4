"""The port's slice end to end on the CPU: GLMCMC / GlobalMCMC on the
Mixture problem through ``run_glmcmc_fused`` (the kernel's plain version),
the plain ``run_glmcmc`` path and ``MCMCRunner``.

(f) Statistics: the posterior bands of ``tests/test_samplers.py:30-45`` at
    1024 chains x 1025 iterations, and E|theta| within 0.05 of
    ``glabc_tpu.samplers.run_glmcmc`` at 256 chains x 1025 iterations (the
    smaller size keeps the XLA CPU run cheap; the Monte-Carlo error of the
    difference is about 0.01).
(g) Structure: bitwise determinism across ``steps_per_call``,
    ``block_chains`` and layout; checkpoint/resume, also from a file in
    the fused loop's first checkpoint layout; the runner's CSV; the
    package imports no JAX; entry points need a device.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import glabc_tpu
import glabc_tpu.samplers as jsamplers
from glabc_tpu_torch import (DiagGaussian, HighDimMixtureProblem, MCMCRunner,
                             MixtureProblem, run_global_mcmc,
                             run_global_mcmc_fused, run_glmcmc,
                             run_glmcmc_fused)
from glabc_tpu_torch.ops.kernels import (FusedMixtureGLMCMC,
                                         PackedMixtureGLMCMC)
from glabc_tpu_torch.utils.io import save_carry

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PROB = MixtureProblem(0.05)
IP = DiagGaussian.create(2, 0.0, 0.0)
LP = DiagGaussian.create(2, 0.0, float(np.log(0.35)))
BURN = 300


def gen(seed):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------------ (f)
@pytest.fixture(scope="module")
def runs():
    return {
        "fused": run_glmcmc_fused(PROB, gen(0), 1025, np.zeros(2),
                                  num_chains=1024, device="cpu"),
        "scan": run_glmcmc(PROB, gen(0), 1025, np.zeros(2), IP, LP, 0.9, 5,
                           num_chains=1024, device="cpu"),
    }


@pytest.fixture(scope="module")
def jax_absmean():
    res = jsamplers.run_glmcmc(
        glabc_tpu.MixtureProblem(0.05), jax.random.PRNGKey(0), 1025,
        jnp.zeros(2), glabc_tpu.DiagGaussian.create(2, 0.0, 0.0),
        glabc_tpu.DiagGaussian.create(2, 0.0, float(np.log(0.35))), 0.9, 5,
        num_chains=256, segment_size=1025)
    return np.abs(np.asarray(res.thetas)[:, BURN:].reshape(-1, 2)).mean(0)


def _bands(res):
    ch = res.thetas[:, BURN:, :].reshape(-1, 2).astype(np.float64)
    absmean, var = np.abs(ch).mean(0), ch.var(0)
    assert np.all(absmean > 1.25) and np.all(absmean < 1.65), absmean
    assert np.all(var > 1.6) and np.all(var < 2.6), var
    assert np.all(np.abs(ch.mean(0)) < 0.5)
    assert 0.002 < float(res.acceptance_rates()["overall"].mean()) < 0.05


@pytest.mark.parametrize("path", ["fused", "scan"])
def test_glmcmc_posterior_bands(runs, path):
    _bands(runs[path])


@pytest.mark.parametrize("path", ["fused", "scan"])
def test_glmcmc_shape_counts_and_coin(runs, path):
    res = runs[path]
    assert res.thetas.shape == (1024, 1025, 2)
    np.testing.assert_array_equal(res.thetas[:, 0], 0.0)
    c = res.counts
    np.testing.assert_array_equal(c.global_attempts + c.local_attempts, 1024)
    assert 0.85 < c.global_attempts.mean() / 1024 < 0.95


@pytest.mark.parametrize("path", ["fused", "scan"])
def test_glmcmc_agrees_with_jax_scan(runs, jax_absmean, path):
    ch = runs[path].thetas[:, BURN:].reshape(-1, 2)
    np.testing.assert_allclose(np.abs(ch).mean(0), jax_absmean, atol=0.05)


@pytest.mark.parametrize("path", ["fused", "scan"])
def test_global_mcmc_posterior_bands(path):
    if path == "fused":
        res = run_global_mcmc_fused(PROB, gen(1), 1025, np.zeros(2),
                                    global_frequency=0.5, num_chains=512,
                                    device="cpu")
    else:
        res = run_global_mcmc(PROB, gen(1), 1025, np.zeros(2), IP, LP, 0.5,
                              num_chains=512, device="cpu")
    _bands(res)
    assert 0.45 < res.counts.global_attempts.mean() / 1024 < 0.55


# ------------------------------------------------------------------ (g)
@pytest.mark.parametrize("variant", [
    dict(steps_per_call=64), dict(block_chains=64), dict(kernel="unpacked"),
    dict(kernel="unpacked", steps_per_call=32, block_chains=128)])
def test_fused_bitwise_determinism(variant):
    """A chain's random numbers are a function of (seed, chain, absolute
    step): the chains do not depend on how the run is cut into launches,
    on the thread-block size, or on the layout."""
    kw = dict(num_chains=256, device="cpu")
    base = run_glmcmc_fused(PROB, gen(3), 257, np.zeros(2), **kw)
    other = run_glmcmc_fused(PROB, gen(3), 257, np.zeros(2), **kw, **variant)
    np.testing.assert_array_equal(base.thetas, other.thetas)
    for a, b in zip(base.counts, other.counts):
        np.testing.assert_array_equal(a, b)


def test_fused_auto_kernel_choice(monkeypatch):
    """kernel='auto' takes the packed layout when d | 8 and num_chains is a
    multiple of (8/d) * block_chains, as the JAX driver does; on the CPU
    the wrapper runs its plain version and launches nothing."""
    calls = []
    for cls in (PackedMixtureGLMCMC, FusedMixtureGLMCMC):
        monkeypatch.setattr(cls, "launches", 0)

        def spy(self, *a, _orig=cls.plain, **k):
            calls.append(type(self).__name__)
            return _orig(self, *a, **k)
        monkeypatch.setattr(cls, "plain", spy)
    run_glmcmc_fused(PROB, gen(0), 5, np.zeros(2), num_chains=2048,
                     steps_per_call=4, device="cpu")
    run_glmcmc_fused(PROB, gen(0), 5, np.zeros(2), num_chains=64,
                     steps_per_call=4, device="cpu")
    run_glmcmc_fused(HighDimMixtureProblem(3), gen(0), 5, np.zeros(3),
                     num_chains=64, steps_per_call=4, device="cpu")
    assert calls == ["PackedMixtureGLMCMC", "FusedMixtureGLMCMC",
                     "FusedMixtureGLMCMC"]
    assert PackedMixtureGLMCMC.launches == FusedMixtureGLMCMC.launches == 0
    with pytest.raises(ValueError):
        run_glmcmc_fused(HighDimMixtureProblem(3), gen(0), 5, np.zeros(3),
                         num_chains=64, kernel="packed", device="cpu")


def test_fused_ragged_segments_and_history_off():
    """num_ite - 1 not a multiple of steps_per_call: the history is still
    exactly num_ite long and the counters are pro rata."""
    res = run_glmcmc_fused(PROB, gen(4), 101, np.zeros(2), num_chains=64,
                           steps_per_call=64, device="cpu")
    assert res.thetas.shape == (64, 101, 2)
    total = res.counts.global_attempts + res.counts.local_attempts
    np.testing.assert_array_equal(total, 100)
    off = run_glmcmc_fused(PROB, gen(4), 101, np.zeros(2), num_chains=64,
                           steps_per_call=64, collect_history=False,
                           device="cpu")
    assert off.thetas.shape == (64, 1, 2)
    # the final carry is two whole launches ahead of the start
    full = run_glmcmc_fused(PROB, gen(4), 129, np.zeros(2), num_chains=64,
                            steps_per_call=64, device="cpu")
    np.testing.assert_array_equal(off.thetas[:, 0], full.thetas[:, -1])


def test_fused_checkpoint_resume(tmp_path):
    kw = dict(num_chains=128, steps_per_call=32, device="cpu")
    full = run_glmcmc_fused(PROB, gen(5), 161, np.zeros(2), **kw)
    ck = str(tmp_path / "fused_ckpt")
    run_glmcmc_fused(PROB, gen(5), 97, np.zeros(2), checkpoint_path=ck, **kw)
    rest = run_glmcmc_fused(PROB, gen(99), 161, np.zeros(2),
                            checkpoint_path=ck, resume=True, **kw)
    np.testing.assert_array_equal(rest.thetas, full.thetas[:, 97:])
    for a, b in zip(rest.counts, full.counts):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="mismatch"):
        run_glmcmc_fused(PROB, gen(5), 161, np.zeros(2), checkpoint_path=ck,
                         resume=True, num_chains=128, steps_per_call=64,
                         device="cpu")


@pytest.mark.parametrize("kernel", ["packed", "unpacked"])
def test_fused_checkpoint_of_the_first_layout_resumes(tmp_path, kernel):
    """A checkpoint in the layout the fused GLMCMC loop wrote before the
    fused drivers shared one checkpoint writer (the state, three float64
    counters, ``steps_run``, ``call_idx``, ``seed`` and the configuration
    as ``meta.*``) resumes bit for bit."""
    kw = dict(num_chains=128, steps_per_call=32, block_chains=32, seed=77,
              kernel=kernel, device="cpu")
    full = run_glmcmc_fused(PROB, gen(5), 161, np.zeros(2), **kw)
    part = run_glmcmc_fused(PROB, gen(5), 97, np.zeros(2), **kw)
    (theta, y, logk), c = part.final_carry, part.counts
    arrays = {"theta": theta, "y": y, "logk": logk,
              "g_att": c.global_attempts.astype(np.float64),
              "g_acc": c.global_accepts.astype(np.float64),
              "l_acc": c.local_accepts.astype(np.float64),
              "steps_run": 96, "call_idx": 3, "seed": 77}
    meta = {"kernel": kernel, "algorithm": "glmcmc", "num_chains": 128,
            "theta_dim": 2, "steps_per_call": 32, "block_chains": 32,
            "world_size": 1}
    arrays.update({f"meta.{k}": v for k, v in meta.items()})
    ck = str(tmp_path / "first_layout")
    save_carry(ck, arrays, step=96)
    rest = run_glmcmc_fused(PROB, gen(99), 161, np.zeros(2),
                            checkpoint_path=ck, resume=True, **kw)
    np.testing.assert_array_equal(rest.thetas, full.thetas[:, 97:])
    for a, b in zip(rest.counts, full.counts):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(rest.final_carry, full.final_carry):
        assert torch.equal(a, b)


def test_scan_checkpoint_resume(tmp_path):
    kw = dict(num_chains=16, segment_size=40, device="cpu")
    full = run_glmcmc(PROB, gen(6), 161, np.zeros(2), IP, LP, 0.9, 5, **kw)
    ck = str(tmp_path / "scan_ckpt")
    run_glmcmc(PROB, gen(6), 81, np.zeros(2), IP, LP, 0.9, 5,
               checkpoint_path=ck, **kw)
    rest = run_glmcmc(PROB, gen(6), 161, np.zeros(2), IP, LP, 0.9, 5,
                      checkpoint_path=ck, resume=True, **kw)
    np.testing.assert_array_equal(rest.thetas, full.thetas[:, 81:])
    for a, b in zip(rest.counts, full.counts):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["fused", "scan"])
def test_runner_csv(tmp_path, method):
    runner = MCMCRunner(PROB, output_dir=str(tmp_path), seed=0, num_chains=64,
                        verbose=False, device="cpu")
    extra = dict(steps_per_call=64) if method == "fused" else {}
    ch = runner.run_glmcmc(129, np.zeros(2), None, 0.9, LP, IP, 5,
                           method=method, **extra)
    assert ch.shape == (64, 129, 2)
    csv = np.loadtxt(tmp_path / "glmcmc_results.csv", delimiter=",")
    assert csv.shape == (129, 2)
    np.testing.assert_allclose(csv, ch[0], rtol=1e-6, atol=1e-7)
    res = runner.last_result
    np.testing.assert_array_equal(
        res.counts.global_attempts + res.counts.local_attempts, 128)
    ch = runner.run_global_mcmc(65, np.zeros(2), None, 0.5, LP, IP,
                                method=method, **extra)
    csv = np.loadtxt(tmp_path / "global_mcmc_results.csv", delimiter=",")
    assert ch.shape == (64, 65, 2) and csv.shape == (65, 2)


def test_runner_summary_and_unported_methods(tmp_path, capsys):
    runner = MCMCRunner(PROB, output_dir=str(tmp_path), num_chains=4,
                        device="cpu")
    runner.run_glmcmc(33, np.zeros(2), None, 0.9, LP, IP, 5,
                      output_file=None)
    out = capsys.readouterr().out
    assert "[GLMCMC] 4 chain(s) x 33 iterations" in out
    assert "R-hat" in out
    # every runner method is ported; a tile_program that is not the port's
    # TileProgram is refused
    with pytest.raises(TypeError, match="TileProgram"):
        runner.run_glmala(5, np.zeros(2), None, 0.8, IP, 5, 0.3, 4,
                          method="fused", tile_program=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        runner.run_glmcmc_nf(5, np.zeros(2), None, 0.5, LP, IP, 5, 4, 2,
                             mesh=object())
    # use_native_io is ported: chain 0's CSV through the C++ writer
    native = MCMCRunner(PROB, output_dir=str(tmp_path), use_native_io=True,
                        num_chains=4, verbose=False, device="cpu")
    ch = native.run_glmcmc(17, np.zeros(2), None, 0.9, LP, IP, 5,
                           output_file="native.csv")
    csv = np.loadtxt(tmp_path / "native.csv", delimiter=",",
                     dtype=np.float32)
    np.testing.assert_array_equal(csv, ch[0])
    # mesh= is ported: a mesh that is not a 1-D DeviceMesh is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        run_glmcmc_fused(PROB, gen(0), 5, np.zeros(2), mesh=object(),
                         device="cpu")


def test_import_pulls_in_no_jax():
    """A fresh interpreter's ``import glabc_tpu_torch`` loads no module of
    JAX or of the JAX package."""
    code = ("import sys; before = set(sys.modules); import glabc_tpu_torch; "
            "new = set(sys.modules) - before; "
            "bad = sorted(m for m in new if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'glabc_tpu' or "
            "m.startswith('glabc_tpu.')); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import\s+(jax|glabc_tpu)\b(?!_torch)|"
                         r"from\s+(jax|glabc_tpu)\b(?!_torch))", re.M)
    files = list((ROOT / "glabc_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f


def test_entry_points_need_a_device_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_glmcmc_fused(PROB, gen(0), 5, np.zeros(2), num_chains=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_glmcmc(PROB, gen(0), 5, np.zeros(2), IP, LP, 0.9, 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MCMCRunner(PROB, output_dir=str(tmp_path))
