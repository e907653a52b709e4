"""The port's last modules held against glabc_tpu on the CPU.

* Chain IO: the port's and the JAX package's ``ChainWriter`` on the same
  seeded chains write byte-identical files (the chain-0 CSV, native and
  Python; per-chain CSVs; the native binary file and its sidecar), and
  each package's ``read_binary_chains`` reads the other's file exactly,
  whole segments only after a crash.  When ``g++`` is missing or the build
  fails (monkeypatched), the writers fall back to Python and no partial
  library is left.
* ``CheckpointManager``: ``max_to_keep``, ``latest_step``, a snapshot
  taken at ``save``, an interrupted write leaving no partial file, a
  resume bitwise equal to the straight run (the plain GLMCMC carry, and
  K1's loop state through ``chip_smoke.checkpoint_resume``), and files of
  another world size refused.
* ``esjd_per_second`` (rtol 1e-5, float32 reductions in another order)
  and ``categorical_from_weights`` given JAX's own uniforms (exact), with
  ``axis=`` and ``dim=``.
* ``CouplingFlow.forward_t``/``log_prob_t`` against JAX's with the weights
  carried over (``utils/convert.py``), to 2e-5, the flow tests' tolerance.
* ``sample_with_step(progress=True)``: one line per segment, the same
  step marks as JAX's.
* ``debug_mode`` restores the default dtype and anomaly mode after an
  exception; ``trace`` writes a Chrome trace naming an ``annotate`` range.
* Each example of ``glabc_tpu_torch/examples/`` at a tiny size with
  ``--device cpu``, and every public name of ``glabc_tpu``, ``.ops``,
  ``.utils``, ``.models`` and ``.samplers`` present in the port.
"""

import importlib
import importlib.util
import json
import os
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glabc_tpu_torch.native import writer as native_writer
from glabc_tpu_torch.utils import (ChainWriter, CheckpointManager,
                                   annotate, debug_mode, read_binary_chains,
                                   save_carry, trace)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
FLOW_TOL = dict(rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------- chain IO
def _chains(C=4, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(C, d)).astype(np.float32),
            [rng.normal(size=(C, S, d)).astype(np.float32) for S in (40, 25)])


def _jax_native():
    """The JAX package's native writer, loaded.  Its library is built in
    place while the test modules are collected; a worker that lost that
    race keeps a failed load, so load it once more now that it is built."""
    from glabc_tpu.native import writer as jw

    if jw._load() is None:
        jw._build_failed = False
    assert jw._load() is not None


def _write(cls, path, chains, use_native, theta0, segs):
    w = cls(path, chains=chains, use_native=use_native)
    w.write_initial(theta0)
    done = 0
    for seg in segs:
        w.on_segment(seg, done)
        done += seg.shape[1]
    w.close()


def _files(directory):
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory))}


@pytest.mark.parametrize("chains,use_native", [
    (None, True), (None, False), ("all", True), ("all", False),
    ([0, 2], False)])
def test_writer_files_match_jax(tmp_path, chains, use_native):
    from glabc_tpu.utils.io import ChainWriter as JChainWriter

    if use_native:
        _jax_native()
        assert native_writer.native_available()
    theta0, segs = _chains()
    name = "h.bin" if chains == "all" and use_native else "h.csv"
    for sub, cls in (("port", ChainWriter), ("jax", JChainWriter)):
        os.makedirs(tmp_path / sub)
        _write(cls, str(tmp_path / sub / name), chains, use_native, theta0,
               segs)
    port, jax_files = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert port == jax_files
    n_files = {None: 1, "all": 4, (0, 2): 2}[
        tuple(chains) if isinstance(chains, list) else chains]
    if chains == "all" and use_native:
        assert sorted(port) == ["h.bin", "h.bin.meta.json"]
    else:
        assert len(port) == n_files


def test_read_binary_chains_across_packages(tmp_path):
    """Each package's reader on the other's binary file, whole and cut in
    the middle of its last segment (a crash: the sidecar lists a segment
    the file does not hold in full)."""
    from glabc_tpu.utils.io import ChainWriter as JChainWriter
    from glabc_tpu.utils.io import read_binary_chains as j_read

    _jax_native()
    theta0, segs = _chains(C=6, d=2, seed=1)
    want = np.concatenate([theta0[:, None]] + segs, axis=1)
    port, jaxf = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    _write(ChainWriter, port, "all", True, theta0, segs)
    _write(JChainWriter, jaxf, "all", True, theta0, segs)
    np.testing.assert_array_equal(j_read(port), want)
    np.testing.assert_array_equal(read_binary_chains(jaxf), want)
    for path in (port, jaxf):
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 4 * 7)
        np.testing.assert_array_equal(read_binary_chains(path),
                                      want[:, :41])
        np.testing.assert_array_equal(j_read(path), want[:, :41])


def test_runner_native_io_reads_back(tmp_path):
    """``MCMCRunner(use_native_io=True, write_chains='all')`` under the
    fused driver: the binary file is the run's history, for both
    readers."""
    from glabc_tpu.utils.io import read_binary_chains as j_read
    from glabc_tpu_torch import DiagGaussian, MCMCRunner, MixtureProblem

    _jax_native()
    runner = MCMCRunner(MixtureProblem(0.05), output_dir=str(tmp_path),
                        num_chains=16, verbose=False, write_chains="all",
                        use_native_io=True, device="cpu")
    ch = runner.run_glmcmc(
        33, np.zeros(2), None, 0.9, DiagGaussian.create(2, 0.0, np.log(0.35)),
        DiagGaussian.create(2), 5, output_file="h.bin", method="fused",
        steps_per_call=8)
    path = str(tmp_path / "h.bin")
    np.testing.assert_array_equal(read_binary_chains(path), ch)
    np.testing.assert_array_equal(j_read(path), ch)


@pytest.fixture
def fresh_native():
    native_writer._load.cache_clear()
    yield
    native_writer._load.cache_clear()


@pytest.mark.parametrize("failure", ["no_gxx", "compile_error"])
def test_native_build_failure_falls_back(tmp_path, monkeypatch, fresh_native,
                                         failure):
    """Without ``g++``, or when the source does not compile, no library
    (and no temporary file) is left, ``native_available()`` is False, and
    ``ChainWriter(use_native=True)`` and ``MCMCRunner(use_native_io=True)``
    write with the Python writer, byte for byte its files."""
    from glabc_tpu_torch import DiagGaussian, MCMCRunner, MixtureProblem

    build = tmp_path / "build"
    monkeypatch.setattr(native_writer, "BUILD_DIR", build)
    if failure == "no_gxx":
        monkeypatch.setattr(native_writer.shutil, "which", lambda name: None)
        error = FileNotFoundError
    else:
        bad = tmp_path / "chain_writer.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(native_writer, "SRC", bad)
        error = subprocess.CalledProcessError
    with pytest.raises(error):
        native_writer.build()
    assert not build.exists() or not os.listdir(build)
    assert not native_writer.native_available()
    with pytest.raises(RuntimeError):
        native_writer.NativeChainWriter(str(tmp_path / "x.csv"), 2)

    theta0, segs = _chains()
    for chains in (None, "all"):
        for sub, native in (("native", True), ("python", False)):
            os.makedirs(tmp_path / f"{sub}{chains}")
            _write(ChainWriter, str(tmp_path / f"{sub}{chains}" / "h.csv"),
                   chains, native, theta0, segs)
        assert (_files(tmp_path / f"native{chains}")
                == _files(tmp_path / f"python{chains}"))
    runner = MCMCRunner(MixtureProblem(0.05), output_dir=str(tmp_path),
                        num_chains=2, verbose=False, use_native_io=True,
                        device="cpu")
    ch = runner.run_glmcmc(21, np.zeros(2), None, 0.9,
                           DiagGaussian.create(2, 0.0, np.log(0.35)),
                           DiagGaussian.create(2), 5, output_file="r.csv")
    got = np.loadtxt(tmp_path / "r.csv", delimiter=",", dtype=np.float32)
    np.testing.assert_array_equal(got, ch[0])


# ------------------------------------------------------ CheckpointManager
def _ckpt_files(directory):
    return sorted(os.listdir(directory))


def test_checkpoint_versions_and_latest(tmp_path):
    with CheckpointManager(str(tmp_path / "ck"), max_to_keep=2) as mgr:
        assert mgr.latest_step() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore()
        for s in (1, 2, 3, 4, 5):
            mgr.save(s, {"x": torch.full((3,), float(s)), "n": s})
        assert mgr.all_steps() == [4, 5]
        assert mgr.latest_step() == 5
        arrays, step = mgr.restore()
        assert step == 5 and arrays["n"] == 5
        np.testing.assert_array_equal(arrays["x"], [5.0, 5.0, 5.0])
        assert mgr.restore(4)[1] == 4
        with pytest.raises(FileNotFoundError):
            mgr.restore(1)
    assert _ckpt_files(tmp_path / "ck") == ["ckpt_4.npz", "ckpt_5.npz"]
    with CheckpointManager(str(tmp_path / "all"), max_to_keep=None) as mgr:
        for s in range(4):
            mgr.save(s, {"x": np.arange(s + 1)})
        assert mgr.all_steps() == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path / "bad"), max_to_keep=0)


def test_checkpoint_save_snapshots_the_carry(tmp_path):
    """``save`` returns once the arrays are copied: writing the caller's
    tensor afterwards does not reach the file."""
    x = torch.arange(1000, dtype=torch.float32)
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(1, {"x": x})
        x.mul_(-1.0)
        np.testing.assert_array_equal(mgr.restore()[0]["x"],
                                      np.arange(1000, dtype=np.float32))


def test_checkpoint_interrupted_save_leaves_no_file(tmp_path, monkeypatch):
    """A write that fails part way (a full disk) leaves the earlier steps
    as they were and neither the step's file nor a temporary one; the
    error comes out of ``wait``."""
    real_savez = np.savez

    def failing(file, **arrays):
        with open(file, "wb") as f:
            f.write(b"PK\x03\x04 partial")
        raise OSError("no space left on device")

    with CheckpointManager(str(tmp_path), max_to_keep=3) as mgr:
        mgr.save(1, {"x": np.arange(3)}, wait=True)
        monkeypatch.setattr(np, "savez", failing)
        mgr.save(2, {"x": np.arange(4)})
        with pytest.raises(OSError, match="no space"):
            mgr.wait()
        monkeypatch.setattr(np, "savez", real_savez)
        assert _ckpt_files(tmp_path) == ["ckpt_1.npz"]
        arrays, step = mgr.restore()
        assert step == 1
        np.testing.assert_array_equal(arrays["x"], np.arange(3))
        mgr.save(3, {"x": np.arange(5)}, wait=True)
        assert mgr.all_steps() == [1, 3]


def test_checkpoint_resume_plain_carry_is_bitwise(tmp_path):
    """The plain GLMCMC carry (tensors, counts and the generator's state)
    saved after 7 of 20 steps and restored into ``ChainCarry`` runs on to
    the straight run's chains and final carry, bit for bit."""
    from glabc_tpu_torch import DiagGaussian, MixtureProblem
    from glabc_tpu_torch.samplers import (ChainCarry, GLMCMCConfig,
                                          build_glmcmc_step,
                                          init_chain_carry)
    from glabc_tpu_torch.samplers.base import run_segmented

    prob = MixtureProblem(0.05)
    step = build_glmcmc_step(prob, DiagGaussian.create(2),
                             DiagGaussian.create(2, 0.0, np.log(0.35)),
                             GLMCMCConfig(0.9, 5))
    init = lambda: init_chain_carry(prob, torch.Generator().manual_seed(9),
                                    np.zeros(2), num_chains=8, device="cpu")
    end, straight = run_segmented(step, init(), 20, segment_size=6)
    mid, first = run_segmented(step, init(), 7, segment_size=6)
    with CheckpointManager(str(tmp_path)) as mgr:
        mgr.save(7, mid)
        del mid
        arrays, saved = mgr.restore()
    carry = ChainCarry.from_arrays(arrays, torch.Generator(), "cpu")
    end2, rest = run_segmented(step, carry, 13, segment_size=5)
    assert saved == 7
    np.testing.assert_array_equal(np.concatenate([first, rest], axis=1),
                                  straight)
    for a, b in zip(end[:3], end2[:3]):
        assert torch.equal(a, b)
    for a, b in zip(end.counts, end2.counts):
        assert torch.equal(a, b)
    assert torch.equal(end.generator.get_state(), end2.generator.get_state())


def test_checkpoint_resume_k1_loop_is_bitwise(tmp_path):
    """``chip_smoke.checkpoint_resume`` on the CPU (K1's plain version):
    the loop state saved after 1 of 3 launches, restored and run on, gives
    the straight run's history and final state."""
    import sys

    sys.path.insert(0, ROOT)
    import chip_smoke

    straight, resumed, step = chip_smoke.checkpoint_resume(
        "cpu", str(tmp_path), chains=64, launches=3, cut=1, T=8)
    assert step == 1 and straight[0].shape[0] == 16
    for a, b in zip(straight, resumed):
        assert torch.equal(a, b)


def test_checkpoint_of_another_world_size_raises(tmp_path):
    """Files a mesh of 2 wrote (one a rank, ``world_size`` 2 inside) are
    refused by a manager without a mesh, latest or by step, and a rank's
    file of another world size under this one's name fails its metadata."""
    for r in (0, 1):
        save_carry(str(tmp_path / f"ckpt_3.rank{r}.npz"),
                   {"x": np.arange(3), "meta.world_size": 2}, 3)
    with CheckpointManager(str(tmp_path)) as mgr:
        assert mgr.latest_step() is None
        with pytest.raises(ValueError, match="world size"):
            mgr.restore()
        with pytest.raises(ValueError, match="world size"):
            mgr.restore(3)
    save_carry(str(tmp_path / "ckpt_4.npz"),
               {"x": np.arange(3), "meta.world_size": 2}, 4)
    with CheckpointManager(str(tmp_path)) as mgr:
        with pytest.raises(ValueError, match="world size 2"):
            mgr.restore()


# --------------------------------------------------- exports and methods
@pytest.mark.parametrize("shape", [(400, 2), (3, 300, 3)])
def test_esjd_per_second_matches_jax(shape):
    from glabc_tpu.ops import stats as jstats
    from glabc_tpu_torch.ops import esjd_per_second

    x = np.cumsum(np.random.default_rng(2).normal(size=shape), axis=-2)
    x = (0.1 * x).astype(np.float32)
    got = esjd_per_second(torch.from_numpy(x), 2.5, 400)
    want = jstats.esjd_per_second(jnp.asarray(x), 2.5, 400)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def _weights(shape, seed):
    """Linear weights with zeros, negatives and NaNs (zero mass), and one
    row (along the last axis) of zeros only."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.0, 2.0, size=shape).astype(np.float32)
    w[rng.random(shape) < 0.15] = 0.0
    w[rng.random(shape) < 0.1] = -1.0
    w[rng.random(shape) < 0.1] = np.nan
    w.reshape(-1, shape[-1])[0] = 0.0
    return w


@pytest.mark.parametrize("shape,axis", [((7,), 0), ((6, 9), -1), ((6, 9), 0),
                                        ((3, 4, 5), 1)])
@pytest.mark.parametrize("keyword", ["axis", "dim"])
def test_categorical_from_weights_matches_jax(monkeypatch, shape, axis,
                                              keyword):
    """Given the uniforms JAX's Gumbel draw takes (checked against
    ``jax.random.gumbel`` itself), the port picks JAX's indices exactly,
    with ``axis=`` and with ``dim=``."""
    from glabc_tpu.ops import resampling as jres
    from glabc_tpu_torch.ops import categorical_from_weights

    w = _weights(shape, seed=sum(shape) + axis)
    key = jax.random.PRNGKey(sum(shape))
    tiny = np.finfo(np.float32).tiny
    u = np.asarray(jax.random.uniform(key, shape, jnp.float32, minval=tiny,
                                      maxval=1.0))
    np.testing.assert_allclose(-np.log(-np.log(u)),
                               np.asarray(jax.random.gumbel(key, shape)),
                               rtol=1e-6, atol=1e-6)
    want = np.asarray(jres.categorical_from_weights(key, jnp.asarray(w),
                                                    axis=axis))
    monkeypatch.setattr(torch, "rand",
                        lambda size, **kw: torch.from_numpy(u.copy()))
    got = categorical_from_weights(torch.from_numpy(w), **{keyword: axis})
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        categorical_from_weights(torch.from_numpy(w), dim=axis, axis=axis)


def _jax_flow(dim, n_layers=3, hidden=16, seed=0, scale=0.3):
    """A JAX flow whose last layers and base are random (not the
    identity), as in ``tests/test_torch_flow.py``."""
    from glabc_tpu.models.flows import CouplingFlow as JFlow
    from glabc_tpu.models.flows import _CouplingStack

    f = JFlow.create(jax.random.PRNGKey(seed), dim, n_layers, hidden)
    rng = np.random.default_rng(seed)
    st = f.stack
    r = lambda shape, s: jnp.asarray(rng.normal(0, s, shape), jnp.float32)
    stack = _CouplingStack(w0=st.w0, b0=r(st.b0.shape, 0.1), w1=st.w1,
                           b1=r(st.b1.shape, 0.1),
                           w2=r(st.w2.shape, scale / np.sqrt(hidden)),
                           b2=r(st.b2.shape, 0.1))
    base = f.base.__class__(loc=r(dim, 0.3), log_scale=r(dim, 0.2))
    return JFlow(base=base, stack=stack)


@pytest.mark.parametrize("dim", [2, 3, 8])
def test_flow_forward_t_log_prob_t_match_jax(dim):
    """The weights carried over with ``coupling_flow_from_numpy``:
    ``log_prob_t`` against JAX's ``log_prob_t`` on the same points, and
    ``forward_t``'s sample and density against JAX's ``push_t`` of the same
    base draws; ``forward``/``log_prob`` are their transposes."""
    from glabc_tpu_torch.utils.convert import coupling_flow_from_numpy

    jf = _jax_flow(dim, seed=dim)
    st = jf.stack
    f = coupling_flow_from_numpy(st.w0, st.b0, st.w1, st.b1, st.w2, st.b2,
                                 jf.base.loc, jf.base.log_scale)
    rng = np.random.default_rng(20 + dim)
    x_t = (rng.normal(size=(dim, 300)) * 1.5).astype(np.float32)
    np.testing.assert_allclose(
        f.log_prob_t(torch.from_numpy(x_t)).numpy(),
        np.asarray(jf.log_prob_t(jnp.asarray(x_t))), **FLOW_TOL)

    N = 257
    xs, log_q = f.forward_t(N, torch.Generator().manual_seed(dim))
    assert xs.shape == (dim, N) and log_q.shape == (N,)
    eps = torch.randn((N, dim), generator=torch.Generator().manual_seed(dim))
    z = (jf.base.loc + jnp.exp(jf.base.log_scale) * jnp.asarray(eps.numpy()))
    x_ref, s_ref = jf.push_t(z.T)
    np.testing.assert_allclose(xs.numpy(), np.asarray(x_ref), **FLOW_TOL)
    np.testing.assert_allclose(
        log_q.numpy(), np.asarray(jf.base.log_prob(z) - s_ref), **FLOW_TOL)
    np.testing.assert_allclose(
        log_q.numpy(), np.asarray(jf.log_prob_t(jnp.asarray(xs.numpy()))),
        rtol=1e-4, atol=1e-4)

    x, lq = f.forward(N, torch.Generator().manual_seed(dim))
    assert torch.equal(x, xs.T) and torch.equal(lq, log_q)
    assert torch.equal(f.log_prob(x), f.log_prob_t(xs))


def test_sample_with_step_progress_one_line_per_segment(capsys):
    """``progress=True``: one line per segment on stderr, each starting
    with a carriage return, marking the same steps as JAX's
    ``sample_with_step``; the last ends the line.  Off, nothing is
    printed."""
    from glabc_tpu.models import DiagGaussian as JDiag
    from glabc_tpu.models import MixtureProblem as JMixture
    from glabc_tpu.samplers import GLMCMCConfig as JCfg
    from glabc_tpu.samplers import build_glmcmc_step as j_build
    from glabc_tpu.samplers import sample_with_step as j_sample
    from glabc_tpu_torch import DiagGaussian, MixtureProblem
    from glabc_tpu_torch.samplers import (GLMCMCConfig, build_glmcmc_step,
                                          sample_with_step)

    marks = lambda text: re.findall(r"\r\[(\d+)/(\d+)\]", text)
    step = build_glmcmc_step(MixtureProblem(0.05), DiagGaussian.create(2),
                             DiagGaussian.create(2, 0.0, np.log(0.35)),
                             GLMCMCConfig())
    run = lambda progress: sample_with_step(
        MixtureProblem(0.05), step, torch.Generator().manual_seed(0), 11,
        np.zeros(2), num_chains=4, segment_size=3, device="cpu",
        progress=progress)
    capsys.readouterr()
    run(False)
    assert capsys.readouterr().err == ""
    res = run(True)
    err = capsys.readouterr().err
    assert res.thetas.shape == (4, 11, 2)
    assert marks(err) == [("3", "10"), ("6", "10"), ("9", "10"),
                          ("10", "10")]
    assert err.count("\r") == 4 and err.endswith("\n")
    assert err.count("transitions/s") == 4

    jstep = j_build(JMixture(0.05), JDiag.create(2),
                    JDiag.create(2, 0.0, float(np.log(0.35))), JCfg())
    j_sample(JMixture(0.05), jstep, jax.random.PRNGKey(0), 11, jnp.zeros(2),
             num_chains=4, segment_size=3, progress=True)
    assert marks(capsys.readouterr().err) == marks(err)


@pytest.mark.parametrize("nans,x64", [(True, False), (True, True),
                                      (False, True), (False, False)])
@pytest.mark.parametrize("start", [torch.float32, torch.float64])
def test_debug_mode_restores_after_exception(nans, x64, start):
    prev = torch.get_default_dtype(), torch.is_anomaly_enabled()
    torch.set_default_dtype(start)
    torch.set_anomaly_enabled(not nans)
    try:
        with pytest.raises(KeyError):
            with debug_mode(nans=nans, x64=x64):
                assert torch.is_anomaly_enabled() is nans
                assert torch.get_default_dtype() == (
                    torch.float64 if x64 else torch.float32)
                assert torch.zeros(1).dtype == torch.get_default_dtype()
                raise KeyError("inside")
        assert torch.get_default_dtype() == start
        assert torch.is_anomaly_enabled() is (not nans)
    finally:
        torch.set_default_dtype(prev[0])
        torch.set_anomaly_enabled(prev[1])


def test_trace_writes_chrome_trace_with_annotate_ranges(tmp_path):
    @annotate("decorated_scope")
    def work(x):
        return (x * 2).sum()

    with trace(str(tmp_path / "tr")) as prof:
        with annotate("m13_scope"):
            work(torch.ones(64))
    assert os.path.dirname(prof.trace_path) == str(tmp_path / "tr")
    with open(prof.trace_path, encoding="utf-8") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert {"m13_scope", "decorated_scope"} <= names


# --------------------------------------------------------------- examples
def _example(name):
    path = os.path.join(ROOT, "glabc_tpu_torch", "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EXAMPLES = [
    ("mixture", ["--sampler", "glmcmc", "--num-ite", "300", "--chains",
                 "2"]),
    ("mixture", ["--sampler", "all", "--num-ite", "200", "--chains", "2"]),
    ("mixture", ["--method", "fused", "--num-ite", "257", "--chains",
                 "64"]),
    ("mixture_hyper", ["--num-ite", "60", "--seeds", "2"]),
    ("ma2", ["--num-ite", "200", "--chains", "2", "--num-draws", "16"]),
    ("ma2", ["--method", "fused", "--num-ite", "65", "--chains", "64"]),
    ("ma2", ["--method", "aglmcmc", "--num-ite", "201", "--chains", "64"]),
    ("gk", ["--num-ite", "40", "--chains", "2"]),
    ("marjoram", ["--num-ite", "300", "--chains", "2"]),
    ("marjoram_crosscheck", ["--num-ite", "2000", "--chains", "2"]),
]


@pytest.mark.parametrize("name,argv", EXAMPLES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(EXAMPLES)])
def test_example_runs_on_cpu(tmp_path, capsys, name, argv):
    mod = _example(name)
    if name == "mixture":
        argv = argv + ["--output-dir", str(tmp_path)]
    if name == "marjoram_crosscheck":
        mod.OUT = str(tmp_path)
    out = mod.main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    if name == "mixture":
        num_ite = int(argv[argv.index("--num-ite") + 1])
        rows = np.loadtxt(tmp_path / "glmcmc_results.csv", delimiter=",")
        assert rows.shape == (num_ite, 2)
        assert "ESJD" in text and "E|theta|" in text
        assert all(np.all(np.isfinite(v)) for v in out.values())
    elif name == "mixture_hyper":
        assert "best global_frequency" in text and len(out[1]) == 11
    elif name in ("ma2", "gk", "marjoram"):
        assert np.isfinite(out.thetas).all()
        assert "Mean" in text
    else:
        assert {"marjoram_crosscheck.md", "traceplot_GLMCMC.pdf",
                "posterior_marjoram_fill.pdf"} <= set(os.listdir(tmp_path))
        assert all(np.all(np.isfinite(v)) for v in out)


# ------------------------------------------------------------ public names
@pytest.mark.parametrize("module", ["", ".ops", ".utils", ".models",
                                    ".samplers"])
def test_every_public_name_has_a_counterpart(module):
    """Every name in a ``glabc_tpu`` module's ``__all__`` is in the
    port's module's ``__all__`` and importable from it."""
    jmod = importlib.import_module("glabc_tpu" + module)
    tmod = importlib.import_module("glabc_tpu_torch" + module)
    assert set(jmod.__all__) - set(tmod.__all__) == set()
    for name in tmod.__all__:
        assert hasattr(tmod, name), name
