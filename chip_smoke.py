#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port, ``glabc_tpu_torch``, on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA GPU and ``nvcc``::

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: ``glabc_tpu_torch/csrc`` with nvcc for sm_90a (registers, spills);
3. kernels against their plain torch versions on one Philox stream: the
   Philox known-answer vectors, then T=64 steps of 65,536 chains for packed
   d=2 (GLMCMC and GlobalMCMC), unpacked d=2, d=3 and d=5 (the runtime-d
   build);
4. the main path at bench.py's shape: ``PackedMixtureGLMCMC.run`` on
   524,288 columns x 4 = 2,097,152 chains, T=256 with the history on the
   card, one warm-up and 3 x 4 timed launches, and the posterior check
   E|theta| in [1.40, 1.45];
5. the same path through the user's entry point: ``MCMCRunner`` with
   65,536 chains, ``run_glmcmc`` and ``run_global_mcmc`` with
   ``method='fused'`` on the 2-D Mixture problem, and ``run_glmcmc`` on the
   3-D HighDimMixtureProblem (the unpacked layout), held to the posterior
   and move-fraction bands of the verify recipe and to the port's plain
   path;
6. each kernel against its plain version at its main-path shape, times and
   bounds, and its launches on every path of phases 4-5, counted from 0
   just before each path and read just after it.

The last two lines are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before them;
without a CUDA device, or without ``glabc_tpu_torch`` beside this file, the
script fails at once.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet): HBM3 at
# 3.35 TB/s, and 67 TFLOP/s float32 outside the tensor cores, which counts a
# fused multiply-add as two: one 32-bit operation per lane per clock is
# 132 SMs x 128 lanes x 1.98 GHz = 33.5e12 operations/s.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 132 * 128 * 1.98e9

DEVICE = "cuda"
BENCH_COLS = 524288    # bench.py's columns; x 4 chains each at d=2
CHAINS = 65536         # kernel-vs-plain checks and the entry-point runs
SCAN_CHAINS = 4096     # the plain path on the card, the d=3 reference
ITERS = 1025           # entry-point run length: 4 launches of T=256

CHAIN_TOL = 1e-5       # a chain "differs" when any value is further apart
MAX_DIFF_SHARE = 1e-3  # accept tests at their threshold may round either way


def log(msg):
    print(msg, flush=True)


def die(msg):
    log(f"[FAIL] {msg}")
    sys.exit(1)


def check(cond, msg):
    if not cond:
        die(msg)


# ------------------------------------------------------------ accounting
def transition_ops(d, B, glmcmc):
    """32-bit operations one transition of one chain needs at the least:
    every add, multiply, compare, select and integer operation counts one,
    and so does each log, sqrt, sin and cos (their accurate versions take
    several), so this is a lower bound."""
    Bp = B if glmcmc else 1                 # proposals drawn per step
    n_scalar = B + 3 if glmcmc else 3       # Gumbels / coin / accept uniforms
    pairs = Bp + 1                          # candidate sets incl. the local one
    blocks = -(-n_scalar // 4) + pairs * -(-d // 2)
    ops = 80 * blocks                       # Philox4x32-10: 10 x (2 mulhi,
    #                                         2 mullo, 4 xor)
    ops += 5 * (n_scalar + 2 * d * pairs)   # uniform: shift, cvt, mul, add, min
    ops += 8 * d * pairs                    # Box-Muller pair: log, mul, sqrt,
    #                                         mul, cos, sin, 2 mul
    ops += 5 * d * pairs                    # candidate theta (2) and y (3)
    gauss_calls = 2 * B + 3 if glmcmc else 5
    ops += 6 * d * gauss_calls              # Gaussian log-density, per dim
    ops += (3 * d + 2) * pairs              # epsilon-kernel of the discrepancy
    if glmcmc:
        ops += 4 * (B + 1)                  # Gumbels: 2 log, 2 neg
        ops += 3 + B * (7 + 2 * d)          # iSIR scores, argmax, selects
    else:
        ops += 9 + 2 * d                    # MH ratio, log u, selects
    ops += 16 + 4 * d                       # local MH, coin, final selects,
    #                                         four counters
    return ops


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(bytes_moved, ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


# ------------------------------------------------------------ comparison
def per_chain(x, groups):
    """A layout tensor ``(..., rows, C)`` -> ``(groups * C, -1)``: chain
    ``g * C + c`` owns rows ``[g * rows/groups, (g+1) * rows/groups)`` of
    column c."""
    lead = x.shape[:-2]
    rows, cols = x.shape[-2:]
    x = x.reshape(*lead, groups, rows // groups, cols)
    x = x.movedim(-3, 0).movedim(-1, 1)
    return x.reshape(groups * cols, -1)


def compare(got, want, groups):
    """Max abs difference over every output, the share of chains with any
    value more than CHAIN_TOL apart, and the step-1 history difference."""
    import torch

    names = ["theta", "y", "logk", "history"] + list(got[4]._fields)
    outs = [*got[:4], *got[4]]
    refs = [*want[:4], *want[4]]
    bad = None
    max_abs = 0.0
    for name, a, b in zip(names, outs, refs):
        if a.shape != b.shape:
            die(f"{name}: kernel shape {tuple(a.shape)}, plain "
                f"{tuple(b.shape)}")
        diff = (a - b).abs()
        if not torch.isfinite(a).all():
            die(f"{name}: the kernel wrote non-finite values")
        max_abs = max(max_abs, float(diff.max()))
        row_bad = (per_chain(diff, groups) > CHAIN_TOL).any(dim=1)
        bad = row_bad if bad is None else bad | row_bad
    step1 = float((got[3][0] - want[3][0]).abs().max())
    return max_abs, float(bad.float().mean()), step1


def timed(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = None
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def wall(fn):
    """Host seconds of ``fn()`` up to the end of its work on the card."""
    import torch

    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t, out


def kernel_intervals(prof, name):
    """(start, end) microseconds on the card of every kernel whose name
    contains ``name``, in order, from the profiler's trace."""
    return sorted((ev.time_range.start, ev.time_range.end)
                  for ev in prof.events() if name in ev.name
                  and "CUDA" in str(getattr(ev, "device_type", "CUDA")))


def sass_counts(lib_path):
    """Static SASS instruction count of each kernel in the library, by
    ``cuobjdump -sass`` (None when the tool is missing)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=120).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            counts[fn] += 1
    return counts


def counted(fn):
    """``fn()`` with every wrapper's launch count set to 0 just before it;
    returns its result and the counts read just after."""
    from glabc_tpu_torch.ops.kernels import (FusedMixtureGLMCMC,
                                             PackedMixtureGLMCMC)

    PackedMixtureGLMCMC.launches = 0
    FusedMixtureGLMCMC.launches = 0
    out = fn()
    return out, {"packed": PackedMixtureGLMCMC.launches,
                 "unpacked": FusedMixtureGLMCMC.launches}


# ---------------------------------------------------------------- phases
def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; {torch.cuda.device_count()} "
        f"device(s), using 0: {name}")
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout
    except (FileNotFoundError, subprocess.TimeoutExpired):
        smi = ""
    card = (smi.strip().splitlines() or ["not measured"])[0]
    log(f"[device] nvidia-smi: {card}")
    return name, card


def phase_build():
    from glabc_tpu_torch.ops.kernels import _build

    t = time.perf_counter()
    _build.load_library()
    seconds = time.perf_counter() - t
    log(f"[build] nvcc {' '.join(_build.NVCC_FLAGS)}: {seconds:.1f} s")
    for line in _build.build_log().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")
    counts = sass_counts(str(_build.lib_path()))
    if counts is None:
        log("[build] static SASS size: not measured (no cuobjdump)")
    else:
        for fn, n in counts.items():
            log(f"[build] static SASS {fn}: {n} instructions")


def make_kernel(layout, problem, T, algorithm="glmcmc"):
    """The canonical config: gf=0.9, B=5, N(0, I) proposal, RW scale 0.35."""
    from glabc_tpu_torch.ops.kernels import (FusedMixtureGLMCMC,
                                             PackedMixtureGLMCMC)

    cls = PackedMixtureGLMCMC if layout == "packed" else FusedMixtureGLMCMC
    return cls(problem.theta_dim, problem.y_obs.numpy(),
               epsilon=problem.epsilon, sigma=problem._noise_std,
               global_frequency=0.9, batch_size=5, ip_loc=0.0, ip_scale=1.0,
               lp_scale=0.35, steps_per_call=T, block_chains=512,
               collect_history=True, algorithm=algorithm)


def init_state(kern, problem, chains, seed):
    import numpy as np
    import torch
    from glabc_tpu_torch.ops.kernels import (PackedMixtureGLMCMC,
                                             fused_state_init,
                                             packed_state_init)

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    d = problem.theta_dim
    if isinstance(kern, PackedMixtureGLMCMC):
        return packed_state_init(problem, g, np.zeros(d), chains // kern.pack,
                                 kern.pack, device=DEVICE), kern.pack
    return fused_state_init(problem, g, np.zeros(d), chains, kern.d_pad,
                            device=DEVICE), 1


def phase_kernel_vs_plain():
    import numpy as np
    import torch
    from glabc_tpu_torch import HighDimMixtureProblem, MixtureProblem
    from glabc_tpu_torch.ops.kernels.philox import philox4x32, philox4x32_cuda

    kat = [((0, 0, 0, 0, 0, 0),
            (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
           ((0xFFFFFFFF,) * 6,
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822,
             0x299F31D0), (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    words = torch.tensor([w for w, _ in kat], dtype=torch.int64,
                         device=DEVICE)
    got = philox4x32_cuda(words).tolist()
    check(got == [list(want) for _, want in kat],
          f"philox.cuh known answers: got {got}")
    rng = np.random.default_rng(0)
    rand = torch.from_numpy(rng.integers(0, 2**32, (1 << 16, 6),
                                         dtype=np.uint64).astype(np.int64))
    rand = rand.to(DEVICE)
    plain = torch.stack(philox4x32(*(rand[:, i] for i in range(4)),
                                   0x1234ABCD, 0x0BADF00D), 1)
    rand[:, 4], rand[:, 5] = 0x1234ABCD, 0x0BADF00D
    check(torch.equal(philox4x32_cuda(rand), plain),
          "philox.cuh and the torch Philox disagree")
    log("[K0] philox.cuh: the 3 Random123 known-answer vectors and 65,536 "
        "random counters agree bitwise with the torch Philox")

    cases = [("packed", 2, "glmcmc"), ("packed", 2, "global"),
             ("unpacked", 2, "glmcmc"), ("unpacked", 3, "glmcmc"),
             ("unpacked", 5, "global")]
    for layout, d, algorithm in cases:
        problem = MixtureProblem(0.05) if d == 2 else HighDimMixtureProblem(d)
        kern = make_kernel(layout, problem, 64, algorithm)
        state, groups = init_state(kern, problem, CHAINS, seed=d)
        out = kern.run(7, *state, step0=128)
        ref = kern.plain(7, *state, step0=128)
        torch.cuda.synchronize()
        max_abs, share, step1 = compare(out, ref, groups)
        log(f"[kernel-vs-plain] {layout} d={d} {algorithm}: {CHAINS:,} chains x "
            f"64 steps, max abs diff {max_abs:.3g}, share of chains "
            f"differing by > {CHAIN_TOL:g}: {share:.3g}, step-1 history "
            f"max abs diff {step1:.3g}")
        check(share <= MAX_DIFF_SHARE, f"{layout} d={d} {algorithm}: "
              f"{share:.3%} of chains differ from the plain version")
        check(step1 <= CHAIN_TOL, f"{layout} d={d} {algorithm}: step-1 "
              "history differs from the plain version")


def phase_main_bench(card):
    """bench.py's shape through PackedMixtureGLMCMC.run."""
    import torch
    from glabc_tpu_torch import MixtureProblem

    problem = MixtureProblem(0.05)
    kern = make_kernel("packed", problem, 256)
    cols = BENCH_COLS
    (theta, y, logk), _ = init_state(kern, problem, cols * kern.pack, seed=0)
    chains = cols * kern.pack
    seed = 1
    run = {"state": (theta, y, logk), "inputs": None, "out": None, "call": 0,
           "host_ms": []}

    def launch():
        t = time.perf_counter()
        run["inputs"] = run["state"]
        run["out"] = kern.run(seed, *run["state"], step0=run["call"] * kern.T)
        run["host_ms"].append(1e3 * (time.perf_counter() - t))
        run["state"] = run["out"][:3]
        run["call"] += 1
        return run["out"]

    def windows():
        from torch.profiler import ProfilerActivity, profile

        launch()                                 # warm-up
        torch.cuda.synchronize()
        reps = [timed(launch, 4)[0] for _ in range(2)]
        run["host_ms"].clear()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            reps.append(timed(launch, 4)[0])
        return reps, prof

    (reps, prof), counts = counted(windows)
    check(counts == {"packed": 13, "unpacked": 0},
          f"bench: 13 launches of the packed kernel expected, got {counts}")
    out = run["out"]
    hist = out[3]
    torch.cuda.synchronize()
    per_launch = sorted(reps)[1]
    rate = chains * kern.T / (per_launch / 1e3)
    log(f"[main] {cols:,} columns x pack {kern.pack} = {chains:,} chains x "
        f"T={kern.T} per launch, history on the card "
        f"({hist.numel() * 4 / 2**30:.2f} GiB); {card}")
    log(f"[main] ms per launch in 3 windows of 4: "
        f"{', '.join(f'{m:.3f}' for m in reps)}; median {per_launch:.3f} ms "
        f"-> {rate:.6g} transitions/s")
    # the last window, read from the profiler's trace: kernel time, the gaps
    # between consecutive kernels, and the host time of each run() call
    spans = kernel_intervals(prof, "mixture_glmcmc_kernel")
    window_us = 4e3 * reps[-1]
    host = ", ".join(f"{m:.3f}" for m in run["host_ms"])
    check(len(spans) == 4, f"the profiler saw {len(spans)} kernels in the "
          "last window, not 4")
    busy_us = sum(e - s for s, e in spans)
    gaps = [s2 - e1 for (_, e1), (s2, _) in zip(spans, spans[1:])]
    log(f"[main] last window {window_us / 1e3:.3f} ms: kernel busy share "
        f"{busy_us / window_us:.5f}; gaps between kernels "
        f"{', '.join(f'{g:.1f}' for g in gaps)} us; before the first and "
        f"after the last {window_us - busy_us - sum(gaps):.1f} us; host ms "
        f"per run() call {host}")
    absmean = [float(hist[:, j::2, :].abs().mean(dim=(1, 2),
                                                 dtype=torch.float64).mean())
               for j in range(2)]
    log(f"[main] per-dim E|theta| over the last launch's history: {absmean}")
    for m in absmean:
        check(1.40 <= m <= 1.45, f"posterior self-check: E|theta| = "
              f"{absmean}, expected in [1.40, 1.45]")
    return dict(kern=kern, last_in=run["inputs"], seed=seed,
                step0=(run["call"] - 1) * kern.T, ms=per_launch, rate=rate,
                launches=counts)


def _bands(name, ch, res, secs, *, move_band=None, esjd_band=None,
           absmean_band=(1.40, 1.50), var_band=(1.95, 2.25), gf=None):
    import numpy as np
    import torch
    from glabc_tpu_torch.ops.stats import esjd

    check(np.isfinite(ch).all(), f"{name}: non-finite chains")
    steps = ch.shape[1] - 1
    c = res.counts
    check(np.all(c.global_attempts + c.local_attempts == steps),
          f"{name}: move counts do not sum to {steps} per chain")
    post = ch[:, 256:]
    flat = post.reshape(-1, ch.shape[-1]).astype(np.float64)
    absmean, var = np.abs(flat).mean(0), flat.var(0)
    moved = float(np.any(post[:, 1:] != post[:, :-1], axis=-1).mean())
    ej = float(esjd(torch.from_numpy(post).to(DEVICE)).mean())
    acc = float(res.acceptance_rates()["overall"].mean())
    g = float(c.global_attempts.mean()) / steps
    log(f"[entry] {name}: {ch.shape[0]:,} chains x {ch.shape[1]} iterations, "
        f"wall {secs:.2f} s (runner call, history copied to the host); "
        f"after step 256: E|theta| {absmean.round(4).tolist()}, var "
        f"{var.round(4).tolist()}, move fraction {moved:.5f}, mean per-chain "
        f"ESJD {ej:.5f}; acceptance {acc:.5f}, global share {g:.4f}")
    check(np.all((absmean >= absmean_band[0]) & (absmean <= absmean_band[1])),
          f"{name}: E|theta| {absmean} outside {absmean_band}")
    check(np.all((var >= var_band[0]) & (var <= var_band[1])),
          f"{name}: variance {var} outside {var_band}")
    check(0.002 < acc < 0.05, f"{name}: acceptance {acc} outside (0.002, 0.05)")
    if move_band:
        check(move_band[0] <= moved <= move_band[1],
              f"{name}: move fraction {moved} outside {move_band}")
    if esjd_band:
        check(esjd_band[0] <= ej <= esjd_band[1],
              f"{name}: ESJD {ej} outside {esjd_band}")
    if gf is not None:
        check(abs(g - gf) < 0.01, f"{name}: global share {g}, expected {gf}")


def _csv(runner, fname, ch):
    import numpy as np

    rows = np.loadtxt(os.path.join(runner.output_dir, fname), delimiter=",",
                      ndmin=2)
    check(rows.shape == ch[0].shape, f"{fname}: {rows.shape} rows x cols, "
          f"expected {ch[0].shape}")
    check(np.allclose(rows, ch[0], rtol=1e-6, atol=1e-7),
          f"{fname} differs from chain 0")


def phase_entry_points(tmp):
    import numpy as np
    from glabc_tpu_torch import (DiagGaussian, HighDimMixtureProblem,
                                 MCMCRunner, MixtureProblem)

    calls = (ITERS - 1) // 256           # launches of T=256 per entry run
    paths = {}

    def path(name, fn, layout):
        (secs, out), counts = counted(lambda: wall(fn))
        paths[name] = counts
        want = {"packed": 0, "unpacked": 0, layout: calls}
        check(counts == want, f"{name}: launches {counts}, expected {want}")
        return secs, out

    lp = DiagGaussian.create(2, 0.0, math.log(0.35))
    ip = DiagGaussian.create(2, 0.0, 0.0)
    runner = MCMCRunner(MixtureProblem(0.05), output_dir=tmp, seed=0,
                        num_chains=CHAINS, verbose=False)
    secs, ch = path("run_glmcmc", lambda: runner.run_glmcmc(
        ITERS, np.zeros(2), None, 0.9, lp, ip, 5, method="fused"), "packed")
    check(ch.shape == (CHAINS, ITERS, 2), f"GLMCMC chains {ch.shape}")
    _csv(runner, "glmcmc_results.csv", ch)
    _bands("GLMCMC (fused, packed)", ch, runner.last_result, secs,
           move_band=(0.008, 0.012), esjd_band=(0.02, 0.04), gf=0.9)

    secs, ch = path("run_global_mcmc", lambda: runner.run_global_mcmc(
        ITERS, np.zeros(2), None, 0.5, lp, ip, method="fused"), "packed")
    _csv(runner, "global_mcmc_results.csv", ch)
    _bands("GlobalMCMC (fused, packed)", ch, runner.last_result, secs,
           gf=0.5)

    # d = 3 does not divide 8: the unpacked layout, held to the plain path
    prob3 = HighDimMixtureProblem(3)
    lp3 = DiagGaussian.create(3, 0.0, math.log(0.35))
    ip3 = DiagGaussian.create(3, 0.0, 0.0)
    runner3 = MCMCRunner(prob3, output_dir=tmp, seed=1, num_chains=CHAINS,
                         verbose=False)
    secs, ch3 = path("run_glmcmc_d3", lambda: runner3.run_glmcmc(
        ITERS, np.zeros(3), None, 0.9, lp3, ip3, 5,
        output_file="glmcmc_d3.csv", method="fused"), "unpacked")
    _csv(runner3, "glmcmc_d3.csv", ch3)
    fused_res = runner3.last_result
    scan = MCMCRunner(prob3, output_dir=tmp, seed=2, num_chains=SCAN_CHAINS,
                      verbose=False)
    secs_s, ch3s = wall(lambda: scan.run_glmcmc(
        ITERS, np.zeros(3), None, 0.9, lp3, ip3, 5, output_file=None,
        method="scan"))
    # float64: a float32 sum over 5e7 values drifts by far more than 0.05
    a = np.abs(ch3[:, 256:].reshape(-1, 3)).mean(0, dtype=np.float64)
    b = np.abs(ch3s[:, 256:].reshape(-1, 3)).mean(0, dtype=np.float64)
    log(f"[entry] GLMCMC d=3 (fused, unpacked): {CHAINS:,} chains, wall "
        f"{secs:.2f} s, E|theta| after step 256 {a.round(4).tolist()}; plain "
        f"path on the card, {SCAN_CHAINS:,} chains, wall {secs_s:.2f} s: "
        f"{b.round(4).tolist()}")
    check(np.isfinite(ch3).all(), "d=3 chains are not finite")
    check(np.all(np.abs(a - b) < 0.05),
          "d=3: the fused and the plain path disagree on E|theta|")
    c = fused_res.counts
    check(np.all(c.global_attempts + c.local_attempts == ITERS - 1),
          "d=3: move counts do not sum to the steps run")
    log("[launches] per path, counts set to 0 just before it: "
        + "; ".join(f"{k} {v}" for k, v in paths.items()))
    return fused_res.final_carry, prob3, paths


def phase_kernels_line(bench, carry3, prob3, paths):
    """``launches`` is each kernel's count on its entry-point path (the
    packed layout: ``run_glmcmc`` at d=2; the unpacked one: ``run_glmcmc``
    at d=3); ``launches_by_path`` gives the count on every path driven."""
    paths = {"bench": bench["launches"], **paths}
    by_path = lambda layout: {k: v[layout] for k, v in paths.items()}
    rows = []
    # K1: the packed layout at the bench shape
    kern, state = bench["kern"], bench["last_in"]
    run = lambda: kern.run(bench["seed"], *state, step0=bench["step0"])
    got = run()
    plain_ms, want = timed(lambda: kern.plain(bench["seed"], *state,
                                              step0=bench["step0"]), 1)
    max_abs, share, _ = compare(got, want, kern.pack)
    check(share <= MAX_DIFF_SHARE, f"packed, main shape: {share:.3%} of "
          "chains differ from the plain version")
    moved = nbytes(*state, *got[:4], *got[4])
    ops = (transition_ops(2, 5, True) * kern.pack * state[0].shape[1]
           * kern.T)
    b_ms, b_by = bound_ms(moved, ops)
    log(f"[K1] packed d=2 at the main shape: max abs diff {max_abs:.3g} "
        f"(share {share:.3g}); kernel {bench['ms']:.3f} ms, plain "
        f"{plain_ms:.1f} ms; {moved / 1e9:.3f} GB and {ops:.4g} operations "
        f"-> bound {b_ms:.3f} ms ({b_by})")
    rows.append(dict(
        name="mixture_glmcmc (packed layout)", route="cuda",
        source="glabc_tpu_torch/csrc/mixture_glmcmc.cu",
        replaces="glabc_tpu/ops/pallas/packed_kernel.py:86",
        launches=paths["run_glmcmc"]["packed"], max_abs_err=max_abs,
        ms=bench["ms"], plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, launches_by_path=by_path("packed")))
    del got, want

    # K2: the unpacked layout at the d=3 entry-point shape
    kern = make_kernel("unpacked", prob3, 256)
    state = tuple(x.contiguous() for x in carry3)
    kern.run(3, *state)                              # warm-up
    ms, got = timed(lambda: kern.run(3, *state, step0=256), 5)
    plain_ms, want = timed(lambda: kern.plain(3, *state, step0=256), 1)
    max_abs, share, _ = compare(got, want, 1)
    check(share <= MAX_DIFF_SHARE, f"unpacked d=3: {share:.3%} of chains "
          "differ from the plain version")
    moved = nbytes(*state, *got[:4], *got[4])
    ops = transition_ops(3, 5, True) * state[0].shape[1] * kern.T
    b_ms, b_by = bound_ms(moved, ops)
    log(f"[K2] unpacked d=3, {state[0].shape[1]:,} chains x T=256: max abs "
        f"diff {max_abs:.3g} (share {share:.3g}); kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms; {moved / 1e9:.3f} GB and {ops:.4g} operations "
        f"-> bound {b_ms:.3f} ms ({b_by})")
    rows.append(dict(
        name="mixture_glmcmc (unpacked layout)", route="cuda",
        source="glabc_tpu_torch/csrc/mixture_glmcmc.cu",
        replaces="glabc_tpu/ops/pallas/mixture_kernel.py:143",
        launches=paths["run_glmcmc_d3"]["unpacked"], max_abs_err=max_abs,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, launches_by_path=by_path("unpacked")))
    return rows


def main():
    t0 = time.perf_counter()
    try:
        import torch
    except ImportError:
        die("torch is not installed")
    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, HERE)
    try:
        import glabc_tpu_torch  # noqa: F401
    except ImportError as e:
        die(f"glabc_tpu_torch is not importable beside chip_smoke.py: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, card = phase_device()
    phase_build()
    phase_kernel_vs_plain()

    # each path runs with the launch counts set to 0 just before it
    bench = phase_main_bench(card)
    with tempfile.TemporaryDirectory() as tmp:
        carry3, prob3, paths = phase_entry_points(tmp)

    rows = phase_kernels_line(bench, carry3, prob3, paths)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
