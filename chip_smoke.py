#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port, ``glabc_tpu_torch``, on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA GPU and ``nvcc``::

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every ``glabc_tpu_torch/csrc/*.cu`` with nvcc for sm_90a, one
   process per source, all at once (registers, spills);
3. kernels against their plain torch versions on one Philox stream: the
   Philox known-answer vectors, then T=64 steps of 65,536 chains for packed
   d=2 (GLMCMC and GlobalMCMC), unpacked d=2, d=3 and d=5 (the runtime-d
   build); then the AGLMCMC kernels at small shapes: pool-iSIR (K3) at
   d in {2, 3, 8}, B in {5, 7} with -inf pool weights, bitwise; the batched
   KDE density (K4) at d in {2, 3, 8}, P in {1000, 250}, to
   1e-4 max(1, |log q|); the mixed kernel (K5) at d in {2, 3},
   S in {1024, 100}, gf in {0.5, 0.9}, within MAX_DIFF_SHARE;
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
6. AGLMCMC through ``MCMCRunner.run_aglmcmc(method='fused')``: at gf=1 the
   canonical reference config (32,768 chains, 2,001 iterations, 10
   segments of 200 and 9 per-chain epochs; K3 and K4), held to the
   posterior, annealing and acceptance bands and to the port's plain path
   on the card; at gf=0.5 (16,384 chains, 4,001 iterations, segments of
   400, shared 1,024-point KDE; K5), held to the coin share, the posterior
   and the plain path's annealed threshold and acceptance rates.  Each run's wall time is split
   into kernel, epoch and host copy of the history;
7. each kernel against its plain version at its main-path shape, times,
   bytes, operations and bounds, and its launches on every path of phases
   4-6, counted from 0 just before each path and read just after it.

``python3 chip_smoke.py --seed-spread N`` runs only phase 1 and the
gf=0.5 paths of phase 6 over N seeds each and prints the spread of the
statistics phase 6 compares.

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
# The special-function units (exp2, log2, sin, cos, rsqrt) issue 16
# operations per SM per clock: 132 x 16 x 1.98 GHz.
SFU_PER_S = 132 * 16 * 1.98e9

DEVICE = "cuda"
BENCH_COLS = 524288    # bench.py's columns; x 4 chains each at d=2
CHAINS = 65536         # kernel-vs-plain checks and the entry-point runs
SCAN_CHAINS = 4096     # the plain path on the card, the d=3 reference
ITERS = 1025           # entry-point run length: 4 launches of T=256

AGL_CHAINS = 32768     # AGLMCMC gf=1, the reference config's chains
AGL_ITERS = 2001       # 10 segments of 200 transitions, 9 epochs
AGL_SCAN_CHAINS = 2048  # the plain path on the card at gf=1
MIXED_CHAINS = 16384   # AGLMCMC gf=0.5 through the mixed kernel
MIXED_ITERS = 4001     # 10 segments of 400 transitions, 9 epochs
MIXED_SCAN_CHAINS = 4096  # the plain path on the card at gf=0.5
SMALL_CHAINS = 16384   # AGLMCMC kernels against plain at small shapes

CHAIN_TOL = 1e-5       # a chain "differs" when any value is further apart
MAX_DIFF_SHARE = 1e-3  # accept tests at their threshold may round either way
KDE_TOL = 1e-4         # K4 against plain: |diff| <= KDE_TOL max(1, |log q|)
# gf=0.5 fused run against the plain path: mean final hat_eps within
# MIXED_EPS_TOL, global and local acceptance within MIXED_GACC_REL and
# MIXED_LACC_REL of the plain path's (relative): 2.5 standard deviations of
# the difference of one run of each.  ``--seed-spread 8`` on an H100 read
# per-run sds of hat_eps 0.0043 (fused) / 0.0047 (plain), of the global
# rate 1.75 % / 1.72 %, of the local rate 0.13 % / 0.34 %.
MIXED_EPS_TOL = 0.016
MIXED_GACC_REL = 0.06
MIXED_LACC_REL = 0.009


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


def bound_ms(bytes_moved, ops, sfu=0):
    """The least time for the work: bytes over the memory rate, 32-bit
    operations over one per lane per clock, special-function operations
    (``sfu``: exponentials, logarithms) over their own units' rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(ops / OPS_PER_S, sfu / SFU_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def pool_isir_ops(d, B):
    """32-bit operations of one K3 chain-step at the least: two Philox
    blocks (80 each), B+1 uniforms (5 each) and Gumbels (2 logs, 2
    negations), and per candidate an add, a compare and d+3 selects."""
    blocks = -(-(B + 1) // 4)
    return 80 * blocks + 9 * (B + 1) + B * (d + 5)


def kde_ops(d):
    """Per (point, component) of K4, what the function needs at the least:
    the affine term as d fused multiply-adds, the running max's compare,
    the subtraction and the sum's add: d + 3, beside one exponential on the
    special-function units."""
    return d + 3


def mixed_ops(d, B, S):
    """Per K5 chain-step, what the function needs at the least: one pass of
    the resident logsumexp over S components (d fused multiply-adds, the
    max, the subtraction, the add: d + 3 each), the Philox blocks, uniforms
    and Gumbels, the Box-Muller pairs and the local move (6d + 20), the
    iSIR selects (B (2d + 5)).  Returns ``(ops, sfu)``; ``sfu`` counts the
    S exponentials and the logs."""
    blocks = -(-(B + 3) // 4) + -(-d // 2)
    ops = (S * (d + 3) + 80 * blocks + 9 * (B + 3) + 8 * d
           + 6 * d + 20 + B * (2 * d + 5))
    return ops, S + 2 * (B + 1) + 3 + 2 * d


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


def _wrappers():
    from glabc_tpu_torch.ops.kernels import (BatchedMixtureLogProb,
                                             FusedMixtureGLMCMC,
                                             PackedMixtureGLMCMC, PoolISIR,
                                             PoolISIRMixed)

    return {"packed": PackedMixtureGLMCMC, "unpacked": FusedMixtureGLMCMC,
            "pool_isir": PoolISIR, "kde_logprob": BatchedMixtureLogProb,
            "pool_isir_mixed": PoolISIRMixed}


def counted(fn):
    """``fn()`` with every wrapper's launch count set to 0 just before it;
    returns its result and the counts read just after."""
    classes = _wrappers()
    for cls in classes.values():
        cls.launches = 0
    out = fn()
    return out, {k: cls.launches for k, cls in classes.items()}


def only(**want):
    """The launch counts of a path that runs only the given kernels."""
    counts = dict.fromkeys(_wrappers(), 0)
    counts.update(want)
    return counts


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
    _build.build_all()
    for stem in _build.SOURCES:
        _build.load_library(stem)
    seconds = time.perf_counter() - t
    log(f"[build] {len(_build.SOURCES)} sources, one nvcc each at once, "
        f"{' '.join(_build.NVCC_FLAGS)}: {seconds:.1f} s")
    for stem in _build.SOURCES:
        for line in _build.build_log(stem).splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line:
                log(f"[build] {stem}: {line.strip()}")
        counts = sass_counts(str(_build.lib_path(stem)))
        if counts is None:
            log(f"[build] {stem}: static SASS size: not measured (no "
                "cuobjdump)")
        else:
            for fn, n in counts.items():
                log(f"[build] {stem}: static SASS {fn}: {n} instructions")


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
    check(counts == only(packed=13),
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
        want = only(**{layout: calls})
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


def _random_pools(T, B, d, C, seed):
    """Pool slices in the kernels' layout, a fifth of the log-weights
    -inf, made on the card from a seed."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    f = dict(generator=g, device=DEVICE)
    ptheta = torch.randn((T, B, d, C), **f)
    logw = torch.randn((T, B, C), **f) * 3.0 - 4.0
    logw = torch.where(torch.rand((T, B, C), **f) < 0.2,
                       torch.full_like(logw, -math.inf), logw)
    return ptheta, logw.contiguous(), g


def _bitwise(got, want):
    """True when every output agrees to the bit (-inf and NaN included),
    and the largest difference between finite values."""
    import torch

    same, max_abs = True, 0.0
    for a, b in zip(got, want):
        if a is None:
            continue
        eq = (a == b) | (torch.isnan(a) & torch.isnan(b))
        same &= bool(eq.all())
        fin = torch.isfinite(a) & torch.isfinite(b)
        if fin.any():
            max_abs = max(max_abs, float((a - b)[fin].abs().max()))
    return same, max_abs


def _chain_share(got, want, C):
    """Largest finite difference and the share of chains with any value
    more than CHAIN_TOL apart; outputs have chains as their last axis."""
    import torch

    bad = torch.zeros(C, dtype=torch.bool, device=got[0].device)
    max_abs = 0.0
    for a, b in zip(got, want):
        if a is None:
            continue
        check(bool(torch.isfinite(a).all()), "a kernel wrote non-finite "
              "values")
        diff = (a - b).abs()
        max_abs = max(max_abs, float(diff.max()))
        bad |= (diff > CHAIN_TOL).reshape(-1, C).any(0)
    return max_abs, float(bad.float().mean())


def phase_agl_kernels_vs_plain():
    """K3, K4 and K5 at small shapes on one Philox stream."""
    import torch
    from glabc_tpu_torch import HighDimMixtureProblem, MixtureProblem
    from glabc_tpu_torch.models import KernelDensity
    from glabc_tpu_torch.ops.kernels import (BatchedMixtureLogProb,
                                             PoolISIR, PoolISIRMixed,
                                             kde_logprob_inputs,
                                             resident_from_kde)

    C, T = SMALL_CHAINS, 32
    for d in (2, 3, 8):
        for B in (5, 7):
            ptheta, plogw, g = _random_pools(T, B, d, C, 10 * d + B)
            theta = torch.randn((d, C), generator=g, device=DEVICE)
            logw = torch.randn((C,), generator=g, device=DEVICE) - 4.0
            kern = PoolISIR(d, batch_size=B, steps_per_call=T)
            got = kern.run(5, ptheta, plogw, theta, logw, step0=1000)
            want = kern.plain(5, ptheta, plogw, theta, logw, step0=1000)
            torch.cuda.synchronize()
            same, max_abs = _bitwise(got, want)
            log(f"[K3-vs-plain] d={d} B={B}: {C:,} chains x {T} steps, "
                f"-inf in the pool: bitwise {same}, moves per step "
                f"{float(got[3].mean()) / T:.3f}")
            check(same, f"pool_isir d={d} B={B} differs from its plain "
                  f"version (max abs {max_abs:.3g})")
    for d in (2, 3, 8):
        for P in (1000, 250):
            g = torch.Generator(device=DEVICE).manual_seed(d * P)
            Ck = 256
            X = torch.randn((Ck, P, d), generator=g, device=DEVICE)
            w = torch.rand((Ck, P), generator=g, device=DEVICE)
            w[:, ::7] = 0.0
            kdes = KernelDensity.fit(X, w)
            x = torch.randn((Ck, P, d), generator=g, device=DEVICE) * 1.5
            kern = BatchedMixtureLogProb()
            args = (x, *kde_logprob_inputs(kdes))
            got, want = kern.run(*args), kern.plain(*args)
            torch.cuda.synchronize()
            err = float(((got - want).abs() / want.abs().clamp_min(1.0))
                        .max())
            log(f"[K4-vs-plain] d={d} P=N={P}, {Ck} chains: max "
                f"|diff| / max(1, |log q|) = {err:.3g}")
            check(bool(torch.isfinite(got).all()) and err <= KDE_TOL,
                  f"kde_logprob d={d} P={P}: {err:.3g} > {KDE_TOL}")
    for d in (2, 3):
        prob = MixtureProblem(0.05) if d == 2 else HighDimMixtureProblem(d)
        for S in (1024, 100):
            for gf in (0.5, 0.9):
                B = 5
                ptheta, plogw, g = _random_pools(T, B, d, C, S + d)
                px = (ptheta.abs() + 0.2 * torch.randn(
                    ptheta.shape, generator=g, device=DEVICE)).contiguous()
                plogk = torch.randn((T, B, C), generator=g,
                                    device=DEVICE) - 1.0
                res = resident_from_kde(KernelDensity.fit(
                    torch.randn((S, d), generator=g, device=DEVICE) * 1.4))
                theta = torch.randn((d, C), generator=g, device=DEVICE)
                y = (theta.abs() + 0.2 * torch.randn(
                    (d, C), generator=g, device=DEVICE)).contiguous()
                logk = prob.log_kernel_of_y(y.T.contiguous())
                kern = PoolISIRMixed(
                    d, prob.y_obs.numpy(), epsilon=prob.epsilon,
                    sigma=prob._noise_std, global_frequency=gf,
                    batch_size=B, steps_per_call=T)
                a = (res, ptheta, px, plogw, plogk, theta, y, logk)
                got = kern.run(7, *a, step0=2000)
                want = kern.plain(7, *a, step0=2000)
                torch.cuda.synchronize()
                max_abs, share = _chain_share(got, want, C)
                same, _ = _bitwise(got, want)
                log(f"[K5-vs-plain] d={d} S={S} gf={gf}: {C:,} chains x "
                    f"{T} steps, bitwise {same}, max abs diff {max_abs:.3g}"
                    f", share of chains differing by > {CHAIN_TOL:g}: "
                    f"{share:.3g}, global share "
                    f"{float(got[3].mean()) / T:.4f}")
                check(share <= MAX_DIFF_SHARE, f"pool_isir_mixed d={d} "
                      f"S={S} gf={gf}: {share:.3%} of chains differ")


class Instrument:
    """Around one entry run: the card time of every launch of the AGLMCMC
    kernels (CUDA events), the wall time of each adaptation epoch and of
    each synchronous host copy of a segment's history (both between two
    synchronizes), and the arguments of each wrapper's last call, for the
    timing phase.  It launches nothing and counts nothing."""

    def __init__(self):
        self.events, self.last = [], {}
        self.epoch_s = self.copy_s = 0.0
        self.epoch_n = self.copy_n = 0

    def kernel_ms(self):
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)

    def _synced(self, fn, kind):
        """``fn`` timed on the host between two synchronizes, summed into
        ``<kind>_s`` and counted in ``<kind>_n``."""
        import torch

        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            setattr(self, kind + "_s", getattr(self, kind + "_s")
                    + time.perf_counter() - t)
            setattr(self, kind + "_n", getattr(self, kind + "_n") + 1)
            return out
        return run

    def __enter__(self):
        import torch
        import glabc_tpu_torch.samplers.aglmcmc as agl
        import glabc_tpu_torch.samplers.aglmcmc_fused as fused

        self._saved = []

        def patch(owner, name, new):
            self._saved.append((owner, name, owner.__dict__[name]))
            setattr(owner, name, new)

        for key, cls in _wrappers().items():
            if key in ("packed", "unpacked"):
                continue

            def run(kern, *a, _orig=cls.run, _key=key, **k):
                self.last[_key] = (kern, a, k)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = _orig(kern, *a, **k)
                e1.record()
                if _key != "kde_logprob":     # K4 runs inside the epoch
                    self.events.append((e0, e1))
                return out
            patch(cls, "run", run)
        for name in ("make_epoch_fn", "make_shared_epoch_fn"):
            orig = getattr(agl, name)
            patch(agl, name, lambda *a, _o=orig, **k: self._synced(
                _o(*a, **k), "epoch"))
        patch(fused, "_history", self._synced(fused._history, "copy"))
        return self

    def __exit__(self, *exc):
        for owner, name, old in reversed(self._saved):
            setattr(owner, name, old)
        return False

    def split(self, secs):
        k = self.kernel_ms() / 1e3
        return (f"wall {secs:.2f} s = kernel {k:.3f} s + epochs "
                f"{self.epoch_s:.2f} s ({self.epoch_n}) + history copies "
                f"{self.copy_s:.2f} s ({self.copy_n}) + other "
                f"{secs - k - self.epoch_s - self.copy_s:.2f} s")


def _absmean(ch, burn):
    import numpy as np

    return np.abs(ch[:, burn:]).mean(axis=(0, 1), dtype=np.float64)


def mixed_run(tmp, seed, method, chains, output_file=None):
    """``run_aglmcmc`` at gf=0.5 as phase 6 calls it: ``fused`` through the
    mixed kernel, ``scan`` the plain path with shared adaptation.  Returns
    the runner and the chains."""
    import numpy as np
    from glabc_tpu_torch import DiagGaussian, MCMCRunner, MixtureProblem

    runner = MCMCRunner(MixtureProblem(0.05), output_dir=tmp, seed=seed,
                        num_chains=chains, verbose=False)
    kw = dict(output_file=output_file, method=method, shared_support=1024)
    if method == "scan":
        kw.update(shared_adaptation=True, redraw_chunk=512)
    ch = runner.run_aglmcmc(
        MIXED_ITERS, np.zeros(2), None, 0.5,
        DiagGaussian.create(2, 0.0, math.log(0.35)),
        DiagGaussian.create(2, 0.0, 0.0), 5, 200, 0.8, 0.2, **kw)
    return runner, ch


def mixed_stats(res):
    """Mean final hat_eps, global and local acceptance of a gf=0.5 run."""
    import numpy as np

    c = res.counts
    return (float(np.mean(res.hat_eps, dtype=np.float64)),
            float(c.global_accepts.sum() / c.global_attempts.sum()),
            float(c.local_accepts.sum() / c.local_attempts.sum()))


def seed_spread(n):
    """``--seed-spread N``: the gf=0.5 statistics that phase 6 compares,
    over N seeds of the fused path and N of the plain path, with their
    means and standard deviations (the source of the MIXED_* limits)."""
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        for method, chains, seed0 in (("fused", MIXED_CHAINS, 100),
                                      ("scan", MIXED_SCAN_CHAINS, 200)):
            rows = []
            for seed in range(seed0, seed0 + n):
                runner, ch = mixed_run(tmp, seed, method, chains)
                rows.append(mixed_stats(runner.last_result))
                log(f"[spread] gf=0.5 {method}, {chains:,} chains, seed "
                    f"{seed}: hat_eps {rows[-1][0]:.5f}, acceptance global "
                    f"{rows[-1][1]:.5f} / local {rows[-1][2]:.5f}")
                del ch
            a = np.asarray(rows)
            mean, sd = a.mean(0), a.std(0, ddof=1)
            log(f"[spread] gf=0.5 {method}: mean hat_eps {mean[0]:.5f} sd "
                f"{sd[0]:.5f}; global {mean[1]:.5f} sd {sd[1] / mean[1]:.2%};"
                f" local {mean[2]:.5f} sd {sd[2] / mean[2]:.2%}")


def phase_aglmcmc(tmp):
    """AGLMCMC through MCMCRunner.run_aglmcmc at gf=1 and gf=0.5, fused,
    each beside the port's plain path on the card."""
    import numpy as np
    from glabc_tpu_torch import DiagGaussian, MCMCRunner, MixtureProblem

    lp = DiagGaussian.create(2, 0.0, math.log(0.35))
    ip = DiagGaussian.create(2, 0.0, 0.0)
    paths, insts = {}, {}

    def path(name, fn, want):
        with Instrument() as inst:
            (secs, out), counts = counted(lambda: wall(fn))
        paths[name], insts[name] = counts, inst
        check(counts == want, f"{name}: launches {counts}, expected {want}")
        return secs, out, inst

    # ---- gf = 1: the reference config, pool-iSIR kernel + K4 epochs
    n_seg = (AGL_ITERS - 1) // 200
    runner = MCMCRunner(MixtureProblem(0.05), output_dir=tmp, seed=0,
                        num_chains=AGL_CHAINS, verbose=False)
    secs, ch, inst = path(
        "run_aglmcmc_gf1", lambda: runner.run_aglmcmc(
            AGL_ITERS, np.zeros(2), None, 1.0, lp, ip, 5, 200, 0.8, 0.2,
            method="fused"),
        only(pool_isir=n_seg, kde_logprob=n_seg - 1))
    res = runner.last_result
    check(ch.shape == (AGL_CHAINS, AGL_ITERS, 2), f"gf=1 chains {ch.shape}")
    check(bool(np.isfinite(ch).all()), "gf=1 chains are not finite")
    _csv(runner, "aglmcmc_results.csv", ch)
    absmean = _absmean(ch, 400)
    eps = float(np.mean(res.hat_eps, dtype=np.float64))
    gacc = float(res.acceptance_rates()["global"].mean())
    eps_hist = np.asarray(res.hat_eps_hist, np.float64).mean(axis=1)
    log(f"[agl] gf=1 fused: {AGL_CHAINS:,} chains x {AGL_ITERS} iterations,"
        f" {inst.split(secs)}")
    log(f"[agl] gf=1 fused: E|theta| after step 400 "
        f"{absmean.round(4).tolist()}, mean hat_eps per epoch "
        f"{eps_hist.round(4).tolist()}, global acceptance {gacc:.5f}")
    check(np.all((absmean >= 1.40) & (absmean <= 1.45)),
          f"gf=1: E|theta| {absmean} outside [1.40, 1.45]")
    check(0.55 <= eps <= 0.66, f"gf=1: mean final hat_eps {eps} outside "
          "[0.55, 0.66]")
    check(0.012 <= gacc <= 0.025, f"gf=1: global acceptance {gacc} outside "
          "[0.012, 0.025]")
    del ch

    scan = MCMCRunner(MixtureProblem(0.05), output_dir=tmp, seed=1,
                      num_chains=AGL_SCAN_CHAINS, verbose=False)
    secs_s, ch_s, _ = path(
        "run_aglmcmc_gf1_scan", lambda: scan.run_aglmcmc(
            AGL_ITERS, np.zeros(2), None, 1.0, lp, ip, 5, 200, 0.8, 0.2,
            output_file=None, method="scan"),
        only(kde_logprob=n_seg - 1))
    a_s = _absmean(ch_s, 400)
    eps_s = float(np.mean(scan.last_result.hat_eps, dtype=np.float64))
    log(f"[agl] gf=1 plain path on the card: {AGL_SCAN_CHAINS:,} chains, "
        f"wall {secs_s:.2f} s, E|theta| {a_s.round(4).tolist()}, mean final "
        f"hat_eps {eps_s:.4f}, global acceptance "
        f"{float(scan.last_result.acceptance_rates()['global'].mean()):.5f}")
    check(abs(absmean.mean() - a_s.mean()) < 0.05 and abs(eps - eps_s) < 0.05,
          "gf=1: the fused and the plain path disagree on E|theta| or "
          "hat_eps")

    # ---- gf = 0.5: the mixed kernel, shared adaptation
    steps = MIXED_ITERS - 1
    secs_m, (mixed, ch_m), inst_m = path(
        "run_aglmcmc_gf05", lambda: mixed_run(
            tmp, 2, "fused", MIXED_CHAINS, "aglmcmc_gf05.csv"),
        only(pool_isir_mixed=steps // 400))
    _csv(mixed, "aglmcmc_gf05.csv", ch_m)
    rm = mixed.last_result
    c = rm.counts
    check(bool(np.all(c.global_attempts + c.local_attempts == steps)),
          "gf=0.5: move counts do not sum to the steps run")
    share = float(c.global_attempts.sum()) / (MIXED_CHAINS * steps)
    a_m = _absmean(ch_m, 800)
    eps_m, g_m, l_m = mixed_stats(rm)
    log(f"[agl] gf=0.5 fused: {MIXED_CHAINS:,} chains x {MIXED_ITERS} "
        f"iterations, {inst_m.split(secs_m)}")
    log(f"[agl] gf=0.5 fused: global share {share:.5f}, E|theta| after step "
        f"800 {a_m.round(4).tolist()}, acceptance global {g_m:.5f} / local "
        f"{l_m:.5f}, hat_eps per epoch "
        f"{np.asarray(rm.hat_eps_hist, np.float64).round(4).tolist()}")
    del ch_m
    check(abs(share - 0.5) <= 0.01, f"gf=0.5: global share {share}")
    check(np.all((a_m >= 1.40) & (a_m <= 1.45)),
          f"gf=0.5: E|theta| {a_m} outside [1.40, 1.45]")

    secs_ms, (scan_m, ch_ms), _ = path(
        "run_aglmcmc_gf05_scan", lambda: mixed_run(
            tmp, 3, "scan", MIXED_SCAN_CHAINS), only())
    eps_s, g_s, l_s = mixed_stats(scan_m.last_result)
    a_ms = _absmean(ch_ms, 800)
    # bands around the plain path's rates, set from their spread over seeds
    band = lambda r, rel: (r * (1.0 - rel), r * (1.0 + rel))
    eps_ms = np.asarray(scan_m.last_result.hat_eps_hist, np.float64)
    log(f"[agl] gf=0.5 plain path on the card: {MIXED_SCAN_CHAINS:,} chains,"
        f" wall {secs_ms:.2f} s, E|theta| {a_ms.round(4).tolist()}, "
        f"acceptance global {g_s:.5f} / local {l_s:.5f}, hat_eps per epoch "
        f"{eps_ms.round(4).tolist()}; bands global "
        f"{np.round(band(g_s, MIXED_GACC_REL), 5).tolist()}, local "
        f"{np.round(band(l_s, MIXED_LACC_REL), 5).tolist()}, mean final "
        f"hat_eps {eps_s:.4f} +- {MIXED_EPS_TOL} (fused {eps_m:.4f})")
    check(abs(eps_m - eps_s) <= MIXED_EPS_TOL, f"gf=0.5: mean final hat_eps "
          f"{eps_m} is more than {MIXED_EPS_TOL} from the plain path's "
          f"{eps_s}")
    for what, got, ref, rel in (("global", g_m, g_s, MIXED_GACC_REL),
                                ("local", l_m, l_s, MIXED_LACC_REL)):
        lo, hi = band(ref, rel)
        check(lo <= got <= hi, f"gf=0.5: {what} acceptance {got} outside "
              f"the plain path's band [{lo}, {hi}]")
    check(abs(a_m.mean() - a_ms.mean()) < 0.05, "gf=0.5: the fused and the "
          "plain path disagree on E|theta|")
    log("[launches] per path, counts set to 0 just before it: "
        + "; ".join(f"{k} {v}" for k, v in paths.items()))
    return paths, insts


def _agl_row(name, source, replaces, key, paths, main_path, max_abs, ms,
             plain_ms, b):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=paths[main_path][key], max_abs_err=max_abs, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                library_ms=None,
                launches_by_path={k: v[key] for k, v in paths.items()})


def agl_kernel_rows(insts, paths):
    """K3, K4 and K5 at their main-path shapes (the arguments of their last
    launch on their entry path): time per launch (median of 3 windows of
    3), the plain version's time and agreement, bytes, operations, bound.
    No single PyTorch call computes these functions: no library time."""
    import torch

    rows = []

    def median_ms(fn):
        fn()                                            # warm
        return sorted(timed(fn, 3)[0] for _ in range(3))[1]

    # K3
    kern, a, k = insts["run_aglmcmc_gf1"].last["pool_isir"]
    ms = median_ms(lambda: kern.run(*a, **k))
    got = kern.run(*a, **k)
    plain_ms, want = timed(lambda: kern.plain(*a, **k), 1)
    same, max_abs = _bitwise(got, want)
    check(same, "pool_isir at the main shape differs from its plain version")
    T, B, d, C = a[1].shape
    moved = nbytes(*a[1:5], *(x for x in got if x is not None))
    b = bound_ms(moved, pool_isir_ops(d, B) * C * T, 2 * (B + 1) * C * T)
    log(f"[K3] pool_isir at the main shape, {C:,} chains x T={T}, B={B}, "
        f"d={d}: bitwise {same}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms;"
        f" {moved / 1e9:.4f} GB, {pool_isir_ops(d, B) * C * T:.4g} "
        f"operations -> bound {b[0]:.4f} ms ({b[1]})")
    rows.append(_agl_row(
        "pool_isir", "glabc_tpu_torch/csrc/pool_isir.cu",
        "glabc_tpu/ops/pallas/pool_isir_kernel.py:103", "pool_isir", paths,
        "run_aglmcmc_gf1", max_abs, ms, plain_ms, b))
    del got, want

    # K4
    kern, a, k = insts["run_aglmcmc_gf1"].last["kde_logprob"]
    ms = median_ms(lambda: kern.run(*a, **k))
    got = kern.run(*a, **k)
    plain_ms, want = timed(lambda: kern.plain(*a, **k), 1)
    err = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
    max_abs = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= KDE_TOL,
          f"kde_logprob at the main shape: {err:.3g} > {KDE_TOL}")
    C, N, d = a[0].shape
    P = a[1].shape[1]
    work = C * N * P
    moved = nbytes(*a, got)
    b = bound_ms(moved, work * kde_ops(d), work)
    log(f"[K4] kde_logprob at the main shape, {C:,} chains x N={N} points "
        f"x P={P} components, d={d}: max |diff| {max_abs:.3g}, relative "
        f"{err:.3g}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; "
        f"{moved / 1e9:.4f} GB, {work * kde_ops(d):.4g} operations and "
        f"{work:.4g} exponentials -> bound {b[0]:.3f} ms ({b[1]})")
    rows.append(_agl_row(
        "kde_logprob", "glabc_tpu_torch/csrc/kde_logprob.cu",
        "glabc_tpu/ops/pallas/kde_logprob_kernel.py:106", "kde_logprob",
        paths, "run_aglmcmc_gf1", max_abs, ms, plain_ms, b))
    del got, want

    # K5
    kern, a, k = insts["run_aglmcmc_gf05"].last["pool_isir_mixed"]
    ms = median_ms(lambda: kern.run(*a, **k))
    got = kern.run(*a, **k)
    plain_ms, want = timed(lambda: kern.plain(*a, **k), 1)
    T, B, d, C = a[2].shape
    S = a[1].pre.shape[0]
    max_abs, share = _chain_share(got, want, C)
    check(share <= MAX_DIFF_SHARE, f"pool_isir_mixed at the main shape: "
          f"{share:.3%} of chains differ")
    ops, sfu = mixed_ops(d, B, S)
    moved = nbytes(*a[1], *a[2:9], *(x for x in got if x is not None))
    b = bound_ms(moved, ops * C * T, sfu * C * T)
    log(f"[K5] pool_isir_mixed at the main shape, {C:,} chains x T={T}, "
        f"B={B}, S={S}, d={d}: max abs diff {max_abs:.3g}, share of chains "
        f"differing {share:.3g}; kernel {ms:.3f} ms, plain {plain_ms:.1f} "
        f"ms; {moved / 1e9:.4f} GB, {ops * C * T:.4g} operations and "
        f"{sfu * C * T:.4g} special-function operations -> bound "
        f"{b[0]:.3f} ms ({b[1]})")
    rows.append(_agl_row(
        "pool_isir_mixed", "glabc_tpu_torch/csrc/pool_isir_mixed.cu",
        "glabc_tpu/ops/pallas/pool_isir_mixed_kernel.py:190",
        "pool_isir_mixed", paths, "run_aglmcmc_gf05", max_abs, ms, plain_ms,
        b))
    return rows


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
    if sys.argv[1:2] == ["--seed-spread"]:
        phase_device()
        seed_spread(int(sys.argv[2]))
        return

    name, card = phase_device()
    phase_build()
    phase_kernel_vs_plain()
    phase_agl_kernels_vs_plain()

    # each path runs with the launch counts set to 0 just before it
    bench = phase_main_bench(card)
    with tempfile.TemporaryDirectory() as tmp:
        carry3, prob3, paths = phase_entry_points(tmp)
        agl_paths, insts = phase_aglmcmc(tmp)
    paths = {"bench": bench["launches"], **paths, **agl_paths}

    rows = phase_kernels_line(bench, carry3, prob3, paths)
    rows += agl_kernel_rows(insts, paths)
    del insts
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
