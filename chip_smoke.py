#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port, ``glabc_tpu_torch``, on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA GPU and ``nvcc``::

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: every ``glabc_tpu_torch/csrc/*.cu`` with nvcc for sm_90a, and
   the generic kernels for each shipped program header, one process per
   library, all at once (registers, spills);
3. kernels against their plain torch versions on one Philox stream: the
   Philox known-answer vectors, then T=64 steps of 65,536 chains for packed
   d=2 (GLMCMC and GlobalMCMC), unpacked d=2, d=3 and d=5 (the runtime-d
   build); then the AGLMCMC kernels at small shapes: pool-iSIR (K3) at
   d in {2, 3, 8}, B in {5, 7} with -inf pool weights, and at a ragged
   chain count with blocks of 32 and 1,024 threads, bitwise; the batched
   KDE density (K4) at d in {2, 3, 8}, P in {1000, 250}, to
   1e-4 max(1, |log q|); the mixed kernel (K5) at d in {2, 3},
   S in {1024, 100}, gf in {0.5, 0.9}, bitwise;
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
   400, shared 1,024-point KDE; K5, and K10 and K4 for each redraw
   chunk's pool rows and density), held to the coin share, the posterior
   and the plain path's annealed threshold and acceptance rates.  Each run's wall time is split
   into kernel, epoch and host copy of the history;
7. GLMALA through ``MCMCRunner.run_glmala``: ``method='fused'`` (K6) with
   the shared coin at 32,768 chains x 2,049 iterations and with per-chain
   coins at 32,768 x 513, beside the plain path at 1,024 x 2,049, held to
   the posterior and move-fraction bands and to the plain path's global
   acceptance; the local acceptance of each, side by side (phase 3 also
   checks K6 at d in {2, 8}, both coin modes, its outputs bitwise across
   W in {32, 16, 8, 4} chains a warp and blocks of 64 and 256 threads, and
   its first history step, K7 push and pull at d in
   {2, 3, 8}, ragged row counts and 1,048,576 rows, with the TF32 HMMA
   instructions of its split products in its SASS, K7-bf16 (the bf16
   tensor-core flow) likewise and at hidden widths 16 and 32, with the
   wgmma (HGMMA) instructions in its SASS, and the generic kernels K8 and
   K9 on the Mixture and MA(2) programs and K5's program variant on
   MA(2), against their plain versions);
8. GLMCMC-NF through ``MCMCRunner.run_glmcmc_nf``: ``method='fused'`` at
   gf=1 (32,768 chains x 801: K7 pushes the pools, K3 runs the segments,
   one K7 pull per epoch) and at gf=0.5 (8,192 x 4,001, slice cadence: one
   K7 pull per step), each beside ``method='pooled'`` at 2,048 chains, and
   ``method='scan'`` at 256 x 401; wall time split into kernels, training,
   history copies and the rest; then the flow API with
   ``matmul_dtype='bfloat16'`` (K7-bf16) on the trained NF flows: push of
   the gf=1 run's last pool draw (32,768,000 rows) and its round trip, pull
   of the gf=0.5 run's state (8,192 rows) and of 1,048,576 rows, each
   against the plain bf16 version and the float32 kernel;
9. the generic program path on MA(2) at the JAX package's full width
   (num_draws=100): ``run_fused_program`` (K8) at 65,536 chains x 1,025
   beside the plain ``run_glmcmc`` at 4,096, and the Mixture program held
   to the Mixture bands; ``MCMCRunner.run_glmala(tile_program=...)`` (K9)
   with the shared coin at 65,536 x 257 and per-chain coins at 16,384 x
   257 beside the plain path at 1,024; ``run_aglmcmc`` at gf=0.5 with
   ``tile_program=`` (K5's program variant) at 8,192 x 2,001 beside the
   plain shared-adaptation path at 2,048; each run's wall time split into
   kernel, initial gradient or epochs, history copies and the rest;
10. each kernel against its plain version at its main-path shape, times,
   bytes, operations and bounds (K1, K2, K6 and K9 counting the move each
   chain-step's coin picked, K9 a +-fd pair as one set of draws, K3 the
   winner's theta only on a chain-step that moves, the older counts
   printed beside them; K6 and K9 with the shared coin at the launch whose
   coins gave the local-step count nearest (1 - gf) T, and with per-chain
   coins), its launches on every path of
   phases 4-9, counted from 0 just before each path and read just after
   it, and for K1, K8 and K9 (per-chain coin) the same launch with every
   coin global and every coin local beside it (warp divergence); K5's
   bounds count the resident density only on the chain-steps that need
   it (each chain's first, and those after a move), with the share of
   such chain-steps and lanes per warp-step; K4 also at the shape of the
   gf=0.5 run's shared-epoch density (32,768,000 points, 1,024
   components) in one launch, beside ``KernelDensity.log_prob`` in the
   epoch's chunks of 512 chains (what the epoch computed before K4).
   K11, the radix select, at the mesh cell's shard of 32,768,000 values
   (run after phase 3): every pass's histograms and picks bitwise their
   plain versions, the values ``torch.sort``'s order statistics, 3 + 3
   launches a select, each kernel's device time beside the bytes bound.
   Phase 2 prints K1's and K4's static SASS split by instruction class,
   and K8's and K7-bf16's registers as ptxas reports them;
11. sharded (``mesh=``, run after phase 9 and before phase 10): every
   kernel that draws randomness (K1 packed, K2, K3, K5 with both local
   moves, K6 and K9 with both coins, K8) launched over 4,096 and 3,000
   chains x 32 steps and over the two halves of the range, each half
   with its first global chain as ``chain0`` and packed on its own, must
   join to the whole launch's bits; then ``run_glmcmc_fused`` at 65,536
   chains x 1,025 with ``mesh=make_mesh()`` over a one-rank NCCL group
   must equal the ``mesh=None`` run bit for bit (its launches counted as
   a path, its wall printed beside the unsharded one); on the same group
   ``distributed_quantile`` (K11) and ``distributed_systematic_resample``
   at the mesh cell's shard (32,768,000 values) must equal ``quantile``
   and ``systematic_resample`` bit for bit, with their launch counts, and
   the anneal's and the resample's host time is printed beside their
   stream and kernel time (:func:`mesh_select`); and two ranks on the one
   card (gloo over CUDA tensors, two processes) must each return the
   one-rank run of 16,384 chains x 129;
12. m13 (run after phase 9 and before phase 11): the native chain writer
   (built with g++) under ``MCMCRunner(use_native_io=True,
   write_chains='all').run_glmcmc(method='fused')`` at 65,536 chains x
   1,025, its binary file read back by ``read_binary_chains`` bitwise
   equal to the history; K1 at the same shape saved by
   ``CheckpointManager`` after 2 of 4 launches, restored and run on,
   bitwise the straight run; one ``trace`` of K1 launches inside an
   ``annotate`` range, in a spawned process of its own, whose Chrome trace
   must name the kernel and the range; and the examples ``glabc_tpu_torch/examples/mixture.py`` and
   ``ma2.py`` at their JAX defaults (the plain path: no launch), then
   through their kernels (``mixture.py --method fused`` at 2,048 x 1,025:
   K1 4 launches and the posterior band; ``ma2.py --method fused``: K8 8
   launches; ``ma2.py --method aglmcmc``: K5's program variant, and K4
   for the shared epoch's density).

13. shapes (run after phase 12 and before phase 11): the kernels past
   the static shapes against their plain versions: K7 and K7-bf16, push
   and pull, at (dim, hidden, layers) in {(2, 100, 4), (2, 8, 4), (20,
   128, 4), (33, 256, 4), (64, 512, 2)} and 8,192 and 8,209 rows
   (FLOW_SPLIT_TOL with its one-product control; bf16 against the plain
   bf16 flow's own order sensitivity, ``bf16_order_control``) and on
   integer layers (exact), K3 and K5 at d in {33, 64, 128} bit for bit,
   K4 there within KDE_TOL, each counted on its own variant; then
   GLMCMC-NF gf=1 fused on a 20-D problem with a 32 x 256 flow (8,192 x
   201), AGLMCMC gf=1 and gf=0.5 (shared, S = 1,024) at d=40 (4,096 x
   1,001) and the bf16 flow API on the NF flow, each a counted path; and
   K7 push, K3, K4 and K5 at today's shapes, their outputs' sha256 and
   times (``--parent DIR``, a checkout of the parent commit's
   ``glabc_tpu_torch``: beside the parent's, parent, this, this, parent,
   the hashes equal).

``python3 chip_smoke.py --shapes [--parent DIR]`` runs only phases 1, 2
and 13.  ``python3 chip_smoke.py --mesh-select`` runs only phases 1 and 2,
K11's row and :func:`mesh_select` on a one-rank NCCL group.  ``python3 chip_smoke.py --seed-spread N [agl] [glmala] [nf] [ma2]
[glmala_prog] [agl_prog]`` runs only phase 1 and the compared paths of
phases 6-9 over N seeds each and prints the spread of the statistics those
phases compare.

The last two lines are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before them;
without a CUDA device, or without ``glabc_tpu_torch`` beside this file, the
script fails at once.
"""

import contextlib
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

# GLMALA (canonical config: gf=0.8, N(0, I) importance proposal, B=5,
# tau=0.3, num_grad=100, fd 0.1) and GLMCMC-NF (B=5, step 200, train 50,
# N(0, I) base, 32 coupling layers x 128 hidden): the chain counts the JAX
# package ran on one chip.
MALA_CHAINS = 32768    # fused, shared coin: 64 launches of T=32
MALA_ITERS = 2049
MALA_PC_ITERS = 513    # fused, per-chain coin: 16 launches
MALA_SCAN_CHAINS = 1024  # the plain path on the card
NF1_CHAINS = 32768     # gf=1 fused: 4 segments of 200, 3 epochs
NF1_ITERS = 801
NF_POOLED_CHAINS = 2048  # the pooled (cursor-cadence) path beside each
NF05_CHAINS = 8192     # gf=0.5 fused (slice cadence): 10 segments of 400
NF05_ITERS = 4001
NF_SCAN_CHAINS = 256   # the per-step path, finiteness and launches only
NF_SCAN_ITERS = 401
FLOW_TOL = 1e-4        # K7 against plain: |diff| <= FLOW_TOL max(1, |x|)
# K7's second limit, against the same plain flow: 3xTF32 split products
# keep float32 accuracy, one TF32 product does not, yet both pass FLOW_TOL.
# On an H100 the kernel read 3.9e-7 to 9.1e-7 on the 32 x 128 test flows
# and 1.11e-6 on the trained NF flow's 32.8M-row push; the hi parts alone
# (``tf32_products(split=False)``, the same inputs) read 3.1e-5 to 6.0e-5
# and 8.55e-6 there.  The limit sits near the middle of the closest pair.
# Each check also runs the hi-only emulation and fails unless it exceeds
# the limit.
FLOW_SPLIT_TOL = 3e-6
# K7-bf16 against its plain version (the same bf16-rounded operands, float32
# matmuls): a row differs when any of its outputs is more than BF16_ROW_TOL
# max(1, |plain|) apart; at most BF16_SHARE of the rows may, and none by more
# than BF16_MAX_TOL (a guard against a fault confined to a few rows).  The
# tensor cores sum in another order, so a last-bit difference of an
# accumulator now and then flips a bf16 rounding of h0 or h1 by one bf16
# ulp, and the row moves with it.  On an H100 the largest row difference read
# 6e-8 to 6.9e-5 at 300 to 4,099 rows and at most 1.04e-4 at 2^20 rows (one
# row above 1e-4 in 2^20), 4.8e-5 on the trained NF flow's 32.8M rows.  At
# the same inputs the float32 flow differs from the plain bf16 version by
# more than 1e-4 on 15 % to 79 % of the rows of a random flow and on 0.66 %
# of the trained flow's: the check must see it differ on at least
# 10 BF16_SHARE of them, so that bf16 is told from float32 everywhere.
BF16_ROW_TOL = 1e-4
BF16_SHARE = 1e-4
BF16_MAX_TOL = 1e-3
# At phase 13's wide shapes the plain bf16 flow itself moves past those
# limits when only its float32 order changes (on an NVIDIA H100 80GB HBM3
# at 700 W, with h0 w1 summed in slices of 32: 0.40-0.49 % of rows by
# more than 1e-4 and up to 5.4e-3 at dim 64 x 512 units, 0.05-0.13 % and
# up to 1.3e-3 at 33 x 256), so no kernel that sums in another order can
# meet them there.  There the bf16 kernel
# is held to that order sensitivity instead, measured on the same inputs by
# bf16_order_control: the share of rows beyond BF16_ROW_TOL, pooled over
# the phase, at most BF16_ORDER_SHARE times the control's (or BF16_SHARE),
# and each shape's largest difference at most BF16_ORDER_MAX times the
# control's (or BF16_MAX_TOL).
BF16_ORDER_SHARE = 2.0
BF16_ORDER_MAX = 4.0
# dense bf16 and TF32 tensor-core peaks of one H100 SXM at 700 W (NVIDIA
# data sheet)
TC_BF16_PER_S = 989e12
TC_TF32_PER_S = 495e12

# The generic program path on MA(2) at the JAX package's full width
# (num_draws=100, epsilon 0.2, JAX's y_obs): GLMCMC gf=0.8, B=5, random walk
# 0.1; GLMALA gf=0.8, B=5, tau 0.1, num_grad 100, fd 0.1; AGLMCMC gf=0.5,
# B=5, step 200, shared 1,024-point KDE (examples/ma2.py).
PROG_CHAINS = 65536    # K8 run_fused_program: 4 launches of T=256
PROG_ITERS = 1025
PROG_SCAN_CHAINS = 4096  # the plain run_glmcmc beside it
MALA_PROG_CHAINS = 65536  # K9 shared coin, 16 launches of T=16: the chain
MALA_PROG_ITERS = 257     # count of the JAX package's generic GLMALA bench
MALA_PROG_PC_CHAINS = 16384  # K9 per-chain coin, 16 launches: the plain
MALA_PROG_PC_ITERS = 257     # path's length, as the rates depend on it
MALA_PROG_SCAN_CHAINS = 1024  # the plain run_glmala beside them
AGL_PROG_CHAINS = 8192  # K5 program variant: 5 segments of 400
AGL_PROG_ITERS = 2001
AGL_PROG_SCAN_CHAINS = 2048  # the plain shared-adaptation path beside it

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
# GLMALA and GLMCMC-NF fused runs against the plain or pooled path beside
# them: absolute limits on the difference of the acceptance rates.
# ``--seed-spread 5 glmala nf`` on an H100 read per-run sds of the GLMALA
# global rate 0.00007 (fused) / 0.00003 (plain); of the NF gf=1 global
# rate 0.00002 (fused) / 0.00011 (pooled); at gf=0.5 of the global rate
# 0.00005 / 0.00001 and of the local rate 0.00004 / 0.00010.  GLMALA: 2.5
# sd of the difference of one run of each; NF: 3 sd.
MALA_GACC_TOL = 0.0002
NF1_GACC_TOL = 0.00034
NF05_GACC_TOL = 0.00015
NF05_LACC_TOL = 0.00032
# The MA(2) program runs against the plain path beside each: absolute limits
# on the difference of posterior means and sds (GLMCMC), of acceptance rates
# and means (GLMALA), of the final hat_eps and acceptance rates (AGLMCMC):
# 4 sd of the difference of one run of each, the larger dim's (five seeds
# estimate an sd loosely).  ``--seed-spread 5 ma2 glmala_prog agl_prog`` on
# an H100 read per-run sds (fused / plain) of the GLMCMC means 0.00011 /
# 0.00079 and 0.00011 / 0.00039, of its sds 0.00007 / 0.00038 and 0.00009 /
# 0.00031; of the GLMALA global rate 0.00105 (shared coin) / 0.00026
# (per-chain coin, 129 iterations) / 0.00071, of the per-chain local rate
# 0.00061 / 0.00304, of the shared-coin means 0.00022 / 0.00302 and
# 0.00019 / 0.00122; of the AGLMCMC hat_eps 0.00371 / 0.00461, global rate
# 0.00264 / 0.00522 and local rate 0.00008 / 0.00066.
MA2_MEAN_TOL = 0.0032
MA2_SD_TOL = 0.0016
MALA_PROG_GACC_TOL = 0.0051
MALA_PROG_LACC_TOL = 0.0125
MALA_PROG_MEAN_TOL = 0.0121
AGL_PROG_EPS_TOL = 0.0237
AGL_PROG_GACC_TOL = 0.0234
AGL_PROG_LACC_TOL = 0.0027


def log(msg):
    print(msg, flush=True)


def die(msg):
    log(f"[FAIL] {msg}")
    sys.exit(1)


def check(cond, msg):
    if not cond:
        die(msg)


# ------------------------------------------------------------ accounting
def transition_ops_both(d, B, glmcmc):
    """32-bit operations of one transition of one chain when both moves are
    computed and the coin selects (the count before the kernel read its coin
    first; printed beside :func:`transition_ops` for comparison): every
    add, multiply, compare, select and integer operation counts one, and so
    does each log, sqrt, sin and cos (their accurate versions take
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


def transition_ops(d, B, glmcmc, move):
    """32-bit operations one transition of one chain needs at the least
    when its coin picks ``move`` ('global' or 'local'), counted as in
    :func:`transition_ops_both`: the scalar blocks that hold the slots the
    move reads (coin first), the candidates' blocks, uniforms, Box-Muller
    pairs, theta and y, the Gaussian log-densities (the current state's
    prior is known from the step that made it; iSIR needs the current
    state's proposal density), the epsilon-kernels, the acceptance (iSIR's
    Gumbels, scores and argmax; an MH ratio, log u and compare), and per
    step the coin, the four counters and the state's selects."""
    P = -(-d // 2)
    if move == "local":                     # random-walk MH
        slots = [B + 2, B + 1] if glmcmc else [1, 0]
        cands, gauss, accept = 1, 1, 5
    elif glmcmc:                            # iSIR
        slots = [B + 2, *range(B + 1)]
        cands, gauss = B, 2 * B + 1
        accept = 4 * (B + 1) + 3 + B * (7 + 2 * d)
    else:                                   # independence MH
        slots = [1, 2]
        cands, gauss, accept = 1, 3, 7
    blocks = len({s // 4 for s in slots}) + cands * P
    ops = 80 * blocks + 5 * (len(slots) + 2 * d * cands)
    ops += (8 + 5) * d * cands + 6 * d * gauss + (3 * d + 2) * cands
    return ops + accept + 6 + 2 * d


def transition_ops_mix(d, B, glmcmc, transitions, global_attempts):
    """:func:`transition_ops` over ``transitions`` of which
    ``global_attempts`` took the global move (a launch's own coins)."""
    n_g = float(global_attempts)
    return (n_g * transition_ops(d, B, glmcmc, "global")
            + (transitions - n_g) * transition_ops(d, B, glmcmc, "local"))


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


def redraw_bytes(u, z, noise, inputs):
    """The bytes K10 needs for a launch on these inputs: per chain, u and z
    of each candidate up to its P-th valid one (all M when fewer are
    valid, and then those up to the invalid one that fills the last row),
    its noise, and its P rows written (theta, x, dis, prior + log K); the
    CDF, support, bandwidth and y_obs once."""
    import torch

    (C, M), (P, d) = u.shape, noise.shape[1:]
    cdf, X, bw = inputs.cdf, inputs.X, inputs.bw
    k = torch.searchsorted(cdf, u * cdf[-1:], right=True).clamp_(
        max=cdf.shape[0] - 1)
    cand = X[k] + z * bw
    ok = (inputs.prior0 - 0.5 * torch.sum(cand * cand, dim=-1)
          > inputs.cutoff)

    def upto(flags, count):
        """Candidates read until ``count`` flags are seen (all if fewer)."""
        seen = torch.cumsum(flags.to(torch.int64), dim=1)
        first = torch.argmax((seen >= count[:, None]).to(torch.int32), dim=1)
        return torch.where(seen[:, -1] >= count, first + 1,
                           torch.full_like(first, M))

    n_ok = ok.sum(dim=1)
    full = torch.full_like(n_ok, P)
    read = upto(ok, full) + torch.where(n_ok < P, upto(~ok, P - n_ok),
                                        torch.zeros_like(n_ok))
    per_cand = 4 * (1 + d)
    return (int(read.sum()) * per_cand + nbytes(noise)
            + C * P * (2 * d + 2) * 4 + nbytes(cdf, X, bw, inputs.y_obs))


def pool_isir_ops(d, B):
    """32-bit operations of one K3 chain-step at the least, ``(per
    chain-step, per move)``: two Philox blocks (80 each), B+1 uniforms (5
    each) and Gumbels (2 logs, 2 negations), per candidate the score's add,
    the compare and the selects of the maximum, its index and its
    log-weight (5), the move test with its selects of the log-weight, the
    slot and the count (5); and on a chain-step that moves, the d floats of
    the winner's theta."""
    blocks = -(-(B + 1) // 4)
    return 80 * blocks + 9 * (B + 1) + 5 * B + 5, d


def pool_isir_ops_every_candidate(d, B):
    """The older count, printed beside the recount: per candidate an add,
    a compare and d+3 selects (the theta of every candidate)."""
    blocks = -(-(B + 1) // 4)
    return 80 * blocks + 9 * (B + 1) + B * (d + 5)


def pool_isir_bound(a, outs):
    """K3's bound for the launch ``PoolISIR.run(*a)`` with outputs ``outs``
    ``(theta, logw, sel, moved, history or None)``: ``(bound, the bound
    by the older count, bytes, operations, the older count's bytes and
    operations)``.  The bytes the function needs: the B log-weights of every
    chain-step, the winner's d floats on a chain-step that moves (the
    ``moved`` counts), the history and the state in and out; the older
    count read every candidate's theta."""
    import torch

    T, B, d, C = a[1].shape
    n_moves = float(outs[3].sum(dtype=torch.float64))
    outs = [x for x in outs if x is not None]
    bytes_now = nbytes(a[2], *a[3:5], *outs) + 4.0 * d * n_moves
    bytes_before = nbytes(*a[1:5], *outs)
    per_step, per_move = pool_isir_ops(d, B)
    ops = per_step * C * T + per_move * n_moves
    ops_before = pool_isir_ops_every_candidate(d, B) * C * T
    sfu = 2 * (B + 1) * C * T
    return (bound_ms(bytes_now, ops, sfu), bound_ms(bytes_before, ops_before,
                                                    sfu),
            bytes_now, ops, bytes_before, ops_before)


def kde_ops(d):
    """Per (point, component) of K4, what the function needs at the least:
    the affine term as d fused multiply-adds, the running max's compare,
    the subtraction and the sum's add: d + 3, beside one exponential on the
    special-function units."""
    return d + 3


def mixed_isir_ops(d, B, S):
    """Per K5 chain-step, what the function needs at the least besides the
    local move's own work: one pass of the resident logsumexp over S
    components (d fused multiply-adds, the max, the subtraction, the add:
    d + 3 each), the scalar Philox blocks, the B + 3 uniforms and the B + 1
    Gumbels (9 each), the iSIR selects (B (2d + 5)), the MH test, the coin,
    the final selects and the counters (20).  Returns ``(ops, sfu)``;
    ``sfu`` counts the S exponentials, the Gumbels' logs, the log of the
    sum and log u of the MH test."""
    ops = (S * (d + 3) + 80 * -(-(B + 3) // 4) + 9 * (B + 3)
           + B * (2 * d + 5) + 20)
    return ops, S + 2 * (B + 1) + 2


def resident_ops(d, S):
    """The resident logsumexp of one K5 chain-step at the least, the part of
    :func:`mixed_isir_ops` that only a chain-step after a move (or a chain's
    first) needs, ``(ops, sfu)``: S (d + 3) operations, and the S
    exponentials and the log of the sum."""
    return S * (d + 3), S + 1


def resident_recomputes(theta_in, hist):
    """The chain-steps of a K5 launch that need the resident density: each
    chain's first step and every step whose starting state differs from
    the step before's, from the launch's input state ``(d, C)`` and its
    history ``(T, d, C)``.  Returns ``(count, share of chain-steps, mean
    such lanes per warp-step, share of warp-steps with any)``; a warp is 32
    consecutive chains."""
    import torch

    T, _, C = hist.shape
    start = torch.cat([theta_in[None], hist[:-1]])          # (T, d, C)
    need = torch.ones((T, C), dtype=torch.bool, device=hist.device)
    need[1:] = (start[1:] != start[:-1]).any(dim=1)
    n = int(need.sum())
    lanes = torch.nn.functional.pad(need, (0, -C % 32)).reshape(
        T, -1, 32).sum(-1)
    return (n, n / (T * C), float(lanes.float().mean()),
            float((lanes > 0).float().mean()))


def k5_bound(tag, a, got, ops, sfu, moved):
    """A K5 launch's bound for the work its moves need: ``ops``/``sfu`` per
    chain-step with the resident logsumexp in every step (the count before
    the kernel carried it, printed in brackets), less that logsumexp on the
    chain-steps that start where the step before started.  ``a``: the
    launch's ``run`` arguments, ``got`` its outputs (history included)."""
    T, B, d, C = a[2].shape
    S = a[1].pre.shape[0]
    check(got[6] is not None, f"{tag}: the launch kept no history")
    n, share, lanes, any_share = resident_recomputes(a[6], got[6])
    ro, rs = resident_ops(d, S)
    skip = C * T - n
    b = bound_ms(moved, ops * C * T - ro * skip, sfu * C * T - rs * skip)
    b_old = bound_ms(moved, ops * C * T, sfu * C * T)
    log(f"[{tag}] resident density: {n:,} of {C * T:,} chain-steps compute "
        f"it (share {share:.5f}), {lanes:.3f} lanes per warp-step, "
        f"{any_share:.4f} of warp-steps with any; bound {b[0]:.4f} ms "
        f"({b[1]}; the density at every chain-step: {b_old[0]:.4f} ms)")
    return b


def builtin_local_ops(d):
    """The built-in Mixture move's own work per K5 chain-step at the least,
    ``(ops, sfu)``: ceil(d/2) Philox blocks, d Box-Muller pairs (8 each:
    two uniforms and their multiplies), theta', y', the epsilon-kernel and
    the prior (6d); ``sfu`` counts each pair's log, sqrt, sin and cos."""
    return 80 * -(-d // 2) + 8 * d + 6 * d, 4 * d


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


def sass_text(lib_path):
    """``cuobjdump -sass`` of a library (None when the tool is missing)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    return subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120).stdout


def sass_counts(lib_path, op=None, contains=None, text=None):
    """Static SASS instruction count of each kernel in the library, by
    ``cuobjdump -sass`` (or of its output ``text``), of every instruction
    or of those whose opcode (with its modifiers, ``HMMA.1688.F32.TF32``)
    starts with ``op`` and holds ``contains`` (None when the tool is
    missing)."""
    out = sass_text(lib_path) if text is None else text
    if out is None:
        return None
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                      line)
        if fn and m and (op is None or m.group(1).startswith(op)) and (
                contains is None or contains in m.group(1)):
            counts[fn] += 1
    return counts


SASS_CLASSES = (("MUFU", ("MUFU",)), ("IMAD.WIDE/HI", ("IMAD.WIDE",
                                                         "IMAD.HI")),
                ("LOP3", ("LOP3",)), ("FFMA", ("FFMA",)),
                ("FADD/FMUL", ("FADD", "FMUL")))


def k1_sass_line(tag, text, B=5):
    """K1's d=2 GLMCMC kernel in ``text`` (the library's ``cuobjdump
    -sass``, or None), by :func:`sass_loop_split`: the instructions of one
    candidate round and of the rest of a step, by class, and a global
    step's B rounds plus the rest (static counts on the step's path: every
    branch of a round counted, the cold range reductions not)."""
    text = text or ""
    names = re.findall(r"Function : (\S*mixture_glmcmc_kernelILi2E\S*)", text)
    names = [n for n in names if "Lb0E" not in n]   # not GlobalMCMC's
    split = sass_loop_split(text, names[0]) if names else None
    if split is None:
        log(f"[{tag}] K1 d=2 SASS split: not measured (no cuobjdump)")
        return
    r, rest = split["rounds"], split["step_rest"]
    total = {k: B * r[k] + rest[k] for k in r}
    n = sum(total.values())
    fmt = lambda c: ", ".join(f"{k} {v}" for k, v in c.items())
    log(f"[{tag}] K1 d=2 SASS on a step's path: a candidate round "
        f"{sum(r.values())} ({fmt(r)}); the rest of the step "
        f"{sum(rest.values())} ({fmt(rest)}); a global step, {B} rounds "
        f"and the rest: {n} ({', '.join(f'{k} {v / n:.1%}' for k, v in total.items())})")


def sass_instructions(sass_text, fn_contains):
    """``(address, opcode, predicated, branch target or None)`` of every
    instruction of the kernel whose name holds ``fn_contains``."""
    ins, fn = [], None
    for line in sass_text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                      r"([^;]*);", line)
        if fn and fn_contains in fn and m:
            tgt = re.search(r"0x([0-9a-f]+)", m.group(4))
            ins.append((int(m.group(1), 16), m.group(3), bool(m.group(2)),
                        int(tgt.group(1), 16) if tgt and m.group(3) == "BRA"
                        else None))
    return ins


# K4's chunk loop: R points a thread x K components a chunk, R (K + 1)
# exponentials (csrc/kde_logprob.cu, kKdeR and kKdeK)
K4_R, K4_K = 2, 16
K4_CLASSES = (("MUFU", ("MUFU",)), ("FFMA", ("FFMA",)),
              ("FADD/FMUL/FMNMX", ("FADD", "FMUL", "FMNMX")),
              ("LDS", ("LDS",)))


def k4_inner_loop(sass_text, fn_contains="kde_logprob_kernelILi2E"):
    """K4's inner loop (the innermost backward branch whose body holds a
    MUFU) in ``cuobjdump -sass`` text, by :data:`K4_CLASSES` (the rest as
    'other'), or None."""
    ins = sass_instructions(sass_text, fn_contains)
    loops = sorted(((t, a) for a, op, _, t in ins if t is not None and t <= a),
                   key=lambda r: r[1] - r[0])
    for lo, hi in loops:
        body = [op for a, op, _, _ in ins if lo <= a <= hi]
        if any(op.startswith("MUFU") for op in body):
            out = dict.fromkeys([c for c, _ in K4_CLASSES] + ["other"], 0)
            for op in body:
                out[next((c for c, pre in K4_CLASSES
                          if op.startswith(pre)), "other")] += 1
            return out
    return None


def k4_sass_line(tag, text):
    """K4's d=2 inner loop per term: its issued instructions by class over
    the K4_R x K4_K terms one iteration computes (static counts)."""
    split = k4_inner_loop(text or "")
    if split is None:
        log(f"[{tag}] K4 d=2 inner loop SASS: not measured (no cuobjdump "
            "or no loop found)")
        return None
    terms = K4_R * K4_K
    n = sum(split.values())
    log(f"[{tag}] K4 d=2 inner loop SASS: {n} instructions for {terms} "
        f"terms ({K4_R} points x {K4_K} components), per term "
        f"{n / terms:.3f}: "
        + ", ".join(f"{k} {v / terms:.3f}" for k, v in split.items())
        + f"; besides the MUFU {(n - split['MUFU']) / terms:.3f}")
    return split


def sass_loop_split(sass_text, fn_contains):
    """Static SASS of the kernel whose name holds ``fn_contains``, on the
    path a step takes: the step loop (the largest loop) and the largest
    loop inside it (the candidate rounds), each by instruction class
    (:data:`SASS_CLASSES`, the rest as 'other'), without the cold regions
    (ranges of under 200 instructions that a forward branch skips and
    that load a constant table: the Payne-Hanek range reduction of
    sinf/cosf for |x| >= 105615, never taken for 2 pi u).  Returns ``{'rounds': {...}, 'step_rest': {...}}``
    (the step loop less the rounds loop), or None."""
    ins = sass_instructions(sass_text, fn_contains)
    loops = sorted(((t, a) for a, op, _, t in ins if t is not None and t <= a),
                   key=lambda r: r[0] - r[1])
    if not loops:
        return None
    step = loops[0]
    inner = [lp for lp in loops[1:] if step[0] <= lp[0] and lp[1] <= step[1]]
    rounds = inner[0] if inner else (step[0], step[0] - 16)
    cold = [(a + 16, t) for a, op, pred, t in ins
            if t is not None and a < t < a + 16 * 200 and pred
            and any(a < b < t and o.startswith("LDG")
                    for b, o, _, _ in ins)]

    def split(lo, hi, skip=None):
        out = dict.fromkeys([c for c, _ in SASS_CLASSES] + ["other"], 0)
        for a, op, _, _ in ins:
            if not lo <= a <= hi or any(c0 <= a < c1 for c0, c1 in cold):
                continue
            if skip and skip[0] <= a <= skip[1]:
                continue
            cls = next((c for c, pre in SASS_CLASSES
                        if op.startswith(pre)), "other")
            out[cls] += 1
        return out
    return {"rounds": split(*rounds),
            "step_rest": split(*step, skip=rounds)}


def _wrappers():
    """Each launch count: its key -> (wrapper class, counter attribute).
    The mixed kernel keeps the count of its program variant apart, and the
    flow wrappers the count of their bf16 kernel."""
    from glabc_tpu_torch.ops.kernels import (BatchedMixtureLogProb, FlowPull,
                                             FlowPush, FusedMixtureGLMALA,
                                             FusedMixtureGLMCMC,
                                             GenericFusedGLMALA,
                                             GenericFusedGLMCMC,
                                             PackedMixtureGLMCMC, PoolISIR,
                                             PoolISIRMixed, RadixSelect,
                                             SharedRedraw)

    out = {"packed": PackedMixtureGLMCMC, "unpacked": FusedMixtureGLMCMC,
           "pool_isir": PoolISIR, "kde_logprob": BatchedMixtureLogProb,
           "pool_isir_mixed": PoolISIRMixed, "glmala": FusedMixtureGLMALA,
           "flow_push": FlowPush, "flow_pull": FlowPull,
           "generic_glmcmc": GenericFusedGLMCMC,
           "generic_glmala": GenericFusedGLMALA,
           "shared_redraw": SharedRedraw}
    out = {k: (cls, "launches") for k, cls in out.items()}
    out["pool_isir_mixed_prog"] = (PoolISIRMixed, "program_launches")
    out["kde_logprob_pool"] = (BatchedMixtureLogProb, "pool_launches")
    out["radix_select"] = (RadixSelect, "launches")
    out["radix_select_pick"] = (RadixSelect, "pick_launches")
    out["flow_push_bf16"] = (FlowPush, "bf16_launches")
    out["flow_pull_bf16"] = (FlowPull, "bf16_launches")
    # the variants past the static shapes (phase 13)
    for key, cls in (("pool_isir", PoolISIR),
                     ("kde_logprob", BatchedMixtureLogProb),
                     ("pool_isir_mixed", PoolISIRMixed),
                     ("flow_push", FlowPush), ("flow_pull", FlowPull)):
        out[key + "_wide"] = (cls, "wide_launches")
    out["flow_push_wide_bf16"] = (FlowPush, "wide_bf16_launches")
    out["flow_pull_wide_bf16"] = (FlowPull, "wide_bf16_launches")
    return out


def _launch_key(key, kern, kwargs):
    """The count a wrapper's launch goes to (the mixed kernel's program
    variant and K4 with the shared epoch's pool epilogue have their own)."""
    if key == "pool_isir_mixed" and kern.program is not None:
        return "pool_isir_mixed_prog"
    if key == "kde_logprob" and kwargs.get("log_w") is not None:
        return "kde_logprob_pool"
    return key


def counted(fn):
    """``fn()`` with every wrapper's launch count set to 0 just before it;
    returns its result and the counts read just after."""
    counters = _wrappers()
    for cls, attr in counters.values():
        setattr(cls, attr, 0)
    out = fn()
    return out, {k: getattr(cls, attr) for k, (cls, attr) in counters.items()}


def shared_k4(chains, steps, chunk=512, seg=400):
    """K4's launches in a shared-adaptation run of ``steps`` transitions in
    segments of ``seg``: one a redraw chunk of ``chunk`` chains (one chunk
    when ``chunk`` is 0 or not below ``chains``) in each epoch, one epoch
    between two segments.  On the Mixture family these launches carry the
    pool epilogue (``kde_logprob_pool=``) and K10 launches as often
    (``shared_redraw=``); elsewhere K10 does not launch."""
    epochs = -(-steps // seg) - 1
    return epochs * (chains // chunk if 0 < chunk < chains else 1)


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


def ptxas_registers(text):
    """Registers of each kernel in ``nvcc -Xptxas -v`` output: ``{mangled
    name: (registers, spill stores in bytes)}``."""
    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if fn and m:
            out[fn] = (None, int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if fn and m:
            out[fn] = (int(m.group(1)), out.get(fn, (None, 0))[1])
    return out


def phase_build():
    from glabc_tpu_torch.ops.kernels import _build

    t = time.perf_counter()
    _build.build_all()
    libs = [(s, None) for s in _build.SOURCES] + list(_build.SHIPPED)
    for stem, prog in libs:
        _build.load_library(stem, prog)
    seconds = time.perf_counter() - t
    log(f"[build] {len(libs)} libraries ({len(_build.SOURCES)} sources, "
        f"{len(_build.SHIPPED)} (source, program) pairs), one nvcc each at "
        f"once, {' '.join(_build.NVCC_FLAGS)}: {seconds:.1f} s")
    for stem, prog in libs:
        name = _build.lib_path(stem, prog).name
        for line in _build.build_log(stem, prog).splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line:
                log(f"[build] {name}: {line.strip()}")
        text = sass_text(str(_build.lib_path(stem, prog)))
        if stem == "mixture_glmcmc":
            k1_sass_line("build", text)
        if stem == "kde_logprob":
            k4_sass_line("build", text)
        counts = sass_counts(None, text=text)
        if counts is None:
            log(f"[build] {name}: static SASS size: not measured (no "
                "cuobjdump)")
        else:
            for fn, n in counts.items():
                log(f"[build] {name}: static SASS {fn}: {n} instructions")
    for stem, prog in libs:
        tag = {"generic_glmcmc": "K8", "coupling_flow_bf16": "K7-bf16"}.get(
            stem)
        if tag is None:
            continue
        regs = ptxas_registers(_build.build_log(stem, prog))
        where = f" ({prog[0]})" if prog else ""
        log(f"[{tag}] ptxas registers{where}, per kernel: " + (", ".join(
            f"{fn} {r} (spill stores {sp} B)" for fn, (r, sp) in
            regs.items()) or "not measured (built by another process)"))


def make_kernel(layout, problem, T, algorithm="glmcmc", gf=0.9):
    """The canonical config: gf=0.9, B=5, N(0, I) proposal, RW scale 0.35."""
    from glabc_tpu_torch.ops.kernels import (FusedMixtureGLMCMC,
                                             PackedMixtureGLMCMC)

    cls = PackedMixtureGLMCMC if layout == "packed" else FusedMixtureGLMCMC
    return cls(problem.theta_dim, problem.y_obs.numpy(),
               epsilon=problem.epsilon, sigma=problem._noise_std,
               global_frequency=gf, batch_size=5, ip_loc=0.0, ip_scale=1.0,
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
        with Instrument(mixture=True) as inst:
            (secs, out), counts = counted(lambda: wall(fn))
        paths[name] = counts
        want = only(**{layout: calls})
        check(counts == want, f"{name}: launches {counts}, expected {want}")
        kern, a, k = inst.last[layout]
        ms = median_ms(lambda: kern.run(*a, **k))
        log(f"[entry] {name}: {layout} kernel {ms:.3f} ms per launch (the "
            f"last of {calls} launches of T=256, {CHAINS:,} chains, timed "
            f"again alone; card time between events around each call of "
            f"the run: {inst.kernel_ms(layout) / calls:.3f} ms)")
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
    # a ragged chain count at blocks of 32 and 1024 threads, and NaN and
    # -inf carried weights
    Cr = C - 13
    ptheta, plogw, g = _random_pools(T, 5, 2, Cr, 77)
    theta = torch.randn((2, Cr), generator=g, device=DEVICE)
    logw = torch.randn((Cr,), generator=g, device=DEVICE) - 4.0
    logw[::97], logw[5::101] = -math.inf, math.nan
    want = PoolISIR(2, steps_per_call=T).plain(5, ptheta, plogw, theta,
                                               logw, step0=1000)
    for blk in (32, 1024):
        got = PoolISIR(2, steps_per_call=T, block_chains=blk).run(
            5, ptheta, plogw, theta, logw, step0=1000)
        torch.cuda.synchronize()
        same, _ = _bitwise(got, want)
        log(f"[K3-vs-plain] d=2 B=5: {Cr:,} chains x {T} steps, {blk} "
            f"threads a block, NaN and -inf carried weights: bitwise {same}")
        check(same, f"pool_isir at {Cr} chains, {blk} threads a block, "
              "differs from its plain version")
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
                check(same, f"pool_isir_mixed d={d} S={S} gf={gf} is not "
                      "bitwise equal to its plain version")


_MISSING = object()


class Instrument:
    """Around one entry run: the card time of every kernel launch (CUDA
    events, by wrapper), the wall time of each adaptation epoch, of each
    flow training step and of each synchronous host copy of a segment's
    history (each between two synchronizes), and the arguments of each
    wrapper's last call, for the timing phase; ``prefer`` maps a launch key
    to a score of ``(kern, args, kwargs)``, and that key keeps the call of
    the highest score instead (the later on ties); ``mixture``: the K1/K2
    wrappers' launches too.  It launches nothing and counts nothing."""

    def __init__(self, prefer=None, mixture=False):
        self.mixture = mixture
        self.events, self.last = {}, {}
        self.prefer, self._score = prefer or {}, {}
        for kind in ("epoch", "train", "copy", "grad"):
            setattr(self, kind + "_s", 0.0)
            setattr(self, kind + "_n", 0)

    def kernel_ms(self, key=None):
        import torch

        torch.cuda.synchronize()
        keys = [key] if key else list(self.events)
        return sum(a.elapsed_time(b) for k in keys
                   for a, b in self.events.get(k, []))

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
        import glabc_tpu_torch.samplers.fused_program as prog
        import glabc_tpu_torch.samplers.glmcmc_nf_fused as nf
        from glabc_tpu_torch.samplers._fused_io import FusedRun

        self._saved = []

        def patch(owner, name, new):
            self._saved.append((owner, name,
                                owner.__dict__.get(name, _MISSING)))
            setattr(owner, name, new)

        for key, (cls, attr) in _wrappers().items():
            if (key in ("packed", "unpacked") and not self.mixture
                    or attr != "launches" or not hasattr(cls, "run")):
                continue

            def run(kern, *a, _orig=cls.run, _key=key, **k):
                _key = _launch_key(_key, kern, k)
                score = self.prefer.get(_key)
                s = None if score is None else score(kern, a, k)
                if s is None or s >= self._score.get(_key, s):
                    self.last[_key] = (kern, a, k)
                    self._score[_key] = s
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = _orig(kern, *a, **k)
                e1.record()
                self.events.setdefault(_key, []).append((e0, e1))
                return out
            patch(cls, "run", run)
        for name in ("make_epoch_fn", "make_shared_epoch_fn"):
            orig = getattr(agl, name)
            patch(agl, name, lambda *a, _o=orig, **k: self._synced(
                _o(*a, **k), "epoch"))
        orig = nf.make_pool_trainer
        patch(nf, "make_pool_trainer", lambda *a, _o=orig, **k: self._synced(
            _o(*a, **k), "train"))
        patch(prog, "program_grad_init",
              self._synced(prog.program_grad_init, "grad"))
        patch(FusedRun, "_history", self._synced(FusedRun._history, "copy"))
        return self

    def __exit__(self, *exc):
        for owner, name, old in reversed(self._saved):
            if old is _MISSING:
                delattr(owner, name)
            else:
                setattr(owner, name, old)
        return False

    def split(self, secs, names=None):
        """The wall time as the kernels' card time (K4 and K10 run inside
        the epochs, so they are not counted apart), epochs, training,
        history copies and the rest."""
        parts, shown = [], 0.0
        inside = ("kde_logprob", "kde_logprob_pool", "shared_redraw")
        for key in (names or [k for k in self.events if k not in inside]):
            k = self.kernel_ms(key) / 1e3
            shown += k
            parts.append(f"{key} {k:.3f} s ({len(self.events.get(key, []))})")
        for kind in ("epoch", "train", "copy", "grad"):
            n = getattr(self, kind + "_n")
            if n:
                sec = getattr(self, kind + "_s")
                shown += sec
                label = {"epoch": "epochs", "train": "training",
                         "copy": "history copies",
                         "grad": "initial gradient"}[kind]
                parts.append(f"{label} {sec:.2f} s ({n})")
        return (f"wall {secs:.2f} s = " + " + ".join(parts)
                + f" + other {secs - shown:.2f} s")


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


def seed_spread(n, groups):
    """``--seed-spread N [agl] [glmala] [nf] [ma2] [glmala_prog]
    [agl_prog]``: the statistics that the entry phases compare, over N
    seeds of each path and of the path it is compared with, with their
    means and standard deviations (the source of the MIXED_*, MALA_*, NF*_,
    MA2_*, MALA_PROG_* and AGL_PROG_* limits)."""
    import numpy as np

    def spread(label, run, seed0, names):
        rows = []
        for seed in range(seed0, seed0 + n):
            rows.append(run(seed))
            log(f"[spread] {label}, seed {seed}: " + ", ".join(
                f"{k} {v:.5f}" for k, v in zip(names, rows[-1])))
        a = np.asarray(rows)
        mean, sd = a.mean(0), a.std(0, ddof=1)
        log(f"[spread] {label}: " + "; ".join(
            f"{k} mean {m:.5f} sd {s_:.5f}" for k, m, s_ in
            zip(names, mean, sd)))

    with tempfile.TemporaryDirectory() as tmp:
        if "agl" in groups:
            for method, chains, seed0 in (("fused", MIXED_CHAINS, 100),
                                          ("scan", MIXED_SCAN_CHAINS, 200)):
                spread(f"AGLMCMC gf=0.5 {method}, {chains:,} chains",
                       lambda s_: mixed_stats(mixed_run(
                           tmp, s_, method, chains)[0].last_result), seed0,
                       ("hat_eps", "global", "local"))
        if "glmala" in groups:
            # the per-chain coin beside the shared one separates the
            # kernel's coin from its gradient noise in the local rate
            for method, coin, chains, seed0 in (
                    ("fused", "shared", MALA_CHAINS, 300),
                    ("fused", "per_chain", MALA_CHAINS, 350),
                    ("scan", None, MALA_SCAN_CHAINS, 400)):
                kw = {} if coin is None else dict(coin_mode=coin)
                spread(f"GLMALA {method} {coin or ''}, {chains:,} chains",
                       lambda s_: rates(mala_run(
                           tmp, s_, method, chains, MALA_ITERS, **kw)[0]
                           .last_result), seed0, ("global", "local"))
        if "nf" in groups:
            for label, method, gf, chains, iters, seed0 in (
                    ("gf=1 fused", "fused", 1.0, NF1_CHAINS, NF1_ITERS, 500),
                    ("gf=1 pooled", "pooled", 1.0, NF_POOLED_CHAINS,
                     NF1_ITERS, 600),
                    ("gf=0.5 fused", "fused", 0.5, NF05_CHAINS, NF05_ITERS,
                     700),
                    ("gf=0.5 pooled", "pooled", 0.5, NF_POOLED_CHAINS,
                     NF05_ITERS, 800)):
                spread(f"GLMCMC-NF {label}, {chains:,} chains",
                       lambda s_: rates(nf_run(
                           tmp, s_, method, gf, chains, iters)[0]
                           .last_result), seed0, ("global", "local"))
        if "ma2" in groups:
            for method, chains, seed0 in (("fused", PROG_CHAINS, 900),
                                          ("scan", PROG_SCAN_CHAINS, 1000)):
                spread(f"MA(2) GLMCMC {method}, {chains:,} chains",
                       lambda s_: tuple(np.concatenate(ma2_moments(ma2_run(
                           tmp, s_, method, chains)))), seed0,
                       ("mean1", "mean2", "sd1", "sd2"))
        if "glmala_prog" in groups:
            for method, coin, chains, iters, seed0 in (
                    ("fused", "shared", MALA_PROG_CHAINS, MALA_PROG_ITERS,
                     1100),
                    ("fused", "per_chain", MALA_PROG_PC_CHAINS,
                     MALA_PROG_PC_ITERS, 1200),
                    ("scan", None, MALA_PROG_SCAN_CHAINS, MALA_PROG_ITERS,
                     1300)):
                kw = {} if coin is None else dict(coin_mode=coin)

                def mala_stats(s_):
                    res = mala_prog_run(tmp, s_, method, chains, iters,
                                        **kw)[0].last_result
                    return (*rates(res), *ma2_moments(res, 64)[0])
                spread(f"MA(2) GLMALA {method} {coin or ''}, {chains:,} "
                       "chains", mala_stats, seed0,
                       ("global", "local", "mean1", "mean2"))
        if "agl_prog" in groups:
            for method, chains, seed0 in (("fused", AGL_PROG_CHAINS, 1400),
                                          ("scan", AGL_PROG_SCAN_CHAINS,
                                           1500)):
                spread(f"MA(2) AGLMCMC gf=0.5 {method}, {chains:,} chains",
                       lambda s_: mixed_stats(agl_prog_run(
                           tmp, s_, method, chains)[0].last_result), seed0,
                       ("hat_eps", "global", "local"))


def instrumented(paths, insts, name, fn, want, prefer=None):
    """One entry path under an :class:`Instrument` (``prefer`` as there),
    with every launch count set to 0 just before it; the counts must equal
    ``want``.  Returns the host seconds, ``fn``'s result and the
    instrument."""
    with Instrument(prefer) as inst:
        (secs, out), counts = counted(lambda: wall(fn))
    paths[name], insts[name] = counts, inst
    check(counts == want, f"{name}: launches {counts}, expected {want}")
    return secs, out, inst


def phase_aglmcmc(tmp):
    """AGLMCMC through MCMCRunner.run_aglmcmc at gf=1 and gf=0.5, fused,
    each beside the port's plain path on the card."""
    import numpy as np
    from glabc_tpu_torch import DiagGaussian, MCMCRunner, MixtureProblem

    lp = DiagGaussian.create(2, 0.0, math.log(0.35))
    ip = DiagGaussian.create(2, 0.0, 0.0)
    paths, insts = {}, {}

    path = lambda name, fn, want: instrumented(paths, insts, name, fn,
                                               want)

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
        only(pool_isir_mixed=steps // 400,
             kde_logprob_pool=shared_k4(MIXED_CHAINS, steps),
             shared_redraw=shared_k4(MIXED_CHAINS, steps)))
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
            tmp, 3, "scan", MIXED_SCAN_CHAINS),
        only(kde_logprob_pool=shared_k4(MIXED_SCAN_CHAINS, steps),
             shared_redraw=shared_k4(MIXED_SCAN_CHAINS, steps)))
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


# ------------------------------------------------ GLMALA and GLMCMC-NF
def glmala_ops(d, B, n_grad, local):
    """32-bit operations of one K6 chain-step at the least, ``(ops, sfu)``.
    Every add, multiply, compare and select counts one, as in
    ``transition_ops``; ``sfu`` counts the logs, square roots, sines and
    cosines.  A global step: S + B P Philox blocks (80 each), the uniforms,
    B Box-Muller pairs per dim, the candidates' densities and the iSIR
    selects.  A local step: S + P + ceil(n/2) P blocks, the replicates'
    Box-Muller pairs, and per replicate the sigma scaling and, per sign and
    coordinate, d add-subtract-square-adds, a square root and the two
    running sums; then the synthetic likelihood and the MH test."""
    P, S = -(-d // 2), -(-(B + 3) // 4)
    if not local:
        ops = (80 * (S + B * P) + 5 * (B + 3 + 2 * d * B) + 8 * d * B
               + B * (5 * d + 12 * d + 3 * d + 8) + 12 * d + 10)
        return ops, 4 * d * B + 2 * (B + 1)
    pairs = -(-n_grad // 2)
    bm = d + d * pairs
    ops = (80 * (S + P + pairs * P) + 5 * (B + 3 + 2 * bm) + 8 * bm
           + n_grad * (d + 2 * d * (4 * d + 3)) + 28 * d + 12 * d + 20)
    return ops, 4 * bm + 2 * d * n_grad + 2 * d + 2


def glmala_bound(kern, a, outs):
    """K6's bound for the launch ``kern.run(*a)`` with outputs ``outs``
    (flattened, counters last), counting the move each chain-step's coin
    picked (the ``gatt`` counter): ``(bound, bytes, operations,
    special-function operations, local chain-steps)``."""
    import torch

    C, T = a[1].shape[1], kern.T
    n_g = float(outs[-3].sum(dtype=torch.float64))
    n_local = C * T - n_g
    ops_l, sfu_l = glmala_ops(kern.d, kern.B, kern.cfg.n_grad, True)
    ops_g, sfu_g = glmala_ops(kern.d, kern.B, kern.cfg.n_grad, False)
    ops = n_local * ops_l + n_g * ops_g
    sfu = n_local * sfu_l + n_g * sfu_g
    shared = kern.coin_mode == "shared"
    moved = nbytes(*a[1:5], *((a[5],) if shared else ()), *outs)
    return bound_ms(moved, ops, sfu), moved, ops, sfu, n_local


def flow_fmas(d, L, H):
    """Multiply-adds of one row through the whole flow: the conditioner
    [d1, H, H, 2 d2] in each of L layers."""
    d2 = d // 2
    return L * ((d - d2) * H + H * H + 2 * d2 * H)


def _rel_err(a, b):
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


def _test_flow(d, L, H, seed):
    """A flow on the card that is not the identity: lecun-normal hidden
    layers, small random last layers and biases, as a few training steps
    leave them."""
    import torch
    from glabc_tpu_torch.models import CouplingFlow

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    f = CouplingFlow.create(d, L, H, generator=g, device=DEVICE)
    with torch.no_grad():
        f.w2.copy_(torch.randn(f.w2.shape, generator=g, device=DEVICE) * 0.02)
        f.b2.copy_(torch.randn(f.b2.shape, generator=g, device=DEVICE) * 0.05)
    return f, g


def check_split(label, err, flow, x, want, inverse):
    """K7's reading ``err`` against the plain flow within FLOW_SPLIT_TOL,
    and one TF32 product (the hi parts alone, emulated) on ``x``, against
    the plain flow's ``want`` there, beyond it."""
    from glabc_tpu_torch.ops.kernels.flow_kernel import tf32_products

    one = tf32_products(flow, x, inverse, split=False)
    ctl = max(_rel_err(a, b) for a, b in zip(one, want))
    log(f"[K7-split] {label}: kernel {err:.3g}, one TF32 product {ctl:.3g} "
        f"(limit {FLOW_SPLIT_TOL:g}: the kernel within, one product beyond)")
    check(err <= FLOW_SPLIT_TOL, f"K7 {label}: {err:.3g} > "
          f"{FLOW_SPLIT_TOL:g}, no closer than one TF32 product")
    check(ctl > FLOW_SPLIT_TOL, f"K7 {label}: one TF32 product reads "
          f"{ctl:.3g}, within {FLOW_SPLIT_TOL:g}: the limit does not tell "
          "the split from it")


def phase_mala_flow_kernels_vs_plain():
    """K6 at d in {2, 8}, both coin modes, SMALL_CHAINS x 32 steps, and K7
    push and pull at d in {2, 3, 8} with ragged row counts and at 1,048,576
    rows, each against its plain version (K7 also within FLOW_SPLIT_TOL,
    where one TF32 product is not); and the TF32 tensor-core (HMMA)
    instructions of K7's split products in every instantiation's SASS."""
    import numpy as np
    import torch
    from glabc_tpu_torch import HighDimMixtureProblem, MixtureProblem
    from glabc_tpu_torch.ops.kernels import (FlowPull, FlowPush,
                                             FusedMixtureGLMALA, _build)

    C, T = SMALL_CHAINS, 32
    for d in (2, 8):
        prob = MixtureProblem(0.05) if d == 2 else HighDimMixtureProblem(d)
        for mode in ("shared", "per_chain"):
            kern = FusedMixtureGLMALA(
                d, prob.y_obs.numpy(), epsilon=prob.epsilon,
                sigma=prob._noise_std, global_frequency=0.8, batch_size=5,
                tau=0.3, num_grad=100, steps_per_call=T, coin_mode=mode)
            g = torch.Generator(device=DEVICE).manual_seed(d)
            theta = (torch.randn((d, C), generator=g, device=DEVICE)
                     * 1.3).contiguous()
            y = (theta.abs() + 0.2 * torch.randn(
                (d, C), generator=g, device=DEVICE)).contiguous()
            logk = prob.log_kernel_of_y(y.T.contiguous()).contiguous()
            grad = torch.randn((d, C), generator=g, device=DEVICE)
            coins = torch.from_numpy((np.random.default_rng(d).random(T)
                                      < 0.8).astype(np.int32))
            args = (3, theta, y, logk, grad, coins)
            got = kern.run(*args, step0=640)
            want = kern.plain(*args, step0=640)
            torch.cuda.synchronize()
            outs = [*got[:5], *got[5]]
            refs = [*want[:5], *want[5]]
            max_abs, share = _chain_share(outs, refs, C)
            same, _ = _bitwise(outs, refs)
            step1 = float((got[4][0] - want[4][0]).abs().max())
            # no output may depend on the chains a warp or the block
            shapes = [(w, blk) for w in (32, 16, 8, 4) for blk in (64, 256)]
            across = True
            for shape in shapes:
                kern._geometry = lambda C, dev, shape=shape: shape[::-1]
                o = kern.run(*args, step0=640)
                across &= _bitwise([*o[:5], *o[5]], outs)[0]
            del kern._geometry
            l_acc = float(got[5][3].sum()) / max(
                1.0, float(C * T - got[5][1].sum()))
            log(f"[K6-vs-plain] d={d} {mode}: {C:,} chains x {T} steps, "
                f"(threads a block, chains a warp) "
                f"{kern._geometry(C, theta.device)}, bitwise {same}, max abs "
                f"diff {max_abs:.3g}, share of chains differing by > "
                f"{CHAIN_TOL:g}: {share:.3g}, step-1 history {step1:.3g}, "
                f"bitwise across W in (32, 16, 8, 4) x (64, 256) threads "
                f"{across}, local acceptance {l_acc:.4f}")
            check(share <= MAX_DIFF_SHARE, f"glmala d={d} {mode}: "
                  f"{share:.3%} of chains differ from the plain version")
            check(step1 <= CHAIN_TOL, f"glmala d={d} {mode}: the first "
                  f"step's history differs by {step1:.3g}")
            check(across, f"glmala d={d} {mode}: the outputs depend on the "
                  "chains a warp or the block size")
    for d, N in ((2, 4099), (3, 1000), (8, 777), (2, 1 << 20)):
        f, g = _test_flow(d, 32, 128, seed=d + N)
        z = torch.randn((d, N), generator=g, device=DEVICE)
        for cls in (FlowPush, FlowPull):
            got = cls().run(f, z)
            want = cls().plain(f, z)
            torch.cuda.synchronize()
            err = max(_rel_err(a, b) for a, b in zip(got, want))
            log(f"[K7-vs-plain] {cls.__name__} d={d} N={N:,}, 32 layers x "
                f"128: max |diff| / max(1, |x|) {err:.3g}")
            check(all(bool(torch.isfinite(a).all()) for a in got)
                  and err <= FLOW_TOL,
                  f"{cls.__name__} d={d} N={N}: {err:.3g} > {FLOW_TOL}")
            check_split(f"{cls.__name__} d={d} N={N:,}", err, f, z, want,
                        cls.inverse)
    hmma = sass_counts(str(_build.lib_path("coupling_flow")), "HMMA", "TF32")
    log(f"[K7] TF32 HMMA instructions in the SASS, per kernel: {hmma}")
    check(hmma is not None, "coupling_flow: no cuobjdump to read its SASS")
    for direction in ("0", "1"):   # the template's kInverse: push, pull
        kernels = [n for n in hmma if re.search(
            r"coupling_flow_kernelILb" + direction + "E", n)]
        check(kernels and all(hmma[n] > 0 for n in kernels),
              f"coupling_flow {('push', 'pull')[int(direction)]}: no TF32 "
              "tensor-core instructions in its SASS")


# ------------------------------------- the bf16-operand coupling flow
def flow_bf16_work(d, L, H):
    """What one row through the whole bf16 flow needs at the least,
    ``(tensor-core FLOPs, FP32-lane operations, exponentials)``.  Per layer:
    the h0 w1 and h1 w2 products on the tensor cores, 2 H (H + 2 d2) FLOPs
    (the d1-deep u1 w0 product runs on the lanes); on the lanes the bf16
    rounding of u1 (d1), h0 (d1 fused multiply-adds, the bias, the ReLU and
    half a paired bf16 conversion per unit: d1 + 2.5), h1's bias, ReLU and
    conversion (2.5 per unit), the 2 d2 biases of ts and the epilogue (a
    multiply, an add and the running sum per transformed coordinate); one
    exponential per transformed coordinate."""
    d2 = d // 2
    d1 = d - d2
    ops = d1 + H * (d1 + 2.5) + 2.5 * H + 2 * d2 + 3 * d2
    return L * 2 * H * (H + 2 * d2), L * ops, L * d2


def flow_tf32_work(d, L, H):
    """What one row through the whole float32 flow needs at the least in
    any 3xTF32 design, ``(tensor-core FLOPs, FP32-lane operations,
    exponentials)``: the least work, not the work of ``coupling_flow.cu``.
    Per layer: the H x H product as three split TF32 products, 3 x 2 H^2
    FLOPs; on the lanes h0 (d1 fused multiply-adds, the bias and the ReLU
    per unit: the kernel instead runs u1 w0 on the tensor cores as three
    split products over a k-tile of 8, more work than this for d1 < 8), its
    split (two conversions and a subtraction per unit), h1's bias and ReLU,
    ts = h1 w2 (2 d2 fused multiply-adds per unit and 2 d2 biases) and the
    epilogue (a multiply, an add and the running sum per transformed
    coordinate); one exponential per transformed coordinate."""
    d2 = d // 2
    d1 = d - d2
    ops = H * (d1 + 2) + 3 * H + 2 * H + 2 * d2 * H + 2 * d2 + 3 * d2
    return L * 6 * H * H, L * ops, L * d2


def tc_bound_ms(bytes_moved, tc_flops, ops, sfu, tc_peak=TC_BF16_PER_S):
    """The least time for a flow on the tensor cores: the largest of bytes
    over the memory rate, tensor-core FLOPs over the dense peak of their
    type (``tc_peak``), FP32-lane and special-function operations over
    theirs.  Returns ``(ms, bound_by, {term: ms})``."""
    terms = {"bytes": bytes_moved / HBM_BYTES_PER_S,
             "tensor cores": tc_flops / tc_peak,
             "FP32 lanes": ops / OPS_PER_S,
             "special functions": sfu / SFU_PER_S}
    top = max(terms, key=terms.get)
    return (1e3 * terms[top], "bytes" if top == "bytes" else "operations",
            {k: 1e3 * v for k, v in terms.items()})


def _bf16_row_diff(got, want):
    """Per row, the largest difference over its coordinates and its
    log-scale sum, relative to max(1, |plain|)."""
    import torch

    rel = lambda a, b: (a - b).abs() / b.abs().clamp_min(1.0)
    return torch.maximum(rel(got[0], want[0]).amax(0), rel(got[1], want[1]))


class Bf16Diff:
    """The kernel against the plain bf16 version, summed over chunks of
    rows: rows differing by more than BF16_ROW_TOL, the largest relative
    and absolute differences; and the same plain version against the
    float32 flow (``f32``), whose share must be 10 BF16_SHARE or more."""

    def __init__(self):
        self.rows = self.bad = self.bad32 = 0
        self.max_rel = self.max_abs = self.f32_dx = self.f32_ds = 0.0

    def add(self, got, want, f32):
        diff = _bf16_row_diff(got, want)
        self.rows += diff.numel()
        self.bad += int((diff > BF16_ROW_TOL).sum())
        self.bad32 += int((_bf16_row_diff(f32, want) > BF16_ROW_TOL).sum())
        self.max_rel = max(self.max_rel, float(diff.max()))
        self.max_abs = max(self.max_abs, *(float((a - b).abs().max())
                                           for a, b in zip(got, want)))
        self.f32_dx = max(self.f32_dx, float((got[0] - f32[0]).abs().max()))
        self.f32_ds = max(self.f32_ds, float((got[1] - f32[1]).abs().max()))

    def merge(self, other):
        """Pool ``other``'s rows into these."""
        self.rows += other.rows
        self.bad += other.bad
        self.bad32 += other.bad32
        for k in ("max_rel", "max_abs", "f32_dx", "f32_ds"):
            setattr(self, k, max(getattr(self, k), getattr(other, k)))

    def check(self, label, share_limit=BF16_SHARE, max_limit=BF16_MAX_TOL):
        """The limits: the share of rows beyond BF16_ROW_TOL (None: pooled
        over several shapes elsewhere) and the largest difference."""
        share, share32 = self.bad / self.rows, self.bad32 / self.rows
        lim = BF16_SHARE if share_limit is None else share_limit
        log(f"[K7-bf16-vs-plain] {label}: rows differing by > "
            f"{BF16_ROW_TOL:g} {share:.3g} (limit "
            f"{'pooled' if share_limit is None else f'{share_limit:.3g}'}),"
            f" max |diff| / max(1, |plain|) {self.max_rel:.3g} (limit "
            f"{max_limit:.3g}), max abs diff {self.max_abs:.3g}; float32 "
            f"flow against the plain bf16: rows differing {share32:.3g} "
            f"(must be >= {10 * lim:.3g}); bf16 kernel against float32: "
            f"max |dx| {self.f32_dx:.3g}, max |d sum log s| {self.f32_ds:.3g}")
        check((share_limit is None or share <= share_limit)
              and self.max_rel <= max_limit,
              f"K7-bf16 {label}: {share:.3g} of rows differ, max "
              f"{self.max_rel:.3g}")
        check(share32 >= 10 * lim, f"K7-bf16 {label}: the float32 "
              f"flow passes for bf16 ({share32:.3g} of rows differ)")


def phase_flow_bf16_vs_plain():
    """K7-bf16 push and pull at small shapes, each against its plain bf16
    version beside the float32 flow: 32 x 128 at d in {2, 3, 8} with ragged
    row counts and at 1,048,576 rows, and the JAX fixtures' widths H in
    {16, 32} on 3- and 4-layer flows; and the wgmma instructions (SASS
    HGMMA) in every kernel of its library, beside its mma.sync (HMMA)
    count."""
    import torch
    from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush, _build

    text = sass_text(str(_build.lib_path("coupling_flow_bf16")))
    hmma, hgmma = ((None, None) if text is None else
                   (sass_counts(None, op, text=text)
                    for op in ("HMMA", "HGMMA")))
    log(f"[K7-bf16] HMMA (mma.sync) instructions in the SASS, per kernel: "
        f"{hmma}")
    log(f"[K7-bf16] HGMMA (wgmma) instructions in the SASS, per kernel: "
        f"{hgmma}")
    check(bool(hgmma) and all(n > 0 for n in hgmma.values()),
          "coupling_flow_bf16: no wgmma (HGMMA) instructions in the SASS "
          "of every kernel")
    for d, N, L, H in ((2, 4099, 32, 128), (3, 1000, 32, 128),
                       (8, 777, 32, 128), (2, 1 << 20, 32, 128),
                       (2, 4099, 4, 16), (3, 1000, 4, 32), (8, 777, 3, 16)):
        f, g = _test_flow(d, L, H, seed=d + N + H)
        z = torch.randn((d, N), generator=g, device=DEVICE)
        for cls in (FlowPush, FlowPull):
            got = cls("bfloat16").run(f, z)
            want = cls("bfloat16").plain(f, z)
            f32 = cls().plain(f, z)
            torch.cuda.synchronize()
            check(all(bool(torch.isfinite(a).all()) for a in got),
                  f"K7-bf16 {cls.__name__} d={d} N={N}: not finite")
            diff = Bf16Diff()
            diff.add(got, want, f32)
            diff.check(f"{cls.__name__} d={d} N={N:,}, {L} layers x {H}")


def phase_flow_bf16(insts):
    """The slice's path at full width, through the flow API: the gf=1 NF
    run's trained flow pushes the z of its last pool draw (32,768,000 rows)
    with ``matmul_dtype='bfloat16'`` and pulls the result back (the round
    trip), the gf=0.5 run's flow pulls its last state (8,192 rows), and the
    gf=1 flow pulls 1,048,576 of the pushed rows; the launch counts set to 0
    just before it.  Then each output against the plain bf16 version over
    chunks of 2^20 rows and against the float32 kernel, and the kernel's
    times.  Returns the path's counts and its two ``kernels`` rows, without
    ``launches_by_path``."""
    import torch
    from glabc_tpu_torch.ops.kernels import (FlowPull, FlowPush,
                                             flow_pull_fused, flow_push_fused)

    _, (flow, z), _ = insts["run_glmcmc_nf_gf1"].last["flow_push"]
    _, (flow05, x05), _ = insts["run_glmcmc_nf_gf05"].last["flow_pull"]
    bf, chunk = dict(matmul_dtype="bfloat16"), 1 << 20

    def drive():
        x, s = flow_push_fused(flow, z, **bf)
        back = flow_pull_fused(flow, x, **bf)
        pulled05 = flow_pull_fused(flow05, x05, **bf)
        x20 = x[:, :chunk].contiguous()
        return (x, s), back, pulled05, x20, flow_pull_fused(flow, x20, **bf)

    (secs, outs), counts = counted(lambda: wall(drive))
    want = only(flow_push_bf16=1, flow_pull_bf16=3)
    check(counts == want, f"flow_api_bf16: launches {counts}, expected "
          f"{want}")
    pushed, back, pulled05, x20, pulled20 = outs
    check(all(bool(torch.isfinite(a).all()) for out in
              (pushed, back, pulled05, pulled20) for a in out),
          "K7-bf16 on the NF flows: not finite")
    log(f"[K7-bf16] flow API path: push {z.shape[1]:,} rows, pull them "
        f"back, pull {x05.shape[1]:,} and {chunk:,} rows (d={z.shape[0]}, "
        f"{flow.n_layers} layers x {flow.hidden}): wall {secs:.3f} s; "
        f"launches {counts}")

    def against(kern, fl, inp, got, ref32):
        """Plain bf16 over chunks of 2^20 rows (its summed CUDA-event
        time) against ``got``, beside the float32 kernel's ``ref32``."""
        diff, plain_ms = Bf16Diff(), 0.0
        for c0 in range(0, inp.shape[1], chunk):
            sl = lambda t: t[..., c0:c0 + chunk]
            part = sl(inp).contiguous()
            t_ms, want = timed(lambda: kern.plain(fl, part), 1)
            plain_ms += t_ms
            diff.add([sl(a) for a in got], want, [sl(a) for a in ref32])
            del want
        return diff, plain_ms

    def median_ms(fn, reps):
        fn()                                            # warm
        return sorted(timed(fn, reps)[0] for _ in range(3))[1]

    push, pull = FlowPush("bfloat16"), FlowPull("bfloat16")
    push32 = FlowPush().run(flow, z)
    d_push, push_plain_ms = against(push, flow, z, pushed, push32)
    d_push.check(f"push on the NF gf=1 flow, {z.shape[1]:,} rows")
    rt = float((back[0] - z).abs().max())
    back32 = FlowPull().run(flow, push32[0])
    rt32 = float((back32[0] - z).abs().max())
    log(f"[K7-bf16] round trip pull(push(z)) on the NF gf=1 flow, "
        f"{z.shape[1]:,} rows: max |z' - z| bf16 {rt:.3g}, float32 kernels "
        f"{rt32:.3g}; max |sum log s (pull) - sum log s (push)| bf16 "
        f"{float((back[1] - pushed[1]).abs().max()):.3g}, float32 "
        f"{float((back32[1] - push32[1]).abs().max()):.3g}")
    del back, back32, push32
    d_pull, pull_plain_ms = against(pull, flow05, x05, pulled05,
                                    FlowPull().run(flow05, x05))
    d_pull.check(f"pull on the NF gf=0.5 flow, {x05.shape[1]:,} rows")
    d_pull20, _ = against(pull, flow, x20, pulled20,
                          FlowPull().run(flow, x20))
    d_pull20.check(f"pull on the NF gf=1 flow, {chunk:,} rows")

    rows = []
    for key, kern, fl, inp, got, diff, plain_ms, reps, replaces in (
            ("flow_push_bf16", push, flow, z, pushed, d_push, push_plain_ms,
             1, "149"),
            ("flow_pull_bf16", pull, flow05, x05, pulled05, d_pull,
             pull_plain_ms, 20, "164")):
        ms = median_ms(lambda: kern.run(fl, inp), reps)
        d, N = inp.shape
        tc, ops, sfu = (N * w for w in flow_bf16_work(d, fl.n_layers,
                                                      fl.hidden))
        moved = nbytes(inp, *got) + nbytes(*fl.stack())
        b_ms, b_by, terms = tc_bound_ms(moved, tc, ops, sfu)
        log(f"[K7-bf16] {key} at {N:,} rows, d={d}, {fl.n_layers} layers x "
            f"{fl.hidden}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; "
            f"{moved / 1e9:.4f} GB, {tc:.4g} tensor-core FLOPs, {ops:.4g} "
            f"operations, {sfu:.4g} exponentials -> bound {b_ms:.4f} ms ("
            + ", ".join(f"{k} {v:.4f}" for k, v in terms.items()) + ")")
        rows.append(dict(
            name=f"coupling_flow_bf16 ({key.split('_')[1]})", route="cuda",
            source="glabc_tpu_torch/csrc/coupling_flow_bf16.cu",
            replaces=f"glabc_tpu/ops/pallas/flow_kernel.py:{replaces}",
            key=key, launches=counts[key], max_abs_err=diff.max_abs, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None, max_rel_err=diff.max_rel,
            rows_differing=diff.bad / diff.rows,
            max_abs_err_vs_f32_x=diff.f32_dx,
            max_abs_err_vs_f32_sum_log_s=diff.f32_ds))
    ms20 = median_ms(lambda: pull.run(flow, x20), 5)
    log(f"[K7-bf16] flow_pull_bf16 at {chunk:,} rows: kernel {ms20:.3f} ms")
    return counts, rows


def flow_bf16_kernel_rows(rows, paths):
    """The two K7-bf16 rows with their launches on every path driven."""
    for row in rows:
        key = row.pop("key")
        row["launches_by_path"] = {k: v[key] for k, v in paths.items()}
    return rows


def mala_run(tmp, seed, method, chains, iters, output_file=None, **kw):
    """``MCMCRunner.run_glmala`` at the canonical config."""
    import numpy as np
    from glabc_tpu_torch import DiagGaussian, MCMCRunner, MixtureProblem

    runner = MCMCRunner(MixtureProblem(0.05), output_dir=tmp, seed=seed,
                        num_chains=chains, verbose=False)
    ch = runner.run_glmala(iters, np.zeros(2), None, 0.8,
                           DiagGaussian.create(2, 0.0, 0.0), 5, 0.3, 100,
                           output_file=output_file, method=method, **kw)
    return runner, ch


def nf_run(tmp, seed, method, gf, chains, iters, output_file=None):
    """``MCMCRunner.run_glmcmc_nf`` at the canonical config (B=5, step 200,
    train 50, N(0, I) base, 32 x 128 flow)."""
    import numpy as np
    from glabc_tpu_torch import DiagGaussian, MCMCRunner, MixtureProblem

    runner = MCMCRunner(MixtureProblem(0.05), output_dir=tmp, seed=seed,
                        num_chains=chains, verbose=False)
    ch = runner.run_glmcmc_nf(iters, np.zeros(2), None, gf,
                              DiagGaussian.create(2, 0.0, math.log(0.35)),
                              DiagGaussian.create(2, 0.0, 0.0), 5, 200, 50,
                              output_file=output_file, method=method)
    return runner, ch


def rates(res):
    """Pooled global and local acceptance of a run."""
    c = res.counts
    return (float(c.global_accepts.sum() / max(c.global_attempts.sum(), 1)),
            float(c.local_accepts.sum() / max(c.local_attempts.sum(), 1)))


def _post(ch, burn):
    """E|theta|, variance and mean per dim after ``burn``, in float64, and
    the move fraction."""
    import numpy as np

    post = ch[:, burn:]
    flat = post.reshape(-1, post.shape[-1])
    absm = np.abs(flat).mean(0, dtype=np.float64)
    mean = flat.mean(0, dtype=np.float64)
    var = (flat.astype(np.float64) ** 2).mean(0) - mean ** 2
    moved = float(np.any(post[:, 1:] != post[:, :-1], axis=-1).mean())
    return absm, var, mean, moved


def typical_local(kern, a, k):
    """The score of a shared-coin GLMALA launch (K6 or K9) for its kernel
    row: the launch whose coins gave the number of local steps nearest
    the expected (1 - gf) T, the more of them on ties."""
    n_local = kern.T - int(a[5].sum())
    return (-abs(n_local - (1.0 - kern.cfg.gf) * kern.T), n_local)


def phase_glmala(tmp):
    """GLMALA through MCMCRunner.run_glmala: fused with the shared coin at
    the JAX package's chain count, beside the per-chain coin and the plain
    path on the card."""
    import numpy as np

    paths, insts = {}, {}

    path = lambda name, fn, want, prefer=None: instrumented(
        paths, insts, name, fn, want, prefer)

    secs, (runner, ch), inst = path(
        "run_glmala_fused", lambda: mala_run(
            tmp, 0, "fused", MALA_CHAINS, MALA_ITERS, "glmala_results.csv"),
        only(glmala=(MALA_ITERS - 1) // 32), {"glmala": typical_local})
    check(ch.shape == (MALA_CHAINS, MALA_ITERS, 2), f"GLMALA chains "
          f"{ch.shape}")
    check(bool(np.isfinite(ch).all()), "GLMALA chains are not finite")
    _csv(runner, "glmala_results.csv", ch)
    res = runner.last_result
    c = res.counts
    check(bool(np.all(c.global_attempts + c.local_attempts
                      == MALA_ITERS - 1)),
          "GLMALA: move counts do not sum to the steps run")
    absm, var, _, moved = _post(ch, 800)
    g_f, l_f = rates(res)
    del ch
    log(f"[mala] fused, shared coin: {MALA_CHAINS:,} chains x {MALA_ITERS}"
        f" iterations, {inst.split(secs, ['glmala'])}")
    log(f"[mala] fused, shared coin: after step 800 E|theta| "
        f"{absm.round(4).tolist()}, var {var.round(4).tolist()}, move "
        f"fraction {moved:.5f}; acceptance global {g_f:.5f} / local "
        f"{l_f:.5f}, global share "
        f"{float(c.global_attempts.mean()) / (MALA_ITERS - 1):.4f}")
    check(np.all((absm >= 1.40) & (absm <= 1.45)),
          f"GLMALA: E|theta| {absm} outside [1.40, 1.45]")
    check(np.all((var >= 1.95) & (var <= 2.25)),
          f"GLMALA: variance {var} outside [1.95, 2.25]")
    check(0.008 <= moved <= 0.015, f"GLMALA: move fraction {moved} outside "
          "[0.008, 0.015]")

    secs_pc, (runner_pc, ch_pc), inst_pc = path(
        "run_glmala_fused_per_chain", lambda: mala_run(
            tmp, 1, "fused", MALA_CHAINS, MALA_PC_ITERS,
            coin_mode="per_chain"),
        only(glmala=(MALA_PC_ITERS - 1) // 32))
    check(bool(np.isfinite(ch_pc).all()), "GLMALA per-chain: not finite")
    g_pc, l_pc = rates(runner_pc.last_result)
    a_pc = _absmean(ch_pc, 256)
    del ch_pc
    log(f"[mala] fused, per-chain coin: {MALA_CHAINS:,} chains x "
        f"{MALA_PC_ITERS}, {inst_pc.split(secs_pc, ['glmala'])}; E|theta| "
        f"after step 256 {a_pc.round(4).tolist()}, acceptance global "
        f"{g_pc:.5f} / local {l_pc:.5f}")

    secs_s, (scan, ch_s), inst_s = path(
        "run_glmala_scan", lambda: mala_run(
            tmp, 2, "scan", MALA_SCAN_CHAINS, MALA_ITERS), only())
    g_s, l_s = rates(scan.last_result)
    absm_s, var_s, _, moved_s = _post(ch_s, 800)
    log(f"[mala] plain path on the card: {MALA_SCAN_CHAINS:,} chains x "
        f"{MALA_ITERS}, wall {secs_s:.2f} s; after step 800 E|theta| "
        f"{absm_s.round(4).tolist()}, var {var_s.round(4).tolist()}, move "
        f"fraction {moved_s:.5f}; acceptance global {g_s:.5f} / local "
        f"{l_s:.5f}")
    log(f"[mala] local acceptance side by side: fused shared {l_f:.5f}, "
        f"fused per-chain {l_pc:.5f}, plain {l_s:.5f}; global: {g_f:.5f}, "
        f"{g_pc:.5f}, {g_s:.5f} (limit +- {MALA_GACC_TOL} of the plain "
        "path's)")
    check(abs(g_f - g_s) <= MALA_GACC_TOL, f"GLMALA: fused global "
          f"acceptance {g_f} is more than {MALA_GACC_TOL} from the plain "
          f"path's {g_s}")
    check(np.all(np.abs(absm - absm_s) < 0.05), "GLMALA: the fused and the "
          "plain path disagree on E|theta|")
    log("[launches] per path, counts set to 0 just before it: "
        + "; ".join(f"{k} {v}" for k, v in paths.items()))
    return paths, insts


def phase_glmcmc_nf(tmp):
    """GLMCMC-NF through MCMCRunner.run_glmcmc_nf: gf=1 fused (K3 + K7) and
    gf=0.5 fused (slice cadence, K7) at the JAX package's chain counts,
    each beside the pooled path, and the per-step path."""
    import numpy as np

    paths, insts = {}, {}

    path = lambda name, fn, want: instrumented(paths, insts, name, fn,
                                               want)

    def report(name, runner, ch, secs, inst, burn, chains, iters, keys):
        res = runner.last_result
        check(ch.shape == (chains, iters, 2), f"{name}: chains {ch.shape}")
        check(bool(np.isfinite(ch).all()), f"{name}: chains not finite")
        losses = np.asarray(res.loss_hist, np.float64)
        check(bool(np.isfinite(losses).all()), f"{name}: training losses "
              f"{losses}")
        absm, var, mean, _ = _post(ch, burn)
        g, l_ = rates(res)
        log(f"[nf] {name}: {chains:,} chains x {iters}, "
            f"{inst.split(secs, keys)}")
        log(f"[nf] {name}: after step {burn} E|theta| "
            f"{absm.round(4).tolist()}, mean {mean.round(4).tolist()}, var "
            f"{var.round(4).tolist()}; acceptance global {g:.5f} / local "
            f"{l_:.5f}; losses {losses.round(4).tolist()}")
        return absm, mean, g, l_

    steps1 = NF1_ITERS - 1
    secs, (r1, ch1), inst = path(
        "run_glmcmc_nf_gf1", lambda: nf_run(
            tmp, 0, "fused", 1.0, NF1_CHAINS, NF1_ITERS,
            "glmcmc_nf_results.csv"),
        only(pool_isir=steps1 // 200, flow_push=steps1 // 200,
             flow_pull=steps1 // 200))
    _csv(r1, "glmcmc_nf_results.csv", ch1)
    a1, m1, g1, _ = report("gf=1 fused", r1, ch1, secs, inst, 200,
                           NF1_CHAINS, NF1_ITERS,
                           ["flow_push", "pool_isir", "flow_pull"])
    del ch1
    check(np.all((a1 >= 1.40) & (a1 <= 1.45)), f"NF gf=1: E|theta| {a1}")
    check(np.all(np.abs(m1) <= 0.05), f"NF gf=1: mean theta {m1} (mode "
          "collapse)")
    check(0.010 <= g1 <= 0.022, f"NF gf=1: global acceptance {g1} outside "
          "[0.010, 0.022]")
    secs, (r1p, ch1p), inst = path(
        "run_glmcmc_nf_gf1_pooled", lambda: nf_run(
            tmp, 1, "pooled", 1.0, NF_POOLED_CHAINS, NF1_ITERS),
        only(flow_push=steps1 // 200, flow_pull=steps1))
    a1p, _, g1p, _ = report("gf=1 pooled", r1p, ch1p, secs, inst, 200,
                            NF_POOLED_CHAINS, NF1_ITERS,
                            ["flow_push", "flow_pull"])
    del ch1p
    log(f"[nf] gf=1 global acceptance: fused {g1:.5f}, pooled {g1p:.5f} "
        f"(limit +- {NF1_GACC_TOL})")
    check(abs(g1 - g1p) <= NF1_GACC_TOL, "NF gf=1: the fused and the "
          "pooled path's global acceptance differ")
    check(abs(a1.mean() - a1p.mean()) < 0.05, "NF gf=1: the fused and the "
          "pooled path disagree on E|theta|")

    steps5 = NF05_ITERS - 1
    secs, (r5, ch5), inst = path(
        "run_glmcmc_nf_gf05", lambda: nf_run(
            tmp, 2, "fused", 0.5, NF05_CHAINS, NF05_ITERS),
        only(flow_push=steps5 // 400, flow_pull=steps5))
    a5, m5, g5, l5 = report("gf=0.5 fused (slice)", r5, ch5, secs, inst,
                            800, NF05_CHAINS, NF05_ITERS,
                            ["flow_push", "flow_pull"])
    del ch5
    check(np.all((a5 >= 1.40) & (a5 <= 1.45)), f"NF gf=0.5: E|theta| {a5}")
    check(np.all(np.abs(m5) <= 0.05), f"NF gf=0.5: mean theta {m5}")
    secs, (r5p, ch5p), inst = path(
        "run_glmcmc_nf_gf05_pooled", lambda: nf_run(
            tmp, 3, "pooled", 0.5, NF_POOLED_CHAINS, NF05_ITERS),
        only(flow_push=steps5 // 400, flow_pull=steps5))
    a5p, _, g5p, l5p = report("gf=0.5 pooled (cursor)", r5p, ch5p, secs,
                              inst, 800, NF_POOLED_CHAINS, NF05_ITERS,
                              ["flow_push", "flow_pull"])
    del ch5p
    log(f"[nf] gf=0.5 acceptance, fused / pooled: global {g5:.5f} / "
        f"{g5p:.5f} (limit +- {NF05_GACC_TOL}), local {l5:.5f} / {l5p:.5f}"
        f" (limit +- {NF05_LACC_TOL})")
    check(abs(g5 - g5p) <= NF05_GACC_TOL, "NF gf=0.5: global acceptance "
          "of the fused and the pooled path differ")
    check(abs(l5 - l5p) <= NF05_LACC_TOL, "NF gf=0.5: local acceptance "
          "of the fused and the pooled path differ")

    steps_s = NF_SCAN_ITERS - 1
    secs, (rs, chs), inst = path(
        "run_glmcmc_nf_scan", lambda: nf_run(
            tmp, 4, "scan", 0.5, NF_SCAN_CHAINS, NF_SCAN_ITERS),
        only(flow_push=steps_s, flow_pull=steps_s))
    check(chs.shape == (NF_SCAN_CHAINS, NF_SCAN_ITERS, 2)
          and bool(np.isfinite(chs).all()), "NF scan: chains")
    log(f"[nf] scan: {NF_SCAN_CHAINS} chains x {NF_SCAN_ITERS}, "
        f"{inst.split(secs, ['flow_push', 'flow_pull'])}; finite")
    log("[launches] per path, counts set to 0 just before it: "
        + "; ".join(f"{k} {v}" for k, v in paths.items()))
    return paths, insts


def mala_flow_kernel_rows(insts, paths):
    """K6, K7-push and K7-pull at their main-path shapes (the arguments of
    their last launch on their entry path): time per launch, the plain
    version's time and agreement, bytes, operations, bound.  No single
    PyTorch call computes a fused GLMALA transition or a 32-layer coupling
    flow: no library time."""
    import torch

    rows = []

    def median_ms(fn, reps=3):
        fn()                                            # warm
        return sorted(timed(fn, reps)[0] for _ in range(3))[1]

    def row(name, source, replaces, key, main_path, max_abs, ms, plain_ms,
            b, **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=paths[main_path][key],
                    max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                    bound_ms=b[0], bound_by=b[1], library_ms=None,
                    launches_by_path={k: v[key] for k, v in paths.items()},
                    **extra)

    # K6: the shared coin's typical launch, and the per-chain coin's last
    for main, label in (("run_glmala_fused", "shared coin"),
                        ("run_glmala_fused_per_chain", "per-chain coin")):
        kern, a, k = insts[main].last["glmala"]
        ms = median_ms(lambda: kern.run(*a, **k))
        got = kern.run(*a, **k)
        plain_ms, want = timed(lambda: kern.plain(*a, **k), 1)
        outs, refs = [*got[:5], *got[5]], [*want[:5], *want[5]]
        C = a[1].shape[1]
        max_abs, share = _chain_share(outs, refs, C)
        step1 = float((got[4][0] - want[4][0]).abs().max())
        check(share <= MAX_DIFF_SHARE and step1 <= CHAIN_TOL,
              f"glmala ({label}) at the main shape: {share:.3%} of chains "
              f"differ, the first step's history by {step1:.3g}")
        b, moved, ops, sfu, n_local = glmala_bound(kern, a, outs)
        n_run = paths[main]["glmala"]
        mean_ms = insts[main].kernel_ms("glmala") / n_run
        log(f"[K6] glmala ({label}) at the main shape, {C:,} chains x "
            f"T={kern.T}, (threads a block, chains a warp) "
            f"{kern._geometry(C, a[1].device)}, {n_local / C:.2f} local "
            f"steps a chain (expected {(1.0 - kern.cfg.gf) * kern.T:.1f}), "
            f"num_grad={kern.cfg.n_grad}: max abs diff {max_abs:.3g}, share "
            f"of chains differing {share:.3g}, step-1 history {step1:.3g}; "
            f"kernel {ms:.3f} ms (the entry run's {n_run} launches: "
            f"{mean_ms:.3f} ms each), plain {plain_ms:.1f} ms; "
            f"{moved / 1e9:.4f} GB, {ops:.4g} operations and {sfu:.4g} "
            f"special-function operations -> bound {b[0]:.4f} ms ({b[1]})")
        rows.append(row("glmala" + ("" if label == "shared coin"
                                    else " (per-chain coin)"),
                        "glabc_tpu_torch/csrc/glmala.cu",
                        "glabc_tpu/ops/pallas/glmala_kernel.py:131",
                        "glmala", main, max_abs, ms, plain_ms, b))
        del got, want, outs, refs

    # K7 push: the gf=1 run's last pool draw; the plain version over
    # chunks of 2^20 rows (per-layer matmuls at once would need ~60 GB)
    for key, main, name in (("flow_push", "run_glmcmc_nf_gf1", "K7-push"),
                            ("flow_pull", "run_glmcmc_nf_gf05", "K7-pull")):
        kern, (flow, x), k = insts[main].last[key]
        ms = median_ms(lambda: kern.run(flow, x, **k),
                       1 if x.shape[1] > (1 << 22) else 20)
        got = kern.run(flow, x)
        chunk = 1 << 20
        plain_ms, max_abs, err = 0.0, 0.0, 0.0
        for c0 in range(0, x.shape[1], chunk):
            xc = x[:, c0:c0 + chunk].contiguous()
            t_ms, want = timed(lambda: kern.plain(flow, xc), 1)
            plain_ms += t_ms
            if c0 == 0:
                first = (xc, want)
            for a_, b_ in zip((got[0][:, c0:c0 + chunk], got[1][c0:c0 + chunk]),
                              want):
                max_abs = max(max_abs, float((a_ - b_).abs().max()))
                err = max(err, _rel_err(a_, b_))
            del want
        check(err <= FLOW_TOL, f"{key} at the main shape: {err:.3g} > "
              f"{FLOW_TOL}")
        check_split(f"{key} at the main shape (one TF32 product on its "
                    f"first {first[0].shape[1]:,} rows)", err, flow,
                    *first, kern.inverse)
        d, N = x.shape
        fm = flow_fmas(d, flow.n_layers, flow.hidden) * N
        weights = nbytes(*flow.stack())
        moved = nbytes(x, *got) + weights
        # the bound with every multiply-add on the FP32 lanes, as the SIMT
        # design before the tensor-core one had it, kept for comparison
        lanes = bound_ms(moved, fm, N * flow.n_layers * (d // 2))
        tc, ops, sfu = (N * w for w in flow_tf32_work(d, flow.n_layers,
                                                      flow.hidden))
        b_ms, b_by, terms = tc_bound_ms(moved, tc, ops, sfu, TC_TF32_PER_S)
        b = (b_ms, b_by)
        log(f"[{name}] {key} at the main shape, {N:,} rows, d={d}, "
            f"{flow.n_layers} layers x {flow.hidden}: max abs diff "
            f"{max_abs:.3g}, max |diff| / max(1, |x|) {err:.3g}; kernel "
            f"{ms:.3f} ms, plain {plain_ms:.1f} ms; {moved / 1e9:.4f} GB, "
            f"{tc:.4g} 3xTF32 tensor-core FLOPs, {ops:.4g} operations, "
            f"{sfu:.4g} exponentials -> bound {b_ms:.4f} ms ("
            + ", ".join(f"{k} {v:.4f}" for k, v in terms.items())
            + f"); all {fm:.4g} multiply-adds on the FP32 lanes: "
            f"{lanes[0]:.4f} ms")
        rows.append(row(f"coupling_flow ({key.split('_')[1]})",
                        "glabc_tpu_torch/csrc/coupling_flow.cu",
                        "glabc_tpu/ops/pallas/flow_kernel.py:"
                        + ("149" if key == "flow_push" else "164"), key,
                        main, max_abs, ms, plain_ms, b,
                        fp32_lane_bound_ms=lanes[0]))
        del got, first
    return rows


def _agl_row(name, source, replaces, key, paths, main_path, max_abs, ms,
             plain_ms, b):
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=paths[main_path][key], max_abs_err=max_abs, ms=ms,
                plain_ms=plain_ms, bound_ms=b[0], bound_by=b[1],
                library_ms=None,
                launches_by_path={k: v[key] for k, v in paths.items()})


def agl_kernel_rows(insts, paths, wide=False):
    """K3, K4 and K5 at their main-path shapes (the arguments of their last
    launch on their entry path): time per launch (median of 3 windows of
    3), the plain version's time and agreement, bytes, operations, bound.
    No single PyTorch call computes these functions: no library time.
    ``wide``: their runtime-d variants on phase 13's d=40 runs."""
    import torch

    rows = []
    gf1, gf05 = (("shapes_aglmcmc_gf1", "shapes_aglmcmc_gf05") if wide
                 else ("run_aglmcmc_gf1", "run_aglmcmc_gf05"))
    sfx = "_wide" if wide else ""

    def median_ms(fn):
        fn()                                            # warm
        return sorted(timed(fn, 3)[0] for _ in range(3))[1]

    # K3
    kern, a, k = insts[gf1].last["pool_isir"]
    ms = median_ms(lambda: kern.run(*a, **k))
    got = kern.run(*a, **k)
    plain_ms, want = timed(lambda: kern.plain(*a, **k), 1)
    same, max_abs = _bitwise(got, want)
    check(same, "pool_isir at the main shape differs from its plain version")
    T, B, d, C = a[1].shape
    b, b_old, moved, ops, moved_old, ops_old = pool_isir_bound(a, got)
    log(f"[K3{sfx}] pool_isir at the main shape, {C:,} chains x T={T}, "
        f"B={B}, "
        f"d={d}, {kern._threads(C, a[2].device)} threads a block, "
        f"{float(got[3].sum()) / (C * T):.5f} of chain-steps move: bitwise "
        f"{same}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; "
        f"{moved / 1e9:.4f} GB, {ops:.4g} operations -> bound {b[0]:.4f} ms "
        f"({b[1]}); by the older count (every candidate's theta): "
        f"{moved_old / 1e9:.4f} GB, {ops_old:.4g} operations -> "
        f"{b_old[0]:.4f} ms ({b_old[1]})")
    rows.append(_agl_row(
        "pool_isir" + sfx, "glabc_tpu_torch/csrc/pool_isir.cu",
        "glabc_tpu/ops/pallas/pool_isir_kernel.py:103", "pool_isir" + sfx,
        paths, gf1, max_abs, ms, plain_ms, b))
    del got, want

    # K4
    kern, a, k = insts[gf1].last["kde_logprob"]
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
    log(f"[K4{sfx}] kde_logprob at the main shape, {C:,} chains x N={N} "
        f"points "
        f"x P={P} components, d={d}: max |diff| {max_abs:.3g}, relative "
        f"{err:.3g}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; "
        f"{moved / 1e9:.4f} GB, {work * kde_ops(d):.4g} operations and "
        f"{work:.4g} exponentials -> bound {b[0]:.3f} ms ({b[1]})")
    rows.append(_agl_row(
        "kde_logprob" + sfx, "glabc_tpu_torch/csrc/kde_logprob.cu",
        "glabc_tpu/ops/pallas/kde_logprob_kernel.py:106",
        "kde_logprob" + sfx, paths, gf1, max_abs, ms, plain_ms, b))
    del got, want

    # K5
    kern, a, k = insts[gf05].last["pool_isir_mixed"]
    ms = median_ms(lambda: kern.run(*a, **k))
    got = kern.run(*a, **k)
    plain_ms, want = timed(lambda: kern.plain(*a, **k), 1)
    T, B, d, C = a[2].shape
    S = a[1].pre.shape[0]
    max_abs, share = _chain_share(got, want, C)
    same, _ = _bitwise(got, want)
    check(share <= MAX_DIFF_SHARE, f"pool_isir_mixed at the main shape: "
          f"{share:.3%} of chains differ")
    check(same, "pool_isir_mixed at the main shape is not bitwise equal to "
          "its plain version")
    ops, sfu = map(sum, zip(mixed_isir_ops(d, B, S), builtin_local_ops(d)))
    moved = nbytes(*a[1], *a[2:9], *(x for x in got if x is not None))
    b = k5_bound("K5", a, got, ops, sfu, moved)
    log(f"[K5{sfx}] pool_isir_mixed at the main shape, {C:,} chains x "
        f"T={T}, "
        f"B={B}, S={S}, d={d}, (threads a block, chains a warp) "
        f"{kern._geometry(C, a[6].device)}: bitwise {same}, max abs diff "
        f"{max_abs:.3g}, share of chains "
        f"differing {share:.3g}; kernel {ms:.3f} ms, plain {plain_ms:.1f} "
        f"ms; {moved / 1e9:.4f} GB -> bound {b[0]:.3f} ms ({b[1]})")
    rows.append(_agl_row(
        "pool_isir_mixed" + sfx, "glabc_tpu_torch/csrc/pool_isir_mixed.cu",
        "glabc_tpu/ops/pallas/pool_isir_mixed_kernel.py:190",
        "pool_isir_mixed" + sfx, paths, gf05, max_abs, ms, plain_ms, b))
    if not wide:
        rows.append(shared_redraw_row(insts, paths, gf05))
        rows.append(kde_logprob_pool_row(insts, paths, gf05))
    return rows


def shared_redraw_row(insts, paths, main_path):
    """K10 at the main path's shape (the gf=0.5 run's last redraw chunk:
    512 chains x P = 2,000 rows from M = 8,000 candidates, d = 2): time per
    launch, the plain version's time, theta and x bitwise, dis and prior +
    log K within 1e-6 max(1, |v|), and the bytes bound of
    :func:`redraw_bytes`."""
    kern, a, _ = insts[main_path].last["shared_redraw"]
    wrapper_ms = median_ms(lambda: kern.run(*a))
    ms = redraw_device_ms(a)
    got = kern.run(*a)
    plain_ms, want = timed(lambda: kern.plain(*a), 1)
    same = all(_bitwise(g, w)[0] for g, w in zip(got[:2], want[:2]))
    err = max(float(((g - w).abs() / w.abs().clamp_min(1.0)).max())
              for g, w in zip(got[2:], want[2:]))
    max_abs = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(same and err <= 1e-6, f"shared_redraw at the main shape: theta "
          f"and x bitwise {same}, dis and prior + log K within {err:.3g}")
    u, z, noise, _ = a
    (C, M), (P, d) = u.shape, noise.shape[1:]
    moved = redraw_bytes(*a)
    b = bound_ms(moved, 0)
    log(f"[K10] shared_redraw at the main shape, {C:,} chains x P={P} rows "
        f"from M={M} candidates, d={d}: theta and x bitwise {same}, dis and "
        f"prior + log K within {err:.3g}; kernel {ms:.4f} ms of device "
        f"time (a process of its own; {wrapper_ms:.4f} ms a call through "
        f"the wrapper, whose host time it hides), plain {plain_ms:.1f} ms; "
        f"{moved / 1e6:.3f} MB -> "
        f"bound {b[0]:.4f} ms "
        f"({b[1]}); launches {paths[main_path]['shared_redraw']} "
        f"(shared_k4 {shared_k4(MIXED_CHAINS, MIXED_ITERS - 1)})")
    return _agl_row(
        "shared_redraw", "glabc_tpu_torch/csrc/shared_redraw.cu",
        "none (the shared epoch's redraw, glabc_tpu/samplers/aglmcmc.py "
        "_redraw and _pool_from_proposals, fused by XLA)", "shared_redraw",
        paths, main_path, max_abs, ms, plain_ms, b)


def kde_logprob_pool_row(insts, paths, main_path):
    """K4 with the shared epoch's pool epilogue at the main path's shape
    (the gf=0.5 run's last redraw chunk: its 512 x 2,000 rows under the
    1,024-point KDE, d = 2), on copies of that call's rows and log-weights
    with NaNs put into two rows: time per launch, log q within KDE_TOL of
    the plain version's (NaN where it is), log w likewise (-inf where it
    is) and the rows bitwise (NaN rows zeroed), and the bound of K4's work
    with the epilogue's bytes (log w read and written, the NaN rows'
    zeros)."""
    import torch

    kern, a, k = insts[main_path].last["kde_logprob_pool"]
    x0, rest, lw0 = a[0].clone(), a[1:], k["log_w"].clone()
    x0[0, 0, 0] = float("nan")
    x0[0, 7] = float("nan")

    def fresh():
        return x0.clone(), torch.empty_like(k["out"]), lw0.clone()

    bufs = fresh()
    ms = median_ms(lambda: kern.run(bufs[0], *rest, out=bufs[1],
                                    log_w=bufs[2]))
    got, want = fresh(), fresh()
    kern.run(got[0], *rest, out=got[1], log_w=got[2])
    plain_ms, _ = timed(lambda: kern.plain(want[0], *rest, out=want[1],
                                           log_w=want[2]), 1)
    x_same = _bitwise([got[0]], [want[0]])[0]
    zeroed = int(torch.isnan(x0).any(dim=-1).sum())
    x_same &= zeroed == 2 and not bool(torch.isnan(got[0]).any())
    errs, max_abs = [], 0.0
    for g, w in zip(got[1:], want[1:]):
        fin = torch.isfinite(w)
        same = bool(torch.equal(fin, torch.isfinite(g))
                    and torch.equal(torch.isnan(g), torch.isnan(w))
                    and torch.equal(g[~fin & ~torch.isnan(w)],
                                    w[~fin & ~torch.isnan(w)]))
        diff = (g[fin] - w[fin]).abs()
        errs.append(float((diff / w[fin].abs().clamp_min(1.0)).max())
                    if same else math.inf)
        max_abs = max(max_abs, float(diff.max()))
    neg_inf = int(torch.isneginf(got[2]).sum())
    check(x_same and max(errs) <= KDE_TOL and neg_inf >= 2,
          f"kde_logprob_pool at the main shape: rows bitwise {x_same}, log q "
          f"within {errs[0]:.3g}, log w within {errs[1]:.3g} (limit "
          f"{KDE_TOL}), {neg_inf} log w at -inf")
    C, N, d = x0.shape
    P = rest[0].shape[1]
    work = C * N * P
    moved = nbytes(x0, *rest, got[1]) + 2 * nbytes(lw0) + zeroed * d * 4
    b = bound_ms(moved, work * kde_ops(d), work)
    log(f"[K4-pool] kde_logprob_pool at the main shape, {N:,} points x "
        f"P={P} components, d={d}, {zeroed} NaN rows put in: log q within "
        f"{errs[0]:.3g}, log w within {errs[1]:.3g} ({neg_inf} at -inf), "
        f"rows bitwise {x_same}; kernel {ms:.4f} ms, plain {plain_ms:.1f} "
        f"ms; {moved / 1e9:.4f} GB, {work * kde_ops(d):.4g} operations and "
        f"{work:.4g} exponentials -> bound {b[0]:.4f} ms ({b[1]}); launches "
        f"{paths[main_path]['kde_logprob_pool']} (shared_k4 "
        f"{shared_k4(MIXED_CHAINS, MIXED_ITERS - 1)})")
    return _agl_row(
        "kde_logprob_pool", "glabc_tpu_torch/csrc/kde_logprob.cu",
        "glabc_tpu/ops/pallas/kde_logprob_kernel.py:106, with the log-weights "
        "of glabc_tpu/samplers/aglmcmc.py _pool_from_proposals",
        "kde_logprob_pool", paths, main_path, max_abs, ms, plain_ms, b)


def k4_shared_epoch_line():
    """K4 at the shape of the AGLMCMC gf=0.5 run's shared-epoch density:
    one KDE of 1,024 support points (d = 2) over MIXED_CHAINS x 2,000 pool
    points as one chain (C = 1), beside ``KernelDensity.log_prob`` in
    chunks of 512 chains' points, as the epoch computed it before it took
    K4 (it now makes one K4 launch a redraw chunk): both times and their
    largest relative difference."""
    import torch
    from glabc_tpu_torch.models import KernelDensity
    from glabc_tpu_torch.ops.kernels import (BatchedMixtureLogProb,
                                             resident_from_kde)

    P_pool, S, chunk, d = 2000, 1024, 512, 2
    g = torch.Generator(device=DEVICE).manual_seed(12)
    kde = KernelDensity.fit(torch.randn((S, d), generator=g, device=DEVICE)
                            * 1.4)
    x = torch.randn((MIXED_CHAINS, P_pool, d), generator=g,
                    device=DEVICE) * 1.4
    res = resident_from_kde(kde)
    args = (x.reshape(1, -1, d), res.mu_scaled[None].contiguous(),
            res.pre[None].contiguous(), res.inv2h[None].contiguous())
    kern = BatchedMixtureLogProb()
    ms = median_ms(lambda: kern.run(*args))
    got = kern.run(*args).reshape(MIXED_CHAINS, P_pool)

    def epoch_density():
        return torch.cat([kde.log_prob(x[c0:c0 + chunk])
                          for c0 in range(0, MIXED_CHAINS, chunk)])

    epoch_density()                                      # warm
    lp_ms, lp = timed(epoch_density, 1)
    err = float(((got - lp).abs() / lp.abs().clamp_min(1.0)).max())
    work = MIXED_CHAINS * P_pool * S
    b = bound_ms(nbytes(*args) + 4 * MIXED_CHAINS * P_pool, work * kde_ops(d),
                 work)
    log(f"[K4-epoch] the gf=0.5 run's shared-epoch density as one K4 call, "
        f"C=1 x N={MIXED_CHAINS * P_pool:,} points x P={S} components, d={d}: "
        f"kernel {ms:.3f} ms (bound {b[0]:.3f} ms, {b[1]}); "
        f"KernelDensity.log_prob in {MIXED_CHAINS // chunk} chunks of {chunk}"
        f" x {P_pool} points {lp_ms:.1f} ms ({lp_ms / ms:.1f}x); max |diff| "
        f"/ max(1, |log q|) {err:.3g}")
    check(bool(torch.isfinite(got).all()) and err <= 1e-3,
          f"K4 at the shared-epoch shape against KernelDensity.log_prob: "
          f"{err:.3g} > 1e-3")


def median_ms(fn):
    """The median of 3 timed windows of 3 calls of ``fn``, after one warm
    call, in ms per call."""
    fn()
    return sorted(timed(fn, 3)[0] for _ in range(3))[1]


def device_ms(fn, kernel, reps=10):
    """The device time of the kernel whose name holds ``kernel`` over
    ``reps`` calls of ``fn`` (``torch.profiler``), in ms per call: for a
    kernel shorter than its wrapper's host time, which a window of calls
    timed by events measures instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
             if kernel in e.key)
    check(us > 0, f"the profiler saw no {kernel} on the device")
    return us / reps / 1e3


def _redraw_device_child(path):
    """K10's device time (:func:`device_ms`) on the arguments saved at
    ``path``, in a process of its own: in the long smoke process
    ``torch.profiler`` drops kernel events in some runs (see
    :func:`_trace_child`).  Writes ``<path>.json``."""
    import torch
    from glabc_tpu_torch.ops.kernels.shared_redraw_kernel import (
        RedrawInputs, SharedRedraw)

    saved = torch.load(path)
    u, z, noise = saved["u"], saved["z"], saved["noise"]
    inputs = RedrawInputs(*saved["inputs"])
    kern = SharedRedraw()
    ms = device_ms(lambda: kern.run(u, z, noise, inputs),
                   "shared_redraw_kernel")
    with open(path + ".json", "w", encoding="utf-8") as f:
        json.dump({"ms": ms}, f)


def redraw_device_ms(args):
    """K10's device time a launch on ``args`` (its last call's ``u, z,
    noise, inputs``), read by :func:`_redraw_device_child` in a spawned
    process."""
    import torch

    u, z, noise, inputs = args
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "k10.pt")
        torch.save({"u": u, "z": z, "noise": noise,
                    "inputs": list(inputs)}, path)
        ctx = __import__("multiprocessing").get_context("spawn")
        child = ctx.Process(target=_redraw_device_child, args=(path,))
        child.start()
        child.join(300)
        if child.is_alive():
            child.kill()
            die("the K10 timing child did not finish in 300 s")
        check(child.exitcode == 0,
              f"the K10 timing child exited {child.exitcode}")
        with open(path + ".json", encoding="utf-8") as f:
            return json.load(f)["ms"]


# the mesh cell's shard: 16,384 chains x 2,000 pool rows a rank
RADIX_N = 32_768_000
MESH_SUPPORT = 1024      # its KDE support points an epoch


def radix_input(n, seed):
    """``n`` half-normal float32 values on the card, 1 % of them at the NaN
    rows' sentinel ``_NAN_DIS``: pool discrepancies in kind."""
    import torch
    from glabc_tpu_torch.samplers.aglmcmc import _NAN_DIS

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(n, generator=g, device=DEVICE).abs()
    x[::100] = _NAN_DIS
    return x


def radix_select_checked(x, k):
    """``radix_select(x, k)`` with every histogram pass and every pick
    checked bit for bit against its plain version on the same inputs (the
    pass's histograms from the same zeros; the state, and the values where
    asked, that the pick writes).  Returns ``(values, checks)``, one
    ``(step, digit bits, same)`` a call."""
    import torch
    from glabc_tpu_torch.ops.kernels.radix_select_kernel import (
        RadixSelect, key_values, radix_select)

    checks = []
    hist, pick = RadixSelect.hist, RadixSelect.pick

    def checked_hist(kern, x, state, shift, bits, out):
        want = kern.plain_hist(x, state, shift, bits, out.clone())
        got = hist(kern, x, state, shift, bits, out)
        checks.append(("hist", bits, bool(torch.equal(got, want))))
        return got

    def checked_pick(kern, h, state, bits, values=None):
        want = kern.plain_pick(h, state.clone(), bits)
        got = pick(kern, h, state, bits, values)
        same = bool(torch.equal(got, want))
        if values is not None:
            same &= bool(torch.equal(values.view(torch.int32),
                                     key_values(want[:2]).view(torch.int32)))
        checks.append(("pick", bits, same))
        return got

    RadixSelect.hist, RadixSelect.pick = checked_hist, checked_pick
    try:
        return radix_select(x, k), checks
    finally:
        RadixSelect.hist, RadixSelect.pick = hist, pick


def radix_select_row():
    """K11 at the mesh cell's shard (RADIX_N values of
    :func:`radix_input`): a select at the ranks of the 0.05 quantile, whose
    prefixes agree, and one at ranks n/10 and n - 1, in different top
    digits; each with the launch counts set to 0 just before it, every
    pass checked against the plain versions
    (:func:`radix_select_checked`), the values against ``torch.sort``'s
    order statistics (as keys), 3 histogram and 3 pick launches.  Then each
    kernel's device time a launch (``torch.profiler``), a plain histogram
    pass's time, the sort-based one-device quantile's, and the bytes bound
    of a pass (4 B a value read once)."""
    import torch
    from glabc_tpu_torch.ops.kernels.radix_select_kernel import (
        DIGITS, RadixSelect, order_keys, radix_select)
    from glabc_tpu_torch.samplers.aglmcmc import quantile, quantile_position

    x = radix_input(RADIX_N, 23)
    n = x.numel()
    xs = torch.sort(x).values
    lo, hi, _, _ = quantile_position(0.05, n, DEVICE)
    selects = {"q0.05": torch.stack([lo, hi]),
               "split": torch.tensor([n // 10, n - 1], device=DEVICE)}
    by_select = {}
    for label, k in selects.items():
        (got, checks), counts = counted(lambda: radix_select_checked(x, k))
        same = len(checks) == 2 * len(DIGITS) and all(c[2] for c in checks)
        exact = bool(torch.equal(order_keys(got), order_keys(xs[k])))
        log(f"[K11] radix select of {n:,} values at ranks "
            f"{k.tolist()} ({label}): every pass's histograms and picks "
            f"{'bitwise' if same else 'DIFFER from'} the plain versions "
            f"({checks}); the values {got.tolist()} "
            f"{'are' if exact else 'are NOT'} torch.sort's; launches "
            f"{counts['radix_select']} + {counts['radix_select_pick']}")
        check(same and exact, f"K11 at ranks {k.tolist()}: passes {checks}, "
              f"values equal to torch.sort's {exact}")
        check(counts == only(radix_select=len(DIGITS),
                             radix_select_pick=len(DIGITS)),
              f"K11 select launches {counts}")
        by_select[label] = counts["radix_select"]
    del xs
    k = selects["q0.05"]
    hist_ms = device_ms(lambda: radix_select(x, k),
                        "radix_select_hist") / len(DIGITS)
    pick_ms = device_ms(lambda: radix_select(x, k),
                        "radix_select_pick") / len(DIGITS)
    select_ms = median_ms(lambda: radix_select(x, k))
    q = torch.tensor(0.05, device=DEVICE)
    sort_ms = median_ms(lambda: quantile(x, q))
    state = torch.zeros(4, dtype=torch.int64, device=DEVICE)
    out = torch.zeros(2, 1 << DIGITS[0], dtype=torch.int64, device=DEVICE)
    plain_ms, _ = timed(lambda: RadixSelect().plain_hist(
        x, state, 32 - DIGITS[0], DIGITS[0], out), 1)
    b = bound_ms(nbytes(x), 0)
    log(f"[K11] radix_select_hist at {n:,} values: {hist_ms:.4f} ms of "
        f"device time a pass (torch.profiler), bound {b[0]:.4f} ms "
        f"({b[1]}: {nbytes(x) / 1e6:.1f} MB a pass), plain "
        f"{plain_ms:.2f} ms a pass; radix_select_pick {pick_ms:.4f} ms; "
        f"the select {select_ms:.4f} ms a call (CUDA events, host "
        f"included) against the sort-based quantile's {sort_ms:.4f} ms")
    return dict(name="radix_select_hist", route="cuda",
                source="glabc_tpu_torch/csrc/radix_select.cu",
                replaces="none (the JAX package's quantile is jnp.sort "
                "under XLA)", launches=len(DIGITS), max_abs_err=0.0,
                ms=hist_ms, plain_ms=plain_ms, bound_ms=b[0],
                bound_by=b[1], library_ms=None, pick_ms=pick_ms,
                launches_by_path=by_select)


def _device_busy_ms(prof):
    """The union of the device intervals (kernels, copies, sets) that
    ``prof`` recorded, in ms, and their number."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, len(spans)


def select_times(fn, reps=10):
    """``fn``'s host time (from the call to its return, the stream idle
    before it), its stream time (CUDA events around it: what an untraced
    span on the device clock reads), and its device busy time and number
    of device operations (``torch.profiler``), in ms a call, medians over
    ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    host, stream = [], []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        host.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        stream.append(e0.elapsed_time(e1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy, ops = _device_busy_ms(prof)
    med = lambda v: sorted(v)[len(v) // 2]
    return med(host), med(stream), busy / reps, ops / reps


def mesh_select(mesh):
    """The mesh epoch's select on ``mesh`` (a one-rank NCCL group) at the
    mesh cell's shard: ``distributed_quantile`` of RADIX_N values of
    :func:`radix_input` and ``distributed_systematic_resample`` of as many
    float64 weights (every 97th 0) onto MESH_SUPPORT points, each with the
    launch counts set to 0 just before it, against the one-device
    ``quantile`` and ``systematic_resample`` bit for bit.  Then the
    anneal (``sharded_hat_eps_update``'s update, the ``glabc.epoch.anneal``
    span's call) and the resample, each by :func:`select_times`: whether
    the host or the device sets their pace.  Returns the launch counts."""
    import torch
    from glabc_tpu_torch.ops.resampling import systematic_resample
    from glabc_tpu_torch.parallel import (distributed_quantile,
                                          distributed_systematic_resample,
                                          sharded_hat_eps_update)
    from glabc_tpu_torch.samplers.aglmcmc import quantile

    x = radix_input(RADIX_N, 29)
    g = torch.Generator(device=DEVICE).manual_seed(31)
    w = torch.rand(RADIX_N, generator=g, dtype=torch.float64, device=DEVICE)
    w[::97] = 0.0
    q = torch.tensor(0.05, device=DEVICE)
    gen = lambda: torch.Generator(device=DEVICE).manual_seed(4)
    got_q, q_counts = counted(lambda: distributed_quantile(x, q, mesh))
    want_q = quantile(x, q)
    got_i, r_counts = counted(lambda: distributed_systematic_resample(
        w, MESH_SUPPORT, mesh, gen(), replicated=True))
    want_i = systematic_resample(w / w.sum(), MESH_SUPPORT, gen())
    same_q = bool(torch.equal(got_q, want_q))
    same_i = bool(torch.equal(got_i, want_i))
    log(f"[sharded] distributed_quantile of {RADIX_N:,} values on one NCCL "
        f"rank: {float(got_q)!r} {'bitwise equal to' if same_q else 'DIFFERS from'}"
        f" quantile's {float(want_q)!r}; launches K11 "
        f"{q_counts['radix_select']} + {q_counts['radix_select_pick']}; "
        f"distributed_systematic_resample onto {MESH_SUPPORT:,} points: "
        f"indices {'bitwise equal to' if same_i else 'DIFFER from'} "
        f"systematic_resample's, no kernel of ours launched")
    check(same_q and q_counts == only(radix_select=3, radix_select_pick=3),
          f"distributed_quantile: equal {same_q}, launches {q_counts}")
    check(same_i and r_counts == only(),
          f"distributed_systematic_resample: equal {same_i}, launches "
          f"{r_counts}")
    anneal = sharded_hat_eps_update(0.8, 0.2, mesh)
    hat = torch.tensor(1.0e6, device=DEVICE)
    rs = gen()
    for name, fn in (("anneal", lambda: anneal(x, hat)),
                     ("resample", lambda: distributed_systematic_resample(
                         w, MESH_SUPPORT, mesh, rs, replicated=True))):
        host, stream, busy, ops = select_times(fn)
        pace = ("pace not measured (the profiler saw no device operation)"
                if ops == 0 else "paced by the "
                + ("host" if host >= busy else "device"))
        log(f"[sharded] the mesh select's {name} at {RADIX_N:,} a rank, one "
            f"NCCL rank: host {host:.3f} ms a call, stream {stream:.3f} ms "
            f"(CUDA events), device busy {busy:.3f} ms in {ops:.0f} device "
            f"operations (torch.profiler): {pace}")
    return {"mesh_select": q_counts}


def divergence(tag, make, launch, share_g, ms):
    """The launch ``launch(kern)`` with every coin global (``make(1.0)``)
    and every coin local (``make(0.0)``) on the same inputs, beside the
    mix of the two at the launch's global share ``share_g`` and the
    launch's own time ``ms``: how much a warp that holds both kinds of
    lane pays above its two moves."""
    pure = {}
    for gf in (1.0, 0.0):
        kern = make(gf)
        pure[gf] = median_ms(lambda: launch(kern))
    mix = share_g * pure[1.0] + (1.0 - share_g) * pure[0.0]
    log(f"[{tag}] divergence: every coin global {pure[1.0]:.3f} ms, every "
        f"coin local {pure[0.0]:.3f} ms; at the global share {share_g:.4f} "
        f"the pure moves' mix is {mix:.3f} ms, the launch {ms:.3f} ms "
        f"({ms / mix:.3f}x)")


def phase_kernels_line(bench, carry3, prob3, paths):
    """``launches`` is each kernel's count on its entry-point path (the
    packed layout: ``run_glmcmc`` at d=2; the unpacked one: ``run_glmcmc``
    at d=3); ``launches_by_path`` gives the count on every path driven."""
    import torch
    from glabc_tpu_torch import MixtureProblem

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
    n = kern.pack * state[0].shape[1] * kern.T
    n_g = float(got[4].global_attempts.sum(dtype=torch.float64))
    ops = transition_ops_mix(2, 5, True, n, n_g)
    ops_both = transition_ops_both(2, 5, True) * n
    b_ms, b_by = bound_ms(moved, ops)
    log(f"[K1] packed d=2 at the main shape: max abs diff {max_abs:.3g} "
        f"(share {share:.3g}); kernel {bench['ms']:.3f} ms, plain "
        f"{plain_ms:.1f} ms; {moved / 1e9:.3f} GB and {ops:.4g} operations "
        f"(global share {n_g / n:.4f}; both moves counted: {ops_both:.4g}, "
        f"bound {bound_ms(moved, ops_both)[0]:.3f} ms) -> bound {b_ms:.3f} "
        f"ms ({b_by})")
    divergence("K1", lambda gf: make_kernel("packed", MixtureProblem(0.05),
                                            kern.T, gf=gf),
               lambda k: k.run(bench["seed"], *state, step0=bench["step0"]),
               n_g / n, bench["ms"])
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
    n = state[0].shape[1] * kern.T
    n_g = float(got[4].global_attempts.sum(dtype=torch.float64))
    ops = transition_ops_mix(3, 5, True, n, n_g)
    ops_both = transition_ops_both(3, 5, True) * n
    b_ms, b_by = bound_ms(moved, ops)
    log(f"[K2] unpacked d=3, {state[0].shape[1]:,} chains x T=256: max abs "
        f"diff {max_abs:.3g} (share {share:.3g}); kernel {ms:.3f} ms, plain "
        f"{plain_ms:.1f} ms; {moved / 1e9:.3f} GB and {ops:.4g} operations "
        f"(global share {n_g / n:.4f}; both moves counted: {ops_both:.4g}, "
        f"bound {bound_ms(moved, ops_both)[0]:.3f} ms) -> bound {b_ms:.3f} "
        f"ms ({b_by})")
    rows.append(dict(
        name="mixture_glmcmc (unpacked layout)", route="cuda",
        source="glabc_tpu_torch/csrc/mixture_glmcmc.cu",
        replaces="glabc_tpu/ops/pallas/mixture_kernel.py:143",
        launches=paths["run_glmcmc_d3"]["unpacked"], max_abs_err=max_abs,
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, launches_by_path=by_path("unpacked")))
    return rows


# ------------------------------------------------ the generic program path
def ma2_sim_ops(T):
    """32-bit operations of one MA(2) simulation of ``T`` steps at the
    least, ``(ops, sfu)``: the Philox blocks of its ``T + 2`` innovations
    (80 each), 5 per uniform, the Box-Muller pairs' multiplies (4 each),
    and per step the recursion (2 multiplies, 2 adds) and the three
    running sums (3 multiplies, 3 adds), then the three scalings; ``sfu``
    counts each pair's log, sqrt, sin and cos."""
    pairs = (T + 3) // 2
    return (80 * -(-2 * pairs // 4) + 5 * 2 * pairs + 4 * pairs + 10 * T
            + 3), 4 * pairs


def ma2_sim_pair_ops(T):
    """One +-fd pair of MA(2) simulations at the least, ``(ops, sfu)``: the
    innovations drawn once (the draws of :func:`ma2_sim_ops`), two
    recursions with their running sums and scalings."""
    pairs = (T + 3) // 2
    draws = 80 * -(-2 * pairs // 4) + 5 * 2 * pairs + 4 * pairs
    return draws + 2 * (10 * T + 3), 4 * pairs


_MA2_KERN = 11                       # the epsilon-kernel: 3 x (sub, mul,
#                                      add) + 2


def ma2_local_ops(T):
    """The MA(2) random-walk move's own work at the least, ``(ops, sfu)``:
    a block of two Box-Muller pairs (80, and 10 + 8 each), theta' (4), a
    simulation, the epsilon-kernel, the triangle test (6) and the MH ratio
    and selects (10); ``sfu`` counts the pairs' and the simulation's (the
    MH test's log u is the caller's)."""
    sim, sim_sfu = ma2_sim_ops(T)
    return (80 + 2 * (10 + 8) + 4 + sim + _MA2_KERN + 6 + 10,
            2 * 4 + sim_sfu)


def ma2_step_ops(T, B, kind, n_grad=0, pair=True):
    """32-bit operations of one chain-step of the generic kernels on the
    MA(2) program at the least, ``(ops, sfu)``.  ``kind``: 'global' (B
    candidates: a uniform block, the box draw, a simulation, the
    epsilon-kernel, the triangle test, the Gumbel score and the selects),
    'local' (K8's random walk, :func:`ma2_local_ops`, and its log u),
    'mala' (K9: the drift pair, the proposal's simulation, d n_grad
    gradient replicates, each a +-fd pair (:func:`ma2_sim_pair_ops`; with
    ``pair=False`` two whole simulations, the count before the pair was
    simulated in one pass) with its two discrepancies and running sums, the
    synthetic likelihood and the MH test).  Each step adds the scalar
    blocks, the coin and the counters."""
    sim, sim_sfu = ma2_sim_ops(T)
    ops, sfu = 80 * -(-(B + 3) // 4) + 5 * (B + 3) + 20, 0
    kern = _MA2_KERN
    if kind == "global":
        ops += B * (80 + 10 + 4 + sim + kern + 6 + 4 + 10)
        sfu += B * (sim_sfu + 2) + 2
    elif kind == "local":
        o, s = ma2_local_ops(T)
        ops, sfu = ops + o, sfu + s + 1
    else:
        rep, rep_sfu = ((2 * sim, 2 * sim_sfu) if not pair
                        else ma2_sim_pair_ops(T))
        grad = 2 * n_grad * (rep + 2 * (kern + 4)) + 2 * 2 * 20
        ops += 80 + 2 * 18 + 8 + sim + kern + grad + 40
        sfu += 2 * 4 + sim_sfu + 2 * n_grad * rep_sfu + 4 * n_grad + 8
    return ops, sfu


def _ma2_setup():
    import torch
    from glabc_tpu_torch import DiagGaussian, MA2Problem, Uniform

    prob = MA2Problem()           # num_draws=100, epsilon 0.2, JAX's y_obs
    box = Uniform(torch.tensor([-2.0, -1.0], device=DEVICE),
                  torch.tensor([2.0, 1.0], device=DEVICE))
    lp = DiagGaussian.create(2, 0.0, math.log(0.1))
    return prob, box, lp


def _inside(ch):
    import numpy as np

    return bool(np.all((ch[..., 1] < 1.0) & (ch[..., 1] > ch[..., 0] - 1.0)
                       & (ch[..., 1] > -ch[..., 0] - 1.0)))


def ma2_run(tmp, seed, method, chains):
    """MA(2) GLMCMC at gf=0.8, B=5: ``fused`` through run_fused_program
    (K8), ``scan`` the plain run_glmcmc (uniform box importance proposal,
    N(0, 0.1^2) random walk).  Returns the result."""
    import numpy as np
    import torch
    from glabc_tpu_torch import MCMCRunner, run_fused_program

    prob, box, lp = _ma2_setup()
    if method == "fused":
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        return run_fused_program(prob, prob.tile_program(lp_scale=0.1), g,
                                 PROG_ITERS, np.zeros(2),
                                 global_frequency=0.8, batch_size=5,
                                 num_chains=chains, steps_per_call=256)
    runner = MCMCRunner(prob, output_dir=tmp, seed=seed, num_chains=chains,
                        verbose=False)
    runner.run_glmcmc(PROG_ITERS, np.zeros(2), None, 0.8, lp, box, 5,
                      output_file=None, method="scan")
    return runner.last_result


def ma2_moments(res, burn=256):
    """Posterior mean and sd per dim after ``burn``, in float64."""
    import numpy as np

    ch = res.thetas[:, burn:].reshape(-1, 2)
    mean = ch.mean(0, dtype=np.float64)
    sd = np.sqrt((ch.astype(np.float64) ** 2).mean(0) - mean ** 2)
    return mean, sd


def mala_prog_run(tmp, seed, method, chains, iters, output_file=None, **kw):
    """MA(2) GLMALA through MCMCRunner.run_glmala at gf=0.8, B=5, tau=0.1,
    num_grad=100, fd 0.1: ``fused`` with the program (K9, T=16), ``scan``
    the plain path with the uniform box importance proposal."""
    import numpy as np
    from glabc_tpu_torch import MCMCRunner

    prob, box, _ = _ma2_setup()
    runner = MCMCRunner(prob, output_dir=tmp, seed=seed, num_chains=chains,
                        verbose=False)
    if method == "fused":
        kw.update(tile_program=prob.tile_program(), steps_per_call=16)
    ch = runner.run_glmala(iters, np.zeros(2), None, 0.8,
                           None if method == "fused" else box, 5, 0.1, 100,
                           output_file=output_file, method=method, **kw)
    return runner, ch


def agl_prog_run(tmp, seed, method, chains, output_file=None):
    """MA(2) AGLMCMC at gf=0.5 (examples/ma2.py): B=5, step 200, shared
    1,024-point KDE, initial iSIR N(0, 0.5^2 I), random walk 0.1:
    ``fused`` the mixed kernel with the program's move, ``scan`` the plain
    path with shared adaptation."""
    import numpy as np
    from glabc_tpu_torch import DiagGaussian, MCMCRunner

    prob, _, lp = _ma2_setup()
    runner = MCMCRunner(prob, output_dir=tmp, seed=seed, num_chains=chains,
                        verbose=False)
    kw = dict(output_file=output_file, method=method, shared_support=1024)
    if method == "fused":
        kw.update(tile_program=prob.tile_program(lp_scale=0.1))
    else:
        kw.update(shared_adaptation=True, redraw_chunk=512)
    ch = runner.run_aglmcmc(AGL_PROG_ITERS, np.zeros(2), None, 0.5, lp,
                            DiagGaussian.create(2, 0.0, math.log(0.5)), 5,
                            200, 0.8, 0.2, **kw)
    return runner, ch


def phase_generic_kernels_vs_plain():
    """K8 and K9 on both shipped programs (both algorithms, both coin
    modes) and K5's program variant on MA(2), at small shapes, each against
    its plain version on one Philox stream."""
    import numpy as np
    import torch
    from glabc_tpu_torch import MixtureProblem
    from glabc_tpu_torch.models.kde import KernelDensity
    from glabc_tpu_torch.ops.kernels import (GenericFusedGLMALA,
                                             GenericFusedGLMCMC,
                                             PoolISIRMixed,
                                             mixture_tile_program,
                                             resident_from_kde)

    prob_m, (prob_a, _, _) = MixtureProblem(0.05), _ma2_setup()
    programs = {"mixture": (prob_m, mixture_tile_program(prob_m)),
                "ma2": (prob_a, prob_a.tile_program())}

    def state(name, C, seed):
        prob, prog = programs[name]
        g = torch.Generator(device=DEVICE).manual_seed(seed)
        scale = 1.3 if name == "mixture" else 0.3
        th = (torch.rand((2, C), generator=g, device=DEVICE) - 0.5) * scale
        y = prob.simulate(th.T.contiguous(), g).T.contiguous()
        logk = prob.log_kernel_of_y(y.T).contiguous()
        return prob, prog, th.contiguous(), y, logk, g

    def report(tag, label, got, want, C):
        max_abs, share = _chain_share(got, want, C)
        same, _ = _bitwise(got, want)
        log(f"[{tag}-vs-plain] {label}, bitwise {same}, max abs diff "
            f"{max_abs:.3g}, share of chains differing by > {CHAIN_TOL:g}: "
            f"{share:.3g}")
        check(share <= MAX_DIFF_SHARE, f"{tag} {label}: {share:.3%} of "
              "chains differ from the plain version")

    C, T = SMALL_CHAINS, 32
    for name in programs:
        for algorithm in ("glmcmc", "global"):
            prob, prog, th, y, logk, _ = state(name, C, 1)
            kern = GenericFusedGLMCMC(prog, global_frequency=0.8,
                                      batch_size=5, steps_per_call=T,
                                      algorithm=algorithm)
            got = kern.run(3, th, y, logk, step0=512)
            want = kern.plain(3, th, y, logk, step0=512)
            torch.cuda.synchronize()
            report("K8", f"{name} {algorithm}: {C:,} chains x {T} steps, "
                   f"moves {float(got[4].accepted.sum()):.0f}",
                   [*got[:4], *got[4]], [*want[:4], *want[4]], C)
    C, T = SMALL_CHAINS // 4, 8
    coins = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.int32)
    for name in programs:
        for mode in ("shared", "per_chain"):
            prob, prog, th, y, logk, g = state(name, C, 2)
            grad = torch.randn((2, C), generator=g, device=DEVICE)
            kern = GenericFusedGLMALA(prog, epsilon=prob.epsilon,
                                      global_frequency=0.8, batch_size=5,
                                      tau=0.1, num_grad=20,
                                      steps_per_call=T, coin_mode=mode)
            got = kern.run(5, th, y, logk, grad, coins, step0=64)
            want = kern.plain(5, th, y, logk, grad, coins, step0=64)
            torch.cuda.synchronize()
            report("K9", f"{name} {mode}: {C:,} chains x {T} steps, local "
                   f"accepts {float(got[5][3].sum()):.0f}",
                   [*got[:5], *got[5]], [*want[:5], *want[5]], C)
    C, T, B = SMALL_CHAINS, 32, 5
    prob, prog, th, y, logk, g = state("ma2", C, 3)
    ptheta = ((torch.rand((T, B, 2, C), generator=g, device=DEVICE) - 0.5)
              * 0.6)
    px = prob.simulate(ptheta.permute(0, 1, 3, 2).contiguous(),
                       g).permute(0, 1, 3, 2).contiguous()
    plogk = prob.log_kernel_of_y(px.permute(0, 1, 3, 2)).contiguous()
    plogw = (plogk + torch.randn(plogk.shape, generator=g,
                                 device=DEVICE)).contiguous()
    res = resident_from_kde(KernelDensity.fit(
        torch.randn((1024, 2), generator=g, device=DEVICE) * 0.3))
    kern = PoolISIRMixed(2, program=prog, global_frequency=0.5,
                         batch_size=B, steps_per_call=T)
    a = (res, ptheta, px, plogw, plogk, th, y, logk)
    got = kern.run(7, *a, step0=2000)
    want = kern.plain(7, *a, step0=2000)
    torch.cuda.synchronize()
    report("K5-program", f"ma2 S=1024 gf=0.5: {C:,} chains x {T} steps, "
           f"global share {float(got[3].mean()) / T:.4f}, local accepts "
           f"{float(got[5].sum()):.0f}", got, want, C)
    check(_bitwise(got, want)[0], "pool_isir_mixed (program) is not bitwise "
          "equal to its plain version")


def phase_generic(tmp):
    """The generic program path on MA(2) at the JAX package's full width,
    through its entry points, each beside the port's plain path on the
    card: run_fused_program (K8; and the Mixture program against the
    Mixture bands), MCMCRunner.run_glmala with tile_program= (K9) and
    MCMCRunner.run_aglmcmc at gf=0.5 with tile_program= (K5's program
    variant)."""
    import numpy as np
    import torch
    from glabc_tpu_torch import (MixtureProblem, mixture_tile_program,
                                 run_fused_program)

    paths, insts = {}, {}

    path = lambda name, fn, want, prefer=None: instrumented(
        paths, insts, name, fn, want, prefer)
    steps = PROG_ITERS - 1

    # ---- K8: GLMCMC over the MA(2) program, beside the plain run_glmcmc
    secs, res, inst = path(
        "run_fused_program_ma2",
        lambda: ma2_run(tmp, 0, "fused", PROG_CHAINS),
        only(generic_glmcmc=steps // 256))
    ch = res.thetas
    check(ch.shape == (PROG_CHAINS, PROG_ITERS, 2), f"MA(2) chains "
          f"{ch.shape}")
    check(bool(np.isfinite(ch).all()) and _inside(ch[:, 1:]),
          "MA(2) GLMCMC: a state outside the prior triangle")
    c = res.counts
    check(bool(np.all(c.global_attempts + c.local_attempts == steps)),
          "MA(2) GLMCMC: move counts do not sum to the steps run")
    share = float(c.global_attempts.sum()) / (PROG_CHAINS * steps)
    mean, sd = ma2_moments(res)
    g, l_ = rates(res)
    log(f"[prog] MA(2) run_fused_program: {PROG_CHAINS:,} chains x "
        f"{PROG_ITERS}, {inst.split(secs, ['generic_glmcmc'])}")
    log(f"[prog] MA(2) fused: global share {share:.5f}, after step 256 "
        f"mean {mean.round(4).tolist()}, sd {sd.round(4).tolist()}, "
        f"acceptance global {g:.5f} / local {l_:.5f}")
    del ch, res
    check(abs(share - 0.8) <= 0.01, f"MA(2) GLMCMC: global share {share}")
    secs_s, res_s, _ = path(
        "run_glmcmc_ma2_scan",
        lambda: ma2_run(tmp, 1, "scan", PROG_SCAN_CHAINS), only())
    mean_s, sd_s = ma2_moments(res_s)
    check(_inside(res_s.thetas[:, 1:]), "MA(2) plain GLMCMC: a state "
          "outside the triangle")
    log(f"[prog] MA(2) plain run_glmcmc on the card: {PROG_SCAN_CHAINS:,} "
        f"chains, wall {secs_s:.2f} s: mean {mean_s.round(4).tolist()}, sd "
        f"{sd_s.round(4).tolist()}, acceptance global / local "
        f"{' / '.join(f'{r:.5f}' for r in rates(res_s))} (limits +- "
        f"{MA2_MEAN_TOL} mean, +- {MA2_SD_TOL} sd)")
    check(np.all(np.abs(mean - mean_s) <= MA2_MEAN_TOL), "MA(2) GLMCMC: "
          "the fused and the plain path's posterior means differ")
    check(np.all(np.abs(sd - sd_s) <= MA2_SD_TOL), "MA(2) GLMCMC: the "
          "fused and the plain path's posterior sds differ")

    prob_m = MixtureProblem(0.05)
    gm = torch.Generator(device=DEVICE).manual_seed(2)
    secs_m, res_m, inst_m = path(
        "run_fused_program_mixture", lambda: run_fused_program(
            prob_m, mixture_tile_program(prob_m, lp_scale=0.35), gm,
            PROG_ITERS, np.zeros(2), global_frequency=0.9, batch_size=5,
            num_chains=PROG_CHAINS, steps_per_call=256),
        only(generic_glmcmc=steps // 256))
    _bands("GLMCMC (fused, Mixture tile program)", res_m.thetas, res_m,
           secs_m, move_band=(0.008, 0.012), gf=0.9)
    log(f"[prog] Mixture program: {inst_m.split(secs_m, ['generic_glmcmc'])}")
    del res_m

    # ---- K9: GLMALA over the MA(2) program; its kernel row takes the
    # launch whose shared coins gave the number of local steps nearest the
    # expected (1 - gf) T (the more of them on ties)
    n_mala = (MALA_PROG_ITERS - 1) // 16
    secs, (runner, ch), inst = path(
        "run_glmala_prog", lambda: mala_prog_run(
            tmp, 0, "fused", MALA_PROG_CHAINS, MALA_PROG_ITERS,
            "glmala_prog.csv"),
        only(generic_glmala=n_mala), {"generic_glmala": typical_local})
    _csv(runner, "glmala_prog.csv", ch)
    check(bool(np.isfinite(ch).all()) and _inside(ch[:, 1:]),
          "MA(2) GLMALA: a state outside the triangle")
    mean_f, _ = ma2_moments(runner.last_result, 64)
    g_f, l_f = rates(runner.last_result)
    log(f"[prog] MA(2) GLMALA fused, shared coin: {MALA_PROG_CHAINS:,} "
        f"chains x {MALA_PROG_ITERS}, "
        f"{inst.split(secs, ['generic_glmala'])}")
    del ch
    secs_pc, (runner_pc, ch_pc), inst_pc = path(
        "run_glmala_prog_per_chain", lambda: mala_prog_run(
            tmp, 1, "fused", MALA_PROG_PC_CHAINS, MALA_PROG_PC_ITERS,
            coin_mode="per_chain"),
        only(generic_glmala=(MALA_PROG_PC_ITERS - 1) // 16))
    check(bool(np.isfinite(ch_pc).all()) and _inside(ch_pc[:, 1:]),
          "MA(2) GLMALA per-chain: a state outside the triangle")
    g_pc, l_pc = rates(runner_pc.last_result)
    log(f"[prog] MA(2) GLMALA fused, per-chain coin: "
        f"{MALA_PROG_PC_CHAINS:,} chains x {MALA_PROG_PC_ITERS}, "
        f"{inst_pc.split(secs_pc, ['generic_glmala'])}")
    del ch_pc
    secs_s, (scan, ch_s), _ = path(
        "run_glmala_prog_scan", lambda: mala_prog_run(
            tmp, 2, "scan", MALA_PROG_SCAN_CHAINS, MALA_PROG_ITERS),
        only())
    mean_s, _ = ma2_moments(scan.last_result, 64)
    g_s, l_s = rates(scan.last_result)
    post = ch_s[:, 64:].reshape(-1, 2).astype(np.float64)
    log(f"[prog] MA(2) GLMALA plain on the card: {MALA_PROG_SCAN_CHAINS:,} "
        f"chains, wall {secs_s:.2f} s, mean {mean_s.round(4).tolist()}, var "
        f"{post.var(0).round(4).tolist()}")
    log(f"[prog] MA(2) GLMALA acceptance global / local: fused shared "
        f"{g_f:.5f} / {l_f:.5f}, fused per-chain {g_pc:.5f} / {l_pc:.5f}, "
        f"plain {g_s:.5f} / {l_s:.5f} (limits +- {MALA_PROG_GACC_TOL} "
        f"global, +- {MALA_PROG_LACC_TOL} per-chain local); mean after step "
        f"64 fused {mean_f.round(4).tolist()} (limit +- "
        f"{MALA_PROG_MEAN_TOL}); the JAX TPU sweep's mean [0.420, 0.040] "
        f"and var [0.046, 0.057] (its tau and num_grad not recorded) as a "
        f"cross-check only")
    del ch_s
    for what, got in (("shared", g_f), ("per-chain", g_pc)):
        check(abs(got - g_s) <= MALA_PROG_GACC_TOL, f"MA(2) GLMALA {what}: "
              f"global acceptance {got} vs the plain path's {g_s}")
    check(abs(l_pc - l_s) <= MALA_PROG_LACC_TOL, f"MA(2) GLMALA per-chain: "
          f"local acceptance {l_pc} vs the plain path's {l_s}")
    check(np.all(np.abs(mean_f - mean_s) <= MALA_PROG_MEAN_TOL),
          "MA(2) GLMALA: the fused and the plain path's means differ")

    # ---- K5 program variant: AGLMCMC at gf=0.5
    steps = AGL_PROG_ITERS - 1
    secs, (runner, ch), inst = path(
        "run_aglmcmc_prog", lambda: agl_prog_run(
            tmp, 0, "fused", AGL_PROG_CHAINS, "aglmcmc_prog.csv"),
        only(pool_isir_mixed_prog=steps // 400,
             kde_logprob=shared_k4(AGL_PROG_CHAINS, steps)))
    _csv(runner, "aglmcmc_prog.csv", ch)
    check(bool(np.isfinite(ch).all()) and _inside(ch[:, 1:]),
          "MA(2) AGLMCMC: a state outside the triangle")
    res = runner.last_result
    share = float(res.counts.global_attempts.sum()) / (AGL_PROG_CHAINS
                                                       * steps)
    eps_f, g_f, l_f = mixed_stats(res)
    log(f"[prog] MA(2) AGLMCMC gf=0.5 fused: {AGL_PROG_CHAINS:,} chains x "
        f"{AGL_PROG_ITERS}, {inst.split(secs, ['pool_isir_mixed_prog'])}")
    del ch
    secs_s, (scan, _), _ = path(
        "run_aglmcmc_prog_scan", lambda: agl_prog_run(
            tmp, 1, "scan", AGL_PROG_SCAN_CHAINS),
        only(kde_logprob=shared_k4(AGL_PROG_SCAN_CHAINS, steps)))
    eps_s, g_s, l_s = mixed_stats(scan.last_result)
    log(f"[prog] MA(2) AGLMCMC gf=0.5: coin share {share:.5f}; final "
        f"hat_eps fused {eps_f:.4f} / plain {eps_s:.4f} (limit +- "
        f"{AGL_PROG_EPS_TOL}); acceptance global {g_f:.5f} / {g_s:.5f} "
        f"(limit +- {AGL_PROG_GACC_TOL}), local {l_f:.5f} / {l_s:.5f} "
        f"(limit +- {AGL_PROG_LACC_TOL}); plain path {AGL_PROG_SCAN_CHAINS:,}"
        f" chains, wall {secs_s:.2f} s")
    check(abs(share - 0.5) <= 0.01, f"MA(2) AGLMCMC: coin share {share}")
    check(abs(eps_f - eps_s) <= AGL_PROG_EPS_TOL, "MA(2) AGLMCMC: final "
          "hat_eps differs from the plain path's")
    check(abs(g_f - g_s) <= AGL_PROG_GACC_TOL, "MA(2) AGLMCMC: global "
          "acceptance differs from the plain path's")
    check(abs(l_f - l_s) <= AGL_PROG_LACC_TOL, "MA(2) AGLMCMC: local "
          "acceptance differs from the plain path's")
    log("[launches] per path, counts set to 0 just before it: "
        + "; ".join(f"{k} {v}" for k, v in paths.items()))
    return paths, insts


def k9_bound(kern, a, outs, n_local):
    """K9's bound for the launch ``kern.run(*a)`` with outputs ``outs`` and
    ``n_local`` MALA chain-steps among its C x T, from the MA(2) counts:
    ``(bound, the bound with two whole simulations per +-fd pair, the
    work as text)``."""
    C, T, n = a[1].shape[1], kern.T, int(kern.p.params[4])
    shared = kern.coin_mode == "shared"
    moved = nbytes(*a[1:5], *((a[5],) if shared else ()), *outs)
    n_g = C * T - n_local
    og, sg = ma2_step_ops(n, kern.B, "global")
    out = []
    for pair in (True, False):
        om, sm = ma2_step_ops(n, kern.B, "mala", kern.cfg.n_grad, pair)
        ops, sfu = n_local * om + n_g * og, n_local * sm + n_g * sg
        out.append((bound_ms(moved, ops, sfu), ops, sfu))
    (b, ops, sfu), (b_old, _, _) = out
    return b, b_old, (f"{moved / 1e9:.4f} GB, {ops:.4g} operations and "
                      f"{sfu:.4g} special-function operations")


def generic_kernel_rows(insts, paths):
    """K8, K9 and K5's program variant at their main-path shapes (the
    arguments of their last launch on their MA(2) entry path; for K9 the
    launch whose shared coins gave the typical number of local steps):
    time per launch, the plain version's time and agreement, bytes,
    operations (of the moves this launch's coins picked) and bound.  No
    single PyTorch call computes these functions: no library time."""
    import torch
    from glabc_tpu_torch.ops.kernels import (GenericFusedGLMALA,
                                             GenericFusedGLMCMC)

    rows = []

    def row(name, source, replaces, key, main, max_abs, ms, plain_ms, b):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=paths[main][key],
                    max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                    bound_ms=b[0], bound_by=b[1], library_ms=None,
                    launches_by_path={k: v[key] for k, v in paths.items()})

    def measure(key, main, flat):
        kern, a, k = insts[main].last[key]
        ms = median_ms(lambda: kern.run(*a, **k))
        got = kern.run(*a, **k)
        plain_ms, want = timed(lambda: kern.plain(*a, **k), 1)
        outs, refs = flat(got), flat(want)
        return kern, a, got, ms, plain_ms, outs, refs

    # K8
    kern, a, got, ms, plain_ms, outs, refs = measure(
        "generic_glmcmc", "run_fused_program_ma2",
        lambda r: [*r[:4], *r[4]])
    kw8 = insts["run_fused_program_ma2"].last["generic_glmcmc"][2]
    C, T, n = a[1].shape[1], kern.T, kern.p.params[4]
    max_abs, share = _chain_share(outs, refs, C)
    check(share <= MAX_DIFF_SHARE, f"generic_glmcmc at the main shape: "
          f"{share:.3%} of chains differ")
    n_g = float(got[4].global_attempts.sum())
    og, sg = ma2_step_ops(int(n), kern.B, "global")
    ol, sl = ma2_step_ops(int(n), kern.B, "local")
    ops, sfu = n_g * og + (C * T - n_g) * ol, n_g * sg + (C * T - n_g) * sl
    moved = nbytes(*a[1:4], *outs)
    b = bound_ms(moved, ops, sfu)
    log(f"[K8] generic_glmcmc (MA(2)) at the main shape, {C:,} chains x "
        f"T={T}, B={kern.B}, global share {n_g / (C * T):.4f}: max abs diff "
        f"{max_abs:.3g}, share of chains differing {share:.3g}; kernel "
        f"{ms:.3f} ms, plain {plain_ms:.1f} ms; {moved / 1e9:.4f} GB, "
        f"{ops:.4g} operations and {sfu:.4g} special-function operations "
        f"-> bound {b[0]:.4f} ms ({b[1]})")
    # warp divergence: the same launch with every coin global (B
    # simulations per step) and every coin local (one), beside the mix
    divergence("K8", lambda gf: GenericFusedGLMCMC(
        kern.p, global_frequency=gf, batch_size=kern.B, steps_per_call=T,
        block_chains=kern.C_blk, collect_history=kern.collect_history,
        algorithm=kern.algorithm), lambda k: k.run(*a, **kw8),
        n_g / (C * T), ms)
    rows.append(row("generic_glmcmc (MA(2) program)",
                    "glabc_tpu_torch/csrc/generic_glmcmc.cu",
                    "glabc_tpu/ops/pallas/generic_kernel.py:186",
                    "generic_glmcmc", "run_fused_program_ma2", max_abs, ms,
                    plain_ms, b))
    del got, outs, refs

    # K9
    kern, a, got, ms, plain_ms, outs, refs = measure(
        "generic_glmala", "run_glmala_prog", lambda r: [*r[:5], *r[5]])
    C, T, n = a[1].shape[1], kern.T, kern.p.params[4]
    max_abs, share = _chain_share(outs, refs, C)
    check(share <= MAX_DIFF_SHARE, f"generic_glmala at the main shape: "
          f"{share:.3%} of chains differ")
    n_local = int(T - int(a[5].sum()))
    b, b_old, work = k9_bound(kern, a, outs, C * n_local)
    n_run = paths["run_glmala_prog"]["generic_glmala"]
    mean_ms = insts["run_glmala_prog"].kernel_ms("generic_glmala") / n_run
    log(f"[K9] generic_glmala (MA(2)) at the main shape, {C:,} chains x "
        f"T={T} ({n_local} local steps, the launch nearest the expected "
        f"{(1.0 - kern.cfg.gf) * T:.1f}), num_grad={kern.cfg.n_grad}: max "
        f"abs diff {max_abs:.3g}, share of chains differing {share:.3g}; "
        f"kernel {ms:.3f} ms (the entry run's {n_run} launches: "
        f"{mean_ms:.3f} ms each), plain {plain_ms:.1f} ms; {work} "
        f"-> bound {b[0]:.4f} ms ({b[1]}; two whole simulations per +-fd "
        f"pair: {b_old[0]:.4f} ms)")
    rows.append(row("generic_glmala (MA(2) program)",
                    "glabc_tpu_torch/csrc/generic_glmala.cu",
                    "glabc_tpu/ops/pallas/generic_glmala_kernel.py:109",
                    "generic_glmala", "run_glmala_prog", max_abs, ms,
                    plain_ms, b))
    del got, outs, refs

    # K9 with the per-chain coin: the last launch of its entry run
    main = "run_glmala_prog_per_chain"
    kern, a, got, ms, plain_ms, outs, refs = measure(
        "generic_glmala", main, lambda r: [*r[:5], *r[5]])
    C, T = a[1].shape[1], kern.T
    max_abs, share = _chain_share(outs, refs, C)
    check(share <= MAX_DIFF_SHARE, f"generic_glmala per-chain at the main "
          f"shape: {share:.3%} of chains differ")
    n_g = float(got[5][1].sum(dtype=torch.float64))
    b, b_old, work = k9_bound(kern, a, outs, C * T - n_g)
    kw = insts[main].last["generic_glmala"][2]
    n_run = paths[main]["generic_glmala"]
    mean_ms = insts[main].kernel_ms("generic_glmala") / n_run
    log(f"[K9] generic_glmala (MA(2)), per-chain coin, {C:,} chains x "
        f"T={T}, global share {n_g / (C * T):.4f}: max abs diff "
        f"{max_abs:.3g}, share of chains differing {share:.3g}; kernel "
        f"{ms:.3f} ms (the entry run's {n_run} launches: {mean_ms:.3f} ms "
        f"each), plain {plain_ms:.1f} ms; {work} -> bound {b[0]:.4f} ms "
        f"({b[1]}; two whole simulations per +-fd pair: {b_old[0]:.4f} ms)")
    divergence("K9", lambda gf: GenericFusedGLMALA(
        kern.p, epsilon=_ma2_setup()[0].epsilon, global_frequency=gf,
        batch_size=kern.B, tau=kern.cfg.tau, num_grad=kern.cfg.n_grad,
        fd_step=kern.cfg.fd, steps_per_call=T, block_chains=kern.C_blk,
        collect_history=kern.collect_history, coin_mode="per_chain"),
        lambda k: k.run(*a, **kw), n_g / (C * T), ms)
    rows.append(row("generic_glmala (MA(2) program, per-chain coin)",
                    "glabc_tpu_torch/csrc/generic_glmala.cu",
                    "glabc_tpu/ops/pallas/generic_glmala_kernel.py:109",
                    "generic_glmala", main, max_abs, ms, plain_ms, b))
    del got, outs, refs

    # K5, program variant
    kern, a, got, ms, plain_ms, outs, refs = measure(
        "pool_isir_mixed_prog", "run_aglmcmc_prog", list)
    T, B, d, C = a[2].shape
    S = a[1].pre.shape[0]
    max_abs, share = _chain_share(outs, refs, C)
    same, _ = _bitwise(outs, refs)
    check(share <= MAX_DIFF_SHARE, f"pool_isir_mixed (program) at the main "
          f"shape: {share:.3%} of chains differ")
    check(same, "pool_isir_mixed (program) at the main shape is not bitwise "
          "equal to its plain version")
    o5, s5 = mixed_isir_ops(d, B, S)
    ol, sl = ma2_local_ops(int(kern.program.params[4]))
    moved = nbytes(*a[1], *a[2:9], *(x for x in outs if x is not None))
    b = k5_bound("K5-program", a, got, o5 + ol, s5 + sl, moved)
    log(f"[K5-program] pool_isir_mixed (MA(2) program) at the main shape, "
        f"{C:,} chains x T={T}, B={B}, S={S}, (threads a block, chains a "
        f"warp) {kern._geometry(C, a[6].device)}: bitwise {same}, "
        f"max abs diff {max_abs:.3g}, share of chains differing "
        f"{share:.3g}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; "
        f"{moved / 1e9:.4f} GB -> bound {b[0]:.3f} ms ({b[1]})")
    rows.append(row("pool_isir_mixed (MA(2) program)",
                    "glabc_tpu_torch/csrc/pool_isir_mixed.cu",
                    "glabc_tpu/ops/pallas/pool_isir_mixed_kernel.py:213",
                    "pool_isir_mixed_prog", "run_aglmcmc_prog", max_abs, ms,
                    plain_ms, b))
    return rows


# ------------------------------------- the chain offset and the mesh (M12)
SPLIT_CHAINS, SPLIT_T = 4096, 32   # the split-launch check's shape
SPLIT_RAGGED = 3000                # halves of 1,500: no multiple of a warp


def split_cases(device, C, T, seed=0):
    """Every kernel that draws randomness, at ``C`` chains x ``T`` steps, as
    ``(name, run)``: ``run(lo, hi, c0)`` launches it (its plain version for
    CPU tensors) on chains ``lo .. hi - 1`` of one set of inputs, with
    ``chain0 = c0`` and the range packed on its own, and returns every
    output with chains on the last axis.  A chain's streams are keyed by
    its global index, so the whole range and its two halves must join to
    the same bits (K1 packed, K2, K3, K5 with both local moves, K6 and K9
    with both coins, K8).  ``C`` must be a multiple of 8."""
    import numpy as np
    import torch
    from glabc_tpu_torch import (HighDimMixtureProblem, MA2Problem,
                                 MixtureProblem, mixture_tile_program)
    from glabc_tpu_torch.ops.kernels import (FusedMixtureGLMALA,
                                             FusedMixtureGLMCMC,
                                             GenericFusedGLMALA,
                                             GenericFusedGLMCMC,
                                             PackedMixtureGLMCMC, PoolISIR,
                                             PoolISIRMixed,
                                             resident_from_gaussian)

    g = torch.Generator(device=device).manual_seed(seed)
    f = dict(generator=g, device=device)
    cut = lambda xs, lo, hi: [x[..., lo:hi].contiguous() for x in xs]

    def mixture_state(prob, d, scale=1.3):
        th = (torch.randn((d, C), **f) * scale).contiguous()
        y = prob.simulate(th.T.contiguous(), g).T.contiguous()
        return th, y, prob.log_kernel_of_y(y.T).contiguous()

    def flat(out):
        return [x for o in out for x in (o if isinstance(o, (list, tuple))
                                          else (o,)) if x is not None]

    cases = []
    p2, p3, ma2 = MixtureProblem(0.05), HighDimMixtureProblem(3), MA2Problem()
    s2, s3 = mixture_state(p2, 2), mixture_state(p3, 3)
    grad = torch.randn((2, C), **f)
    mix = dict(epsilon=p2.epsilon, sigma=p2._noise_std)

    def mixture_case(kern, prob, state):
        groups = getattr(kern, "pack", 1)

        def run(lo, hi, c0):
            th, y, lk = cut(state, lo, hi)
            to = lambda x: kern.from_chains(x.T.contiguous(), groups)
            out = kern.run(3, to(th), to(y),
                           kern.from_chains(lk, groups, "logk"), step0=T,
                           chain0=c0)
            back = lambda x: kern.to_chains(x, groups).T
            aux = lambda x: kern.to_chains(x, groups, aux=True)
            return [back(out[0]), back(out[1]), aux(out[2]),
                    torch.stack([back(h) for h in out[3]]),
                    *(aux(s) for s in out[4])]
        return run

    cases.append(("K1 mixture_glmcmc (packed)", mixture_case(
        PackedMixtureGLMCMC(2, p2.y_obs.numpy(), steps_per_call=T, **mix),
        p2, s2)))
    cases.append(("K2 mixture_glmcmc (unpacked, d=3)", mixture_case(
        FusedMixtureGLMCMC(3, p3.y_obs.numpy(), epsilon=p3.epsilon,
                           sigma=p3._noise_std, steps_per_call=T), p3, s3)))

    B = 5
    ptheta = torch.randn((T, B, 2, C), **f)
    plogw = torch.randn((T, B, C), **f) * 3.0 - 4.0
    plogw = torch.where(torch.rand((T, B, C), **f) < 0.2,
                        torch.full_like(plogw, -math.inf), plogw)
    k3 = PoolISIR(2, batch_size=B, steps_per_call=T)
    logw = torch.randn((C,), **f) - 4.0
    cases.append(("K3 pool_isir", lambda lo, hi, c0: list(k3.run(
        5, *cut((ptheta, plogw, s2[0], logw), lo, hi), step0=2 * T,
        chain0=c0))))

    res = resident_from_gaussian(np.zeros(2), np.full(2, 1.3), device=device)
    px = (ptheta.abs() + 0.2 * torch.randn(ptheta.shape, **f)).contiguous()
    plogk = torch.randn((T, B, C), **f) - 1.0
    k5 = PoolISIRMixed(2, p2.y_obs.numpy(), global_frequency=0.5,
                       batch_size=B, steps_per_call=T, **mix)
    cases.append(("K5 pool_isir_mixed (Mixture move)",
                  lambda lo, hi, c0: list(k5.run(
                      7, res, *cut((ptheta, px, plogw, plogk, *s2), lo, hi),
                      step0=3 * T, chain0=c0))))

    m_th = ((torch.rand((2, C), **f) - 0.5) * 0.3).contiguous()
    m_y = ma2.simulate(m_th.T.contiguous(), g).T.contiguous()
    m_lk = ma2.log_kernel_of_y(m_y.T).contiguous()
    m_pth = ((torch.rand((T, B, 2, C), **f) - 0.5) * 0.6).contiguous()
    m_px = ma2.simulate(m_pth.permute(0, 1, 3, 2).contiguous(),
                        g).permute(0, 1, 3, 2).contiguous()
    m_plk = ma2.log_kernel_of_y(m_px.permute(0, 1, 3, 2)).contiguous()
    m_plw = (m_plk + torch.randn(m_plk.shape, **f)).contiguous()
    m_res = resident_from_gaussian(np.zeros(2), np.full(2, 0.3),
                                   device=device)
    k5p = PoolISIRMixed(2, program=ma2.tile_program(), global_frequency=0.5,
                        batch_size=B, steps_per_call=T)
    cases.append(("K5 pool_isir_mixed (MA(2) program move)",
                  lambda lo, hi, c0: list(k5p.run(
                      7, m_res, *cut((m_pth, m_px, m_plw, m_plk, m_th, m_y,
                                      m_lk), lo, hi), step0=3 * T,
                      chain0=c0))))

    coins = torch.from_numpy((np.arange(T) % 3 == 0).astype(np.int32))
    for mode in ("shared", "per_chain"):
        k6 = FusedMixtureGLMALA(2, p2.y_obs.numpy(), global_frequency=0.5,
                                num_grad=10, steps_per_call=T,
                                coin_mode=mode, **mix)
        cases.append((f"K6 glmala ({mode} coin)",
                      lambda lo, hi, c0, k=k6: flat(k.run(
                          9, *cut((*s2, grad), lo, hi), coins, step0=T,
                          chain0=c0))))

    prog = mixture_tile_program(p2)
    k8 = GenericFusedGLMCMC(prog, global_frequency=0.8, batch_size=B,
                            steps_per_call=T)
    cases.append(("K8 generic_glmcmc (Mixture program)",
                  lambda lo, hi, c0: flat(k8.run(
                      11, *cut(s2, lo, hi), step0=T, chain0=c0))))
    for mode in ("shared", "per_chain"):
        k9 = GenericFusedGLMALA(prog, epsilon=p2.epsilon,
                                global_frequency=0.5, tau=0.1, num_grad=10,
                                steps_per_call=T, coin_mode=mode)
        cases.append((f"K9 generic_glmala ({mode} coin)",
                      lambda lo, hi, c0, k=k9: flat(k.run(
                          13, *cut((*s2, grad), lo, hi), coins, step0=T,
                          chain0=c0))))
    return cases


def split_matches(run, C, offset=True):
    """``(same, max_abs)``: the launch over all ``C`` chains against its two
    halves (chain0 0 and C/2; ``offset=False``: 0 and 0, the control that
    must differ) joined on the chain axis."""
    import torch

    h = C // 2
    whole = run(0, C, 0)
    halves = [run(0, h, 0), run(h, C, h if offset else 0)]
    joined = [torch.cat(pair, dim=-1) for pair in zip(*halves)]
    if len(joined) != len(whole):
        return False, math.inf
    return _bitwise(whole, joined)


def phase_sharded(card):
    """The chain offset on the card, and ``mesh=`` at world size 1.

    Every sampling kernel launched over a chain range and over its two
    halves (each with its first global chain as ``chain0``, packed on its
    own) must give the same bits, at SPLIT_CHAINS and at SPLIT_RAGGED
    chains.  Then ``run_glmcmc_fused`` at the GLMCMC entry-run shape with
    ``mesh=make_mesh()`` over a one-rank NCCL group (a ``FileStore`` in a
    temporary directory) must equal the ``mesh=None`` run bit for bit:
    history and counts; on that group the mesh epoch's select
    (:func:`mesh_select`).  Last, two ranks share the card
    (:func:`two_ranks_one_card`).  No scaling number: the machine has one
    card."""
    import numpy as np
    import torch
    from glabc_tpu_torch import MixtureProblem, run_glmcmc_fused

    for C in (SPLIT_CHAINS, SPLIT_RAGGED):
        for name, run in split_cases(DEVICE, C, SPLIT_T, seed=C):
            same, max_abs = split_matches(run, C)
            torch.cuda.synchronize()
            log(f"[sharded] {name}: {C:,} chains x {SPLIT_T}, the whole "
                f"launch against its halves (chain0 0 and {C // 2:,}): "
                f"{'bitwise' if same else 'DIFFER'} (max abs {max_abs:.3g})")
            check(same, f"{name}: the halves with chain0 do not join to "
                  f"the whole launch at {C:,} chains")

    prob = MixtureProblem(0.05)

    def run(mesh):
        g = torch.Generator(device=DEVICE).manual_seed(4)
        return run_glmcmc_fused(prob, g, ITERS, np.zeros(2),
                                num_chains=CHAINS, mesh=mesh)

    secs_ref, ref = wall(lambda: run(None))
    with one_rank_mesh() as mesh:
        (secs, got), counts = counted(lambda: wall(lambda: run(mesh)))
        select_counts = mesh_select(mesh)
    check(counts == only(packed=(ITERS - 1) // 256),
          f"run_glmcmc_fused(mesh=): launches {counts}")
    same = (np.array_equal(got.thetas, ref.thetas)
            and all(np.array_equal(a, b)
                    for a, b in zip(got.counts, ref.counts)))
    log(f"[sharded] run_glmcmc_fused, {CHAINS:,} chains x {ITERS:,}: "
        f"mesh=make_mesh() on one NCCL rank wall {secs:.2f} s, mesh=None "
        f"wall {secs_ref:.2f} s; history and counts "
        f"{'bitwise equal' if same else 'DIFFER'}; {card}")
    check(same, "run_glmcmc_fused with a one-rank mesh differs from "
          "mesh=None")
    two_ranks_one_card()
    return {"run_glmcmc_mesh": counts, **select_counts}


@contextlib.contextmanager
def one_rank_mesh():
    """A one-rank NCCL group on the card (a ``FileStore`` in a temporary
    directory) and its ``make_mesh()``; the group is destroyed after."""
    import torch.distributed as dist
    from glabc_tpu_torch.parallel import initialize_distributed, make_mesh

    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        initialize_distributed("nccl", store=store, rank=0, world_size=1)
        try:
            yield make_mesh()
        finally:
            dist.destroy_process_group()


def _two_rank_worker(rank, store_path, out_dir):
    """One of two ranks on the one card: gloo over CUDA tensors (NCCL
    refuses two ranks on one device)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from glabc_tpu_torch import MixtureProblem, run_glmcmc_fused
    from glabc_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed("gloo", store=dist.FileStore(store_path, 2),
                           rank=rank, world_size=2)
    try:
        mesh = make_mesh(2)
        run = lambda m: run_glmcmc_fused(
            MixtureProblem(0.05), torch.Generator(
                device=DEVICE).manual_seed(6), 129, np.zeros(2),
            num_chains=16384, mesh=m, device=DEVICE)
        out = {"mesh": run(mesh).thetas}
        if rank == 0:
            out["ref"] = run(None).thetas
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def two_ranks_one_card():
    """``mesh=`` on two ranks sharing the one card, gloo over CUDA
    tensors: each rank's ``run_glmcmc_fused`` at 16,384 chains x 129 must
    equal the one-rank run bit for bit."""
    import numpy as np
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        mp.start_processes(_two_rank_worker,
                           args=(os.path.join(tmp, "store"), tmp), nprocs=2,
                           join=True, start_method="spawn")
        secs = time.perf_counter() - t
        r = [np.load(os.path.join(tmp, f"rank{i}.npz")) for i in range(2)]
        same = all(np.array_equal(x["mesh"], r[0]["ref"]) for x in r)
    log(f"[sharded] two ranks on one card (gloo, CUDA tensors): "
        f"run_glmcmc_fused 16,384 chains x 129 on each rank "
        f"{'bitwise equal to' if same else 'DIFFERS from'} one rank; "
        f"{secs:.1f} s with both processes' start")
    check(same, "two ranks on one card differ from one rank")


# ------------------------------------------------------------ phase 12: m13
M13_CUT = 2      # launches before the checkpoint of the resume check
# mixture.py --method fused: 2,048 x 769 kept draws clear the example's
# 1e6 needed for its E|theta| band; at 65,536 chains the runner's verbose
# summary (R-hat over every chain, on the host) took 58 s of 60
EXAMPLE_CHAINS = 2048


def checkpoint_resume(device, directory, chains, launches, cut, T=256,
                      mesh=None, seed=11):
    """K1 (packed, d=2, the canonical config) for ``launches`` launches of
    ``T`` steps, its loop state saved by ``CheckpointManager`` before
    launch ``cut``; then that state restored into new tensors and run on
    to the end.  Under ``mesh`` each rank runs its own chains with its
    ``chain0``, one checkpoint file a rank.  Returns ``(straight, resumed,
    step)``: each the history from launch ``cut`` on and the final theta,
    y and logk, and the step the manager restored."""
    import numpy as np
    import torch
    from glabc_tpu_torch import MixtureProblem
    from glabc_tpu_torch.models.problems import initial_chains
    from glabc_tpu_torch.samplers._shard import ChainShard
    from glabc_tpu_torch.utils import CheckpointManager

    problem = MixtureProblem(0.05)
    kern = make_kernel("packed", problem, T)
    shard = ChainShard(chains, mesh)
    g = torch.Generator(device=device).manual_seed(seed)
    # every chain's state (the generator moves as on one device), the
    # rank's own packed
    th, y, logk = (shard.keep(x) for x in initial_chains(
        problem, g, np.zeros(2), shard.total, device=device))
    state = (kern.from_chains(th, kern.pack), kern.from_chains(y, kern.pack),
             kern.from_chains(logk, kern.pack, "logk"))

    def run(state, first, mgr=None):
        hist = []
        for i in range(first, launches):
            if i == cut and mgr is not None:
                mgr.save(cut, {"theta": state[0], "y": state[1],
                               "logk": state[2], "call": cut, "seed": seed})
            *state, h, _ = kern.run(seed, *state, step0=i * T,
                                    chain0=shard.chain0)
            hist.append(h)
        return (torch.cat(hist[cut - first:]),) + tuple(state)

    with CheckpointManager(directory, max_to_keep=2, mesh=mesh) as mgr:
        straight = run(state, 0, mgr)
        arrays, step = mgr.restore()
    restored = [torch.as_tensor(arrays[k], device=device)
                for k in ("theta", "y", "logk")]
    return straight, run(restored, int(arrays["call"])), step


def _example(name):
    """``glabc_tpu_torch/examples/<name>.py``, imported by its path."""
    import importlib.util

    path = os.path.join(HERE, "glabc_tpu_torch", "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"glabc_tpu_torch_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace_child(tmp):
    """One ``trace`` of 3 K1 launches inside an ``annotate`` range, in a
    process of its own: in the long smoke process ``torch.profiler``
    dropped the kernel's events in some runs (PERF.md §7), as it did in no
    run as the first trace of a process.  Writes ``<tmp>/trace.json``."""
    import torch
    from glabc_tpu_torch import MixtureProblem
    from glabc_tpu_torch.utils import annotate, trace

    problem = MixtureProblem(0.05)
    kern = make_kernel("packed", problem, 256)
    state = init_state(kern, problem, CHAINS, seed=5)[0]
    launch = lambda: kern.run(1, *state)
    ms = median_ms(launch)
    with trace(os.path.join(tmp, "trace")) as prof:
        with annotate("m13_k1_launch"):
            ms_traced = timed(launch, 3)[0]
    with open(prof.trace_path, encoding="utf-8") as f:
        text = f.read()
    torch.cuda.synchronize()
    with open(os.path.join(tmp, "trace.json"), "w", encoding="utf-8") as f:
        json.dump({"file": os.path.basename(prof.trace_path),
                   "kib": len(text) / 2**10, "ms": ms,
                   "ms_traced": ms_traced,
                   "kernel": "mixture_glmcmc_kernel" in text,
                   "range": "m13_k1_launch" in text}, f)


def phase_m13(tmp, card):
    """The last modules on the card: the native chain writer under a fused
    GLMCMC run read back against the history; a ``CheckpointManager``
    resume of K1 bitwise the straight run; a ``trace`` of K1, in a process
    of its own, that names the kernel; the Mixture and MA(2) examples at
    their JAX defaults and through their kernels."""
    import numpy as np
    import torch
    from glabc_tpu_torch import DiagGaussian, MCMCRunner, MixtureProblem
    from glabc_tpu_torch.native import native_available
    from glabc_tpu_torch.utils import read_binary_chains

    paths = {}
    calls = (ITERS - 1) // 256
    lp = DiagGaussian.create(2, 0.0, math.log(0.35))
    ip = DiagGaussian.create(2, 0.0, 0.0)
    check(native_available(), "the native chain writer did not build")

    # native IO: every chain into one binary file beside the fused run
    def fused(use_native_io, output_file):
        runner = MCMCRunner(MixtureProblem(0.05), output_dir=tmp, seed=3,
                            num_chains=CHAINS, verbose=False,
                            write_chains="all", use_native_io=use_native_io)
        runner.run_glmcmc(ITERS, np.zeros(2), None, 0.9, lp, ip, 5,
                          output_file=output_file, method="fused")
        return runner.last_result

    secs_none, _ = wall(lambda: fused(False, None))
    (secs, res), counts = counted(lambda: wall(lambda: fused(True,
                                                             "chains.bin")))
    paths["m13_native_io"] = counts
    check(counts == only(packed=calls),
          f"m13 native IO: launches {counts}")
    path = os.path.join(tmp, "chains.bin")
    got = read_binary_chains(path)
    same = np.array_equal(got, res.thetas)
    mb = os.path.getsize(path) / 2**20
    log(f"[m13] native writer: run_glmcmc(method='fused', "
        f"write_chains='all', use_native_io=True) {CHAINS:,} chains x "
        f"{ITERS:,}: {mb:.1f} MiB in one binary file, read back by "
        f"read_binary_chains {'bitwise equal to' if same else 'DIFFERS from'}"
        f" the history; wall {secs:.2f} s with the writer against "
        f"{secs_none:.2f} s writing nothing; {card}")
    check(same, "read_binary_chains differs from the fused run's history")
    os.remove(path)

    # CheckpointManager: K1's state saved mid-run, restored, run on
    (straight, resumed, step), counts = counted(lambda: checkpoint_resume(
        DEVICE, os.path.join(tmp, "ckpt"), CHAINS, calls, M13_CUT))
    paths["m13_checkpoint"] = counts
    check(counts == only(packed=2 * calls - M13_CUT),
          f"m13 checkpoint: launches {counts}")
    same = all(torch.equal(a, b) for a, b in zip(straight, resumed))
    log(f"[m13] CheckpointManager: K1 {CHAINS:,} chains, saved after launch "
        f"{M13_CUT} of {calls} (step {step}), restored and run on: history "
        f"and final state {'bitwise equal to' if same else 'DIFFER from'} "
        "the straight run")
    check(same and step == M13_CUT, "a resumed K1 run differs from the "
          "straight run")

    # trace: K1 launches under the profiler, in a process of their own
    ctx = __import__("multiprocessing").get_context("spawn")
    child = ctx.Process(target=_trace_child, args=(tmp,))
    child.start()
    child.join(300)
    if child.is_alive():
        child.kill()
        die("the trace child did not finish in 300 s")
    check(child.exitcode == 0, f"the trace child exited {child.exitcode}")
    with open(os.path.join(tmp, "trace.json"), encoding="utf-8") as f:
        r = json.load(f)
    log(f"[m13] trace (a fresh process): {r['file']} ({r['kib']:.0f} KiB) "
        f"names mixture_glmcmc_kernel: {r['kernel']}, the annotate range: "
        f"{r['range']}; K1 at {CHAINS:,} chains {r['ms_traced']:.3f} ms a "
        f"launch under the profiler against {r['ms']:.3f} ms without; "
        f"{card}")
    check(r["kernel"] and r["range"], "the Chrome trace does not name the "
          "K1 kernel and the annotate range")

    # the examples, imported by path, on the card
    mixture, ma2 = _example("mixture"), _example("ma2")
    out = os.path.join(tmp, "examples")
    runs = (
        ("mixture.py (JAX defaults)", "mixture_defaults",
         lambda: mixture.main(["--output-dir", out]), only()),
        ("ma2.py (JAX defaults)", "ma2_defaults", lambda: ma2.main([]),
         only()),
        (f"mixture.py --method fused --chains {EXAMPLE_CHAINS} --num-ite "
         f"{ITERS}", "mixture_fused", lambda: mixture.main(
             ["--method", "fused", "--chains", str(EXAMPLE_CHAINS),
              "--num-ite", str(ITERS), "--output-dir", out]),
         only(packed=calls)),
        ("ma2.py --method fused", "ma2_fused",
         lambda: ma2.main(["--method", "fused"]),
         only(generic_glmcmc=-(-1999 // 256))),
        ("ma2.py --method aglmcmc", "ma2_aglmcmc",
         lambda: ma2.main(["--method", "aglmcmc"]), None),
    )
    for label, key, fn, want in runs:
        (secs, _), counts = counted(lambda: wall(fn))
        paths[f"m13_{key}"] = counts
        log(f"[m13] example {label}: wall {secs:.2f} s, launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if want is None:   # the mixed kernel's program variant, and K4
            # for the shared epoch's density (MA(2) keeps the generic
            # redraw, so no K10 and no pool epilogue)
            used = {k for k, v in counts.items() if v}
            check(used == {"pool_isir_mixed_prog", "kde_logprob"},
                  f"{label}: launches {counts}")
        else:
            check(counts == want, f"{label}: launches {counts}, expected "
                  f"{want}")
    return paths

# ------------------------------------------------------- shapes (phase 13)
# K7 and K7-bf16 at the shapes the weight-resident kernels do not take
# (dim, hidden, layers), each at SHAPE_ROWS rows; K3, K4 and K5 above d=32.
SHAPE_FLOWS = ((2, 100, 4), (2, 8, 4), (20, 128, 4), (33, 256, 4),
               (64, 512, 2))
SHAPE_ROWS = (8192, 8209)
SHAPE_DIMS = (33, 64, 128)
SHAPE_CHAINS = 4096    # K3 and K5 against plain: chains x 32 steps
# end to end: the reference config (benchmarks/ours_parity.py:6-8) at new
# widths: NF gf=1 on a 20-D problem with a 32 x 256 flow, AGLMCMC at d=40
SHAPE_NF_DIM, SHAPE_NF_HIDDEN, SHAPE_NF_LAYERS = 20, 256, 32
SHAPE_NF_CHAINS, SHAPE_NF_ITERS = 8192, 201
SHAPE_AGL_DIM, SHAPE_AGL_CHAINS, SHAPE_AGL_ITERS = 40, 4096, 1001
# A/B at today's shapes (PERF.md section 6): K7 push of a pool at d=2
# through 32 x 128, K3, K4 and K5 at the AGLMCMC reference runs' shapes
AB_FLOW_ROWS = 32768000
AB_K3 = (32768, 200, 5, 2)        # chains, T, B, d
AB_K4 = (32768, 1000, 1000, 2)    # chains, N, P, d
AB_K5 = (16384, 400, 5, 2, 1024)  # chains, T, B, d, S


def _integer_flow(d, H, seed):
    """One layer whose every product operand is a small integer (the
    log-scale columns scaled by 2^-16), so that each sum is exact in
    float32 in any order, and points of small integers: a kernel that puts
    every weight in its place equals the plain version's log-scale sums bit
    for bit."""
    import torch
    from glabc_tpu_torch.models import CouplingFlow

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    ints = lambda shape, lo, hi: torch.randint(lo, hi, shape, generator=g,
                                               device=DEVICE).float()
    d2 = d // 2
    d1 = d - d2
    w2 = ints((1, H, 2 * d2), -1, 2)
    w2[..., d2:] *= 2.0 ** -16
    f = CouplingFlow(torch.zeros(d, device=DEVICE),
                     torch.zeros(d, device=DEVICE), ints((1, d1, H), 0, 2),
                     ints((1, H), -1, 2), ints((1, H, H), -1, 2),
                     ints((1, H), -2, 3), w2, ints((1, 2 * d2), -2, 3))
    return f, ints((d, 300), 0, 3)


def bf16_order_control(flow, x, inverse):
    """The plain bf16 flow with each layer's h0 w1 summed over its K rows in
    slices of 32, the slices' sums then added in order, as the wide kernel
    adds its slices: the same bf16 operands, another float32 order.  How
    far the plain version moves under that alone is what an order can cost
    a kernel at that shape."""
    import torch

    r = lambda t: t.to(torch.bfloat16).to(torch.float32)
    w0, b0, w1, b1, w2, b2 = (w.detach() for w in flow.stack())
    d2 = flow.dim // 2
    d1 = flow.dim - d2
    u = x.T
    acc = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    for step in range(flow.n_layers):
        l = flow.n_layers - 1 - step if inverse else step
        u1 = u[:, d2:] if inverse else u[:, :d1]
        h = r(torch.relu(r(u1) @ r(w0[l]) + b0[l]))
        w, h1 = r(w1[l]), None
        for k in range(0, flow.hidden, 32):
            p = h[:, k:k + 32] @ w[k:k + 32]
            h1 = p if h1 is None else h1 + p
        h = torch.relu(h1 + b1[l])
        ts = r(h) @ r(w2[l]) + b2[l]
        t, s_ = ts[:, :d2], ts[:, d2:]
        if inverse:
            u = torch.cat([u1, (u[:, :d2] - t) * torch.exp(-s_)], dim=1)
        else:
            u = torch.cat([u[:, d1:] * torch.exp(s_) + t, u1], dim=1)
        acc = acc + s_.sum(dim=1)
    return u.T.contiguous(), acc


def shape_flows_vs_plain():
    """K7 and K7-bf16, push and pull, at SHAPE_FLOWS x SHAPE_ROWS against
    their plain versions (FLOW_SPLIT_TOL and its one-product control;
    BF16_MAX_TOL on each shape and BF16_SHARE over the rows of every shape
    together, as ``tests/test_torch_gpu.py`` pools it: a kernel that adds
    its products in another order than the plain matmul flips a bf16
    rounding now and then, and at 8,192 rows one row is already 1.2e-4),
    each launch counted on the variant that takes the shape; and each
    (dim, hidden) on an integer-valued layer, whose log-scale sums must be
    exact."""
    import torch
    from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush
    from glabc_tpu_torch.ops.kernels.flow_kernel import kernel_variant

    pooled, pooled_ctl = Bf16Diff(), 0
    for d, H, L in SHAPE_FLOWS:
        var = kernel_variant(d, H)
        attrs = {"float32": "wide_launches" if var == "wide" else "launches",
                 "bfloat16": ("wide_bf16_launches" if var == "wide"
                              else "bf16_launches")}
        f, g = _test_flow(d, L, H, seed=1000 * d + H)
        for N in SHAPE_ROWS:
            z = torch.randn((d, N), generator=g, device=DEVICE)
            for cls in (FlowPush, FlowPull):
                label = f"{cls.__name__} d={d} H={H} L={L} N={N:,} ({var})"
                got = {}
                for dt in ("float32", "bfloat16"):
                    before = getattr(cls, attrs[dt])
                    got[dt] = cls(dt).run(f, z)
                    check(getattr(cls, attrs[dt]) == before + 1,
                          f"{label}: {dt} did not launch its {var} kernel")
                want32 = cls().plain(f, z)
                want16 = cls("bfloat16").plain(f, z)
                torch.cuda.synchronize()
                check(all(bool(torch.isfinite(a).all()) for o in
                          got.values() for a in o), f"{label}: not finite")
                err = max(_rel_err(a, b) for a, b in
                          zip(got["float32"], want32))
                check_split(label, err, f, z, want32, cls.inverse)
                diff = Bf16Diff()
                diff.add(got["bfloat16"], want16, want32)
                ctl = _bf16_row_diff(bf16_order_control(f, z, cls.inverse),
                                     want16)
                ctl_bad = int((ctl > BF16_ROW_TOL).sum())
                ctl_max = float(ctl.max())
                log(f"[K7-bf16-order] {label}: the plain bf16 flow summed in "
                    f"slices of 32: rows differing by > {BF16_ROW_TOL:g} "
                    f"{ctl_bad / ctl.numel():.3g}, max {ctl_max:.3g}")
                limit = max(BF16_MAX_TOL, BF16_ORDER_MAX * ctl_max)
                diff.check(label, share_limit=None, max_limit=limit)
                pooled.merge(diff)
                pooled_ctl += ctl_bad
        for dt in ("float32", "bfloat16"):
            fi, zi = _integer_flow(d, H, seed=d * H)
            for cls in (FlowPush, FlowPull):
                got, want = cls(dt).run(fi, zi), cls(dt).plain(fi, zi)
                torch.cuda.synchronize()
                exact = bool(torch.equal(got[1], want[1]))
                rel = _rel_err(got[0], want[0])
                log(f"[shapes] K7 {dt} {cls.__name__} d={d} H={H} on an "
                    f"integer layer ({var}): log-scale sums exact {exact}, "
                    f"coordinates within {rel:.3g}")
                check(exact and rel <= 1e-6, f"K7 {dt} {cls.__name__} d={d}"
                      f" H={H}: an integer layer is not exact")
    share = max(BF16_SHARE, BF16_ORDER_SHARE * pooled_ctl / pooled.rows)
    log(f"[K7-bf16-order] every shape together: the order control's rows "
        f"beyond {BF16_ROW_TOL:g} {pooled_ctl / pooled.rows:.3g}, so the "
        f"kernel's limit {share:.3g}")
    pooled.check(f"every shape of phase 13 together, {pooled.rows:,} rows",
                 share_limit=share, max_limit=pooled.max_rel)


def shape_agl_vs_plain():
    """K3 and K5 at SHAPE_DIMS bit for bit, K4 within KDE_TOL, each on
    its runtime-d variant."""
    import torch
    from glabc_tpu_torch import HighDimMixtureProblem
    from glabc_tpu_torch.models import KernelDensity
    from glabc_tpu_torch.ops.kernels import (BatchedMixtureLogProb,
                                             PoolISIR, PoolISIRMixed,
                                             kde_logprob_inputs,
                                             resident_from_kde)

    C, T, B = SHAPE_CHAINS, 32, 5
    for d in SHAPE_DIMS:
        ptheta, plogw, g = _random_pools(T, B, d, C, 3 * d)
        theta = torch.randn((d, C), generator=g, device=DEVICE)
        logw = torch.randn((C,), generator=g, device=DEVICE) - 4.0
        kern = PoolISIR(d, batch_size=B, steps_per_call=T)
        before = PoolISIR.wide_launches
        got = kern.run(5, ptheta, plogw, theta, logw, step0=1000)
        check(PoolISIR.wide_launches == before + 1, f"K3 d={d}: no launch "
              "of the runtime-d variant")
        want = kern.plain(5, ptheta, plogw, theta, logw, step0=1000)
        torch.cuda.synchronize()
        same, max_abs = _bitwise(got, want)
        log(f"[shapes] K3 d={d}: {C:,} chains x {T} steps, bitwise {same}, "
            f"moves per step {float(got[3].mean()) / T:.3f}")
        check(same, f"pool_isir d={d} differs from its plain version (max "
              f"abs {max_abs:.3g})")

        Ck, P = 256, 1000
        X = torch.randn((Ck, P, d), generator=g, device=DEVICE)
        w = torch.rand((Ck, P), generator=g, device=DEVICE)
        w[:, ::7] = 0.0
        x = torch.randn((Ck, P, d), generator=g, device=DEVICE) * 1.5
        args = (x, *kde_logprob_inputs(KernelDensity.fit(X, w)))
        k4 = BatchedMixtureLogProb()
        before = BatchedMixtureLogProb.wide_launches
        got = k4.run(*args)
        check(BatchedMixtureLogProb.wide_launches == before + 1,
              f"K4 d={d}: no launch of the runtime-d variant")
        want = k4.plain(*args)
        torch.cuda.synchronize()
        err = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        log(f"[shapes] K4 d={d}: {Ck} chains x N=P={P}: max |diff| / "
            f"max(1, |log q|) {err:.3g} (limit {KDE_TOL:g})")
        check(bool(torch.isfinite(got).all()) and err <= KDE_TOL,
              f"kde_logprob d={d}: {err:.3g} > {KDE_TOL}")

        prob = HighDimMixtureProblem(d)
        px = (ptheta.abs() + 0.2 * torch.randn(
            ptheta.shape, generator=g, device=DEVICE)).contiguous()
        plogk = torch.randn((T, B, C), generator=g, device=DEVICE) - 1.0
        res = resident_from_kde(KernelDensity.fit(
            torch.randn((1024, d), generator=g, device=DEVICE) * 1.4))
        y = (theta.abs() + 0.2 * torch.randn(
            (d, C), generator=g, device=DEVICE)).contiguous()
        logk = prob.log_kernel_of_y(y.T.contiguous())
        k5 = PoolISIRMixed(d, prob.y_obs.numpy(), epsilon=prob.epsilon,
                           sigma=prob._noise_std, global_frequency=0.5,
                           batch_size=B, steps_per_call=T)
        a = (res, ptheta, px, plogw, plogk, theta, y, logk)
        before = PoolISIRMixed.wide_launches
        got = k5.run(7, *a, step0=2000)
        check(PoolISIRMixed.wide_launches == before + 1, f"K5 d={d}: no "
              "launch of the runtime-d variant")
        want = k5.plain(7, *a, step0=2000)
        torch.cuda.synchronize()
        same, max_abs = _bitwise(got, want)
        log(f"[shapes] K5 d={d} S=1024 gf=0.5: {C:,} chains x {T} steps, "
            f"bitwise {same}, global share {float(got[3].mean()) / T:.4f}, "
            f"local acceptance "
            f"{float(got[5].sum() / (C * T - got[3].sum())):.4f}")
        check(same, f"pool_isir_mixed d={d} is not bitwise equal to its "
              f"plain version (max abs {max_abs:.3g})")


def _move_fraction(ch):
    """The share of (chain, step) whose state differs from the step
    before."""
    import numpy as np

    return float(np.mean(np.any(ch[:, 1:] != ch[:, :-1], axis=-1)))


def shape_entry_runs(tmp):
    """The entry points on the card at the new widths: GLMCMC-NF gf=1 fused
    (32 x 256 flow, 20-D), AGLMCMC gf=1 fused (K3, K4) and gf=0.5 with
    shared adaptation (K5) at d=40, then the flow API in bf16 on the NF
    run's flow; each path's launches counted from 0 just before it.
    Returns the paths' counts and instruments."""
    import numpy as np
    import torch
    from glabc_tpu_torch import (DiagGaussian, HighDimMixtureProblem,
                                 MCMCRunner)
    from glabc_tpu_torch.ops.kernels import flow_pull_fused, flow_push_fused

    paths, insts = {}, {}

    def run(name, fn, want, d, chains, iters, keys=None):
        secs, (runner, ch), inst = instrumented(paths, insts, name, fn, want)
        check(ch.shape == (chains, iters, d), f"{name}: chains {ch.shape}")
        check(bool(np.isfinite(ch).all()), f"{name}: chains not finite")
        log(f"[shapes] {name}: {chains:,} chains x {iters}, d={d}: move "
            f"fraction {_move_fraction(ch):.5f}, {inst.split(secs, keys)}")
        return runner

    d = SHAPE_NF_DIM
    prob = HighDimMixtureProblem(dim=d)
    nf = MCMCRunner(prob, output_dir=tmp, seed=0,
                    num_chains=SHAPE_NF_CHAINS, verbose=False)
    segs = (SHAPE_NF_ITERS - 1) // 200
    run("shapes_glmcmc_nf_gf1", lambda: (nf, nf.run_glmcmc_nf(
        SHAPE_NF_ITERS, np.zeros(d), None, 1.0,
        DiagGaussian.create(d, 0.0, math.log(0.35)),
        DiagGaussian.create(d, 0.0, 0.0), 5, 200, 50, output_file=None,
        method="fused", hidden=SHAPE_NF_HIDDEN, n_layers=SHAPE_NF_LAYERS)),
        only(pool_isir=segs, flow_push_wide=segs, flow_pull_wide=segs),
        d, SHAPE_NF_CHAINS, SHAPE_NF_ITERS,
        ["flow_push", "pool_isir", "flow_pull"])
    losses = np.asarray(nf.last_result.loss_hist, np.float64)
    check(bool(np.isfinite(losses).all()), f"NF d={d}: losses {losses}")

    d = SHAPE_AGL_DIM
    prob = HighDimMixtureProblem(dim=d)
    lp = DiagGaussian.create(d, 0.0, math.log(0.35))
    ip = DiagGaussian.create(d, 0.0, 0.0)
    segs = (SHAPE_AGL_ITERS - 1) // 200
    agl = MCMCRunner(prob, output_dir=tmp, seed=1,
                     num_chains=SHAPE_AGL_CHAINS, verbose=False)
    run("shapes_aglmcmc_gf1", lambda: (agl, agl.run_aglmcmc(
        SHAPE_AGL_ITERS, np.zeros(d), None, 1.0, lp, ip, 5, 200, 0.8, 0.2,
        output_file=None, method="fused")),
        only(pool_isir_wide=segs, kde_logprob_wide=segs - 1), d,
        SHAPE_AGL_CHAINS, SHAPE_AGL_ITERS, ["pool_isir"])
    mixed = MCMCRunner(prob, output_dir=tmp, seed=2,
                       num_chains=SHAPE_AGL_CHAINS, verbose=False)
    launches = -(-(SHAPE_AGL_ITERS - 1) // 400)
    run("shapes_aglmcmc_gf05", lambda: (mixed, mixed.run_aglmcmc(
        SHAPE_AGL_ITERS, np.zeros(d), None, 0.5, lp, ip, 5, 200, 0.8, 0.2,
        output_file=None, method="fused", shared_support=1024)),
        only(pool_isir_mixed_wide=launches,
             kde_logprob_pool=shared_k4(SHAPE_AGL_CHAINS,
                                        SHAPE_AGL_ITERS - 1),
             shared_redraw=shared_k4(SHAPE_AGL_CHAINS,
                                     SHAPE_AGL_ITERS - 1)),
        d, SHAPE_AGL_CHAINS,
        SHAPE_AGL_ITERS, ["pool_isir_mixed"])
    c = mixed.last_result.counts
    share = float(c.global_attempts.sum()) / (SHAPE_AGL_CHAINS
                                              * (SHAPE_AGL_ITERS - 1))
    log(f"[shapes] shapes_aglmcmc_gf05: global share {share:.5f}")
    check(abs(share - 0.5) <= 0.01, f"AGLMCMC gf=0.5 d={d}: global share "
          f"{share}")

    # the flow API in bf16 on the NF run's flow: push the run's last pool
    # draw, pull the chains' last states
    _, (flow, z), _ = insts["shapes_glmcmc_nf_gf1"].last["flow_push"]
    _, (_, xs), _ = insts["shapes_glmcmc_nf_gf1"].last["flow_pull"]
    bf = dict(matmul_dtype="bfloat16")
    (secs, outs), counts = counted(lambda: wall(lambda: (
        flow_push_fused(flow, z, **bf), flow_pull_fused(flow, xs, **bf))))
    paths["shapes_flow_api_bf16"] = counts
    want = only(flow_push_wide_bf16=1, flow_pull_wide_bf16=1)
    check(counts == want, f"shapes_flow_api_bf16: launches {counts}, "
          f"expected {want}")
    check(all(bool(torch.isfinite(a).all()) for o in outs for a in o),
          "K7-bf16 wide on the NF flow: not finite")
    log(f"[shapes] flow API bf16 on the NF run's 32 x 256 flow (untrained:"
        f" 201 steps hold no epoch): push {z.shape[1]:,} rows, pull "
        f"{xs.shape[1]:,}: wall {secs:.3f} s")
    insts["shapes_flow_api_bf16"] = (flow, z, xs, outs)
    return paths, insts


def shape_flow_rows(insts, paths):
    """The wide K7 kernels' ``kernels`` rows at their main-path shapes: the
    NF run's last push and pull (float32) and the bf16 flow API path's:
    time per launch on the path's own flow and rows, and the bound
    (flow_tf32_work / flow_bf16_work); the bf16 share of rows beyond
    BF16_ROW_TOL pooled over the push and the pull (shape_flows_vs_plain
    gives the limits' reason).  The run's 201 steps hold no epoch,
    so its flow is the untrained identity, on which every version agrees
    exactly: the agreement (and the plain version's time, over chunks of
    2^20 rows) is taken on a random flow of the same shape
    (``_test_flow``), a push over the same rows and a pull of the random
    flow's push of as many normal rows (points of its own data space, as
    the run pulls points of its flow's)."""
    import torch
    from glabc_tpu_torch.ops.kernels import FlowPull, FlowPush

    flow, z, xs, (pushed16, pulled16) = insts["shapes_flow_api_bf16"]
    nf = insts["shapes_glmcmc_nf_gf1"]
    cases = []
    for key, dt, kern, x, got in (
            ("flow_push_wide", "float32", None, None, None),
            ("flow_pull_wide", "float32", None, None, None),
            ("flow_push_wide_bf16", "bfloat16", FlowPush("bfloat16"), z,
             pushed16),
            ("flow_pull_wide_bf16", "bfloat16", FlowPull("bfloat16"), xs,
             pulled16)):
        if kern is None:
            kern, (_, x), _ = nf.last[key[:9]]
            got = None
        cases.append((key, dt, kern, x, got))
    rows, chunk = [], 1 << 20
    pooled, pooled_ctl = Bf16Diff(), 0      # the bf16 push's and pull's rows
    test_flow, tg = _test_flow(flow.dim, flow.n_layers, flow.hidden, seed=21)
    for key, dt, kern, x, got in cases:
        reps = 1 if x.shape[1] > (1 << 20) else 10
        kern.run(flow, x)                                # warm
        ms = sorted(timed(lambda: kern.run(flow, x), reps)[0]
                    for _ in range(3))[1]
        main_got = kern.run(flow, x) if got is None else got
        if kern.inverse:
            x = FlowPush().run(test_flow, torch.randn(
                x.shape, generator=tg, device=DEVICE))[0]
        got = kern.run(test_flow, x)
        plain_ms, max_abs, err = 0.0, 0.0, 0.0
        diff, ctl_bad, ctl_max = Bf16Diff(), 0, 0.0
        for c0 in range(0, x.shape[1], chunk):
            xc = x[:, c0:c0 + chunk].contiguous()
            t_ms, want = timed(lambda: kern.plain(test_flow, xc), 1)
            plain_ms += t_ms
            part = [got[0][:, c0:c0 + chunk], got[1][c0:c0 + chunk]]
            if dt == "bfloat16":
                diff.add(part, want, type(kern)().plain(test_flow, xc))
                ctl = _bf16_row_diff(bf16_order_control(
                    test_flow, xc, kern.inverse), want)
                ctl_bad += int((ctl > BF16_ROW_TOL).sum())
                ctl_max = max(ctl_max, float(ctl.max()))
            for a_, b_ in zip(part, want):
                max_abs = max(max_abs, float((a_ - b_).abs().max()))
                err = max(err, _rel_err(a_, b_))
            if c0 == 0:
                first = (xc, want)
            del want
        label = (f"{key} at the main shape, {x.shape[1]:,} rows (a random "
                 f"flow of the run's shape)")
        if dt == "bfloat16":
            log(f"[K7-bf16-order] {label}: the plain bf16 flow summed in "
                f"slices of 32: rows differing by > {BF16_ROW_TOL:g} "
                f"{ctl_bad / diff.rows:.3g}, max {ctl_max:.3g}")
            diff.check(label, share_limit=None,
                       max_limit=max(BF16_MAX_TOL, BF16_ORDER_MAX * ctl_max))
            pooled.merge(diff)
            pooled_ctl += ctl_bad
        else:
            check_split(f"{label} (one TF32 product on its first "
                        f"{first[0].shape[1]:,} rows)", err, test_flow,
                        *first, kern.inverse)
        check(all(bool(torch.isfinite(a).all()) for a in main_got),
              f"{key} on the run's flow: not finite")
        d, N = x.shape
        work = flow_bf16_work if dt == "bfloat16" else flow_tf32_work
        tc, ops, sfu = (N * w for w in work(d, flow.n_layers, flow.hidden))
        moved = nbytes(x, *got) + nbytes(*flow.stack())
        b_ms, b_by, terms = tc_bound_ms(
            moved, tc, ops, sfu,
            TC_BF16_PER_S if dt == "bfloat16" else TC_TF32_PER_S)
        log(f"[K7-wide] {key}: {N:,} rows, d={d}, {flow.n_layers} layers x "
            f"{flow.hidden}: max abs diff {max_abs:.3g}, max |diff| / max(1,"
            f" |x|) {err:.3g}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; "
            f"{moved / 1e9:.4f} GB, {tc:.4g} tensor-core FLOPs, {ops:.4g} "
            f"operations, {sfu:.4g} exponentials -> bound {b_ms:.4f} ms ("
            + ", ".join(f"{k} {v:.4f}" for k, v in terms.items()) + ")")
        main = ("shapes_flow_api_bf16" if dt == "bfloat16"
                else "shapes_glmcmc_nf_gf1")
        rows.append(dict(
            name=f"coupling_flow_wide ({key.split('_')[1]}, {dt})",
            route="cuda", source="glabc_tpu_torch/csrc/coupling_flow_wide.cu",
            replaces="glabc_tpu/ops/pallas/flow_kernel.py:"
            + ("149" if "push" in key else "164"),
            launches=paths[main][key], max_abs_err=max_abs, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=None,
            launches_by_path={k: v[key] for k, v in paths.items()}))
        del got, main_got
    pooled.check("the bf16 push and pull at the main shape together", max(
        BF16_SHARE, BF16_ORDER_SHARE * pooled_ctl / pooled.rows),
        max_limit=pooled.max_rel)
    return rows


def ab_cases():
    """Today's shapes of K7 push, K3, K4 and K5 (AB_*), inputs made on the
    card from fixed seeds: ``{name: fn}``, each ``fn()`` one launch through
    the package on ``sys.path``, returning its outputs."""
    import torch
    from glabc_tpu_torch import MixtureProblem
    from glabc_tpu_torch.models import KernelDensity
    from glabc_tpu_torch.ops.kernels import (BatchedMixtureLogProb, FlowPush,
                                             PoolISIR, PoolISIRMixed,
                                             kde_logprob_inputs,
                                             resident_from_kde)

    cases = {}
    f, g = _test_flow(2, 32, 128, seed=11)
    z = torch.randn((2, AB_FLOW_ROWS), generator=g, device=DEVICE)
    cases["K7-push"] = lambda: FlowPush().run(f, z)
    C, T, B, d = AB_K3
    pt, pw, g = _random_pools(T, B, d, C, 12)
    th = torch.randn((d, C), generator=g, device=DEVICE)
    lw = torch.randn((C,), generator=g, device=DEVICE) - 4.0
    k3 = PoolISIR(d, batch_size=B, steps_per_call=T)
    cases["K3"] = lambda: k3.run(5, pt, pw, th, lw, step0=1000)
    C, N, P, d = AB_K4
    g = torch.Generator(device=DEVICE).manual_seed(13)
    X = torch.randn((C, P, d), generator=g, device=DEVICE)
    x = torch.randn((C, N, d), generator=g, device=DEVICE) * 1.5
    k4a = (x, *kde_logprob_inputs(KernelDensity.fit(X)))
    cases["K4"] = lambda: BatchedMixtureLogProb().run(*k4a)
    C, T, B, d, S = AB_K5
    prob = MixtureProblem(0.05)
    pt5, pw5, g = _random_pools(T, B, d, C, 14)
    px = (pt5.abs() + 0.2 * torch.randn(pt5.shape, generator=g,
                                        device=DEVICE)).contiguous()
    pk = torch.randn((T, B, C), generator=g, device=DEVICE) - 1.0
    res = resident_from_kde(KernelDensity.fit(
        torch.randn((S, d), generator=g, device=DEVICE) * 1.4))
    th5 = torch.randn((d, C), generator=g, device=DEVICE)
    y5 = (th5.abs() + 0.2 * torch.randn((d, C), generator=g,
                                        device=DEVICE)).contiguous()
    lk5 = prob.log_kernel_of_y(y5.T.contiguous())
    k5 = PoolISIRMixed(d, prob.y_obs.numpy(), epsilon=prob.epsilon,
                       sigma=prob._noise_std, global_frequency=0.5,
                       batch_size=B, steps_per_call=T)
    cases["K5"] = lambda: k5.run(7, res, pt5, px, pw5, pk, th5, y5, lk5,
                                 step0=2000)
    return cases


def ab_hashes():
    """``{name: (sha256 of the outputs, ms per launch)}`` of ab_cases()
    through the package on ``sys.path``: the median of 3 windows (1 launch
    for K7, 5 for the rest) after one warm launch."""
    import hashlib
    import torch

    out = {}
    for name, fn in ab_cases().items():
        got = fn()
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in got:
            if t is not None:
                h.update(t.detach().cpu().numpy().tobytes())
        reps = 1 if name == "K7-push" else 5
        ms = sorted(timed(fn, reps)[0] for _ in range(3))[1]
        out[name] = (h.hexdigest(), ms)
        del got
    return out


def _parent_hashes(parent):
    """ab_hashes() through the package under ``parent`` (a checkout of the
    parent commit), in a process of its own."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "ab.json")
        env = dict(os.environ, GLABC_PACKAGE_ROOT=os.path.abspath(parent))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--ab-hashes", out], env=env, text=True,
                              capture_output=True, timeout=900)
        if proc.returncode != 0:
            die(f"the parent's A/B run failed ({proc.returncode}):\n"
                f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        with open(out) as fh:
            return json.load(fh)


def shape_ab(parent):
    """Today's shapes: each kernel's output sha256 and time, this tree's
    twice between two runs of ``parent``'s (when given) in the same call;
    the hashes must be equal."""
    runs = []
    if parent:
        runs.append(("parent", _parent_hashes(parent)))
    runs += [("this", ab_hashes()), ("this", ab_hashes())]
    if parent:
        runs.append(("parent", _parent_hashes(parent)))
    for name in runs[0][1]:
        hashes = {r[name][0] for _, r in runs}
        log(f"[shapes-ab] {name}: ms " + ", ".join(
            f"{who} {r[name][1]:.3f}" for who, r in runs)
            + f"; sha256 {runs[0][1][name][0][:16]}..., equal in every run "
            f"{len(hashes) == 1}")
        check(len(hashes) == 1, f"{name}: the outputs at today's shape "
              "differ between runs")
    if not parent:
        log("[shapes-ab] no parent checkout given (--parent DIR): this "
            "tree's hashes and times only")


def phase_shapes(tmp, parent=None):
    """Phase 13: the kernels past the static shapes against their plain
    versions, the entry points at the new widths (counted paths), and the
    A/B at today's shapes."""
    t = time.perf_counter()
    shape_flows_vs_plain()
    shape_agl_vs_plain()
    log(f"[shapes] kernels against plain: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    paths, insts = shape_entry_runs(tmp)
    log(f"[shapes] entry runs: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    shape_ab(parent)
    log(f"[shapes] A/B at today's shapes: {time.perf_counter() - t:.1f} s")
    return paths, insts


def _option(name):
    """The value after ``name`` on the command line, or None."""
    args = sys.argv[1:]
    return args[args.index(name) + 1] if name in args[:-1] else None


def main():
    t0 = time.perf_counter()
    try:
        import torch
    except ImportError:
        die("torch is not installed")
    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is false: this script needs a GPU")
    # GLABC_PACKAGE_ROOT: another checkout's package (the parent's A/B run)
    root = os.environ.get("GLABC_PACKAGE_ROOT") or HERE
    sys.path.insert(0, root)
    try:
        import glabc_tpu_torch  # noqa: F401
    except ImportError as e:
        die(f"glabc_tpu_torch is not importable beside chip_smoke.py: {e}")
    check(os.path.abspath(glabc_tpu_torch.__file__).startswith(
        os.path.abspath(root)), f"glabc_tpu_torch came from "
        f"{glabc_tpu_torch.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--seed-spread"]:
        phase_device()
        seed_spread(int(sys.argv[2]),
                    sys.argv[3:] or ("agl", "glmala", "nf", "ma2",
                                     "glmala_prog", "agl_prog"))
        return
    if sys.argv[1:2] == ["--ab-hashes"]:
        with open(sys.argv[2], "w") as fh:
            json.dump(ab_hashes(), fh)
        return
    parent = _option("--parent")
    if "--mesh-select" in sys.argv[1:]:
        name, card = phase_device()
        phase_build()
        rows = [radix_select_row()]
        with one_rank_mesh() as mesh:
            mesh_select(mesh)
        log(f"[done] {time.perf_counter() - t0:.1f} s")
        log(card)
        print(json.dumps({"kernels": rows}), flush=True)
        return
    if "--shapes" in sys.argv[1:]:
        name, card = phase_device()
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            paths, insts = phase_shapes(tmp, parent)
        rows = shape_flow_rows(insts, paths)
        rows += agl_kernel_rows(insts, paths, wide=True)
        log(f"[done] {time.perf_counter() - t0:.1f} s")
        log(card)
        print(json.dumps({"kernels": rows}), flush=True)
        return

    name, card = phase_device()
    phase_build()
    phase_kernel_vs_plain()
    phase_agl_kernels_vs_plain()
    phase_mala_flow_kernels_vs_plain()
    phase_flow_bf16_vs_plain()
    phase_generic_kernels_vs_plain()
    radix_row = radix_select_row()

    # each path runs with the launch counts set to 0 just before it
    bench = phase_main_bench(card)
    with tempfile.TemporaryDirectory() as tmp:
        carry3, prob3, paths = phase_entry_points(tmp)
        agl_paths, insts = phase_aglmcmc(tmp)
        mala_paths, mala_insts = phase_glmala(tmp)
        nf_paths, nf_insts = phase_glmcmc_nf(tmp)
        bf16_counts, bf16_rows = phase_flow_bf16(nf_insts)
        gen_paths, gen_insts = phase_generic(tmp)
        m13_paths = phase_m13(tmp, card)
        shape_paths, shape_insts = phase_shapes(tmp, parent)
    mesh_paths = phase_sharded(card)
    paths = {"bench": bench["launches"], **paths, **agl_paths, **mala_paths,
             **nf_paths, "flow_api_bf16": bf16_counts, **gen_paths,
             **mesh_paths, **m13_paths, **shape_paths}

    rows = phase_kernels_line(bench, carry3, prob3, paths)
    rows += agl_kernel_rows(insts, paths)
    del insts
    k4_shared_epoch_line()
    rows += mala_flow_kernel_rows({**mala_insts, **nf_insts}, paths)
    del mala_insts, nf_insts
    rows += flow_bf16_kernel_rows(bf16_rows, paths)
    rows += generic_kernel_rows(gen_insts, paths)
    del gen_insts
    rows += shape_flow_rows(shape_insts, paths)
    rows += agl_kernel_rows(shape_insts, paths, wide=True)
    del shape_insts
    rows.append(radix_row)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(card)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
