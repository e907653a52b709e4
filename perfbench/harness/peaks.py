"""The yardstick's arithmetic: the published peaks of one H100 and the work
that K1's moves need, frozen here so that a roofline share reads the same
work whatever implements the kernel.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``OPS_PER_S``,
``SFU_PER_S``, ``bound_ms``, ``transition_ops``, ``transition_ops_mix``);
nothing here imports the program.
"""

from __future__ import annotations

# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet): HBM3 at
# 3.35 TB/s, and 67 TFLOP/s float32 outside the tensor cores, which counts a
# fused multiply-add as two: one 32-bit operation per lane per clock is
# 132 SMs x 128 lanes x 1.98 GHz = 33.5e12 operations/s.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 132 * 128 * 1.98e9
# The special-function units (exp2, log2, sin, cos, rsqrt) issue 16
# operations per SM per clock: 132 x 16 x 1.98 GHz.
SFU_PER_S = 132 * 16 * 1.98e9

PEAKS = {"hbm_bytes_per_s": HBM_BYTES_PER_S, "ops_per_s": OPS_PER_S,
         "sfu_per_s": SFU_PER_S}


def bound_s(bytes_moved, ops, sfu=0):
    """The least time for the work, in seconds: bytes over the memory rate,
    32-bit operations over one per lane per clock, special-function
    operations over their own units' rate.  Returns ``(seconds, 'bytes' or
    'operations')``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(ops / OPS_PER_S, sfu / SFU_PER_S)
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                 else "operations")


def transition_ops(d, B, glmcmc, move):
    """32-bit operations one transition of one chain needs at the least
    when its coin picks ``move`` ('global' or 'local'): the scalar Philox
    blocks that hold the slots the move reads (coin first), the candidates'
    blocks, uniforms, Box-Muller pairs, theta and y, the Gaussian
    log-densities (the current state's prior is known from the step that
    made it; iSIR needs the current state's proposal density), the
    epsilon-kernels, the acceptance (iSIR's Gumbels, scores and argmax; an
    MH ratio, log u and compare), and per step the coin, the four counters
    and the state's selects.  Each log, sqrt, sin and cos counts one, so
    this is a lower bound."""
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
    ``global_attempts`` took the global move."""
    n_g = float(global_attempts)
    return (n_g * transition_ops(d, B, glmcmc, "global")
            + (transitions - n_g) * transition_ops(d, B, glmcmc, "local"))


def k1_bytes(chains, d, launches):
    """Bytes K1 must move: per chain and launch the state it reads (theta,
    y, log K) and writes (the same three and four counters), ``d`` float32
    words each in the packed layout (a column of 8 rows holds ``8 / d``
    chains), each byte counted once."""
    return launches * chains * 10 * d * 4
