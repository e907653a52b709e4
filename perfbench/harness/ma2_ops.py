"""The work that K8's moves need on the MA(2) program, frozen here so that
``k8_roofline`` reads the same work whatever implements the kernel.

Copied from ``chip_smoke.py`` (``ma2_sim_ops``, ``ma2_local_ops`` and the
two K8 branches of ``ma2_step_ops``); the peaks are ``peaks.py``'s; nothing
here imports the program.
"""

from __future__ import annotations

from . import peaks

_MA2_KERN = 11                       # the epsilon-kernel: 3 x (sub, mul,
#                                      add) + 2


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


def ma2_local_ops(T):
    """The MA(2) random-walk move's own work at the least, ``(ops, sfu)``:
    a block of two Box-Muller pairs (80, and 10 + 8 each), theta' (4), a
    simulation, the epsilon-kernel, the triangle test (6) and the MH ratio
    and selects (10); ``sfu`` counts the pairs' and the simulation's (the
    MH test's log u is the caller's)."""
    sim, sim_sfu = ma2_sim_ops(T)
    return (80 + 2 * (10 + 8) + 4 + sim + _MA2_KERN + 6 + 10,
            2 * 4 + sim_sfu)


def ma2_step_ops(T, B, kind):
    """32-bit operations of one chain-step of K8 on the MA(2) program at
    the least, ``(ops, sfu)``.  ``kind``: 'global' (B candidates: a uniform
    block, the box draw, a simulation, the epsilon-kernel, the triangle
    test, the Gumbel score and the selects) or 'local' (the random walk,
    :func:`ma2_local_ops`, and its log u).  Each step adds the scalar
    blocks, the coin and the counters."""
    sim, sim_sfu = ma2_sim_ops(T)
    ops, sfu = 80 * -(-(B + 3) // 4) + 5 * (B + 3) + 20, 0
    if kind == "global":
        ops += B * (80 + 10 + 4 + sim + _MA2_KERN + 6 + 4 + 10)
        sfu += B * (sim_sfu + 2) + 2
    else:
        o, s = ma2_local_ops(T)
        ops, sfu = ops + o, sfu + s + 1
    return ops, sfu


def k8_bytes(chains, launches):
    """Bytes K8 must move without a history: per chain and launch the
    state it reads (theta 2, y 3, log K 1 float32 words) and writes (the
    same six and four counters), each byte counted once."""
    return launches * chains * 16 * 4


def k8_bound_s(T, B, chains, launches, transitions, global_attempts):
    """The least time of K8's launches on MA(2) series of ``T`` steps:
    ``transitions`` chain-steps of which ``global_attempts`` took the
    global move (``peaks.bound_s``)."""
    n_g = float(global_attempts)
    og, sg = ma2_step_ops(T, B, "global")
    ol, sl = ma2_step_ops(T, B, "local")
    n_l = transitions - n_g
    return peaks.bound_s(k8_bytes(chains, launches), n_g * og + n_l * ol,
                         n_g * sg + n_l * sl)
