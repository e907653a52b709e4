"""Canonical 2-D Gaussian-mixture ABC example on the PyTorch / CUDA port.

Port of ``examples/mixture.py`` (reference
``glabcmcmc/examples/Mixture.py:56-79``): the same problem (epsilon=0.05,
theta0=0, DiagGaussian proposals) and the same canonical hyperparameters
for the five samplers (``README.md:122-131``), through
``glabc_tpu_torch.MCMCRunner``.  ``--method fused`` runs the CUDA kernels
on the card: the fused GLMCMC kernel for GlobalMCMC and GLMCMC (packed
when the chains are a multiple of 2,048), the fused GLMALA kernel, the
pool-iSIR and KDE kernels for AGLMCMC at gf=1, and the pool-iSIR and flow
kernels for GLMCMC-NF at gf=1.

Besides the JAX script's report (time, transitions/s, ESJD of chain 0)
each sampler's per-dimension E|theta| after a burn-in of a quarter of the
run is printed.  On the card, GLMCMC's must lie in [1.40, 1.45], the
posterior check of ``bench.py:134`` (the Mixture posterior's E|theta| is
1.4247, ``benchmarks/PARITY_RESULTS.md``), once the run keeps at least
``BAND_DRAWS`` draws after the burn-in: at the default one chain of 10,000
iterations it is wider than the band between seeds (1.30 to 1.51 over
seeds 0-5 with ``--device cpu``).

Usage:
    python glabc_tpu_torch/examples/mixture.py --sampler glmcmc --num-ite 100000 --chains 64
    python glabc_tpu_torch/examples/mixture.py --sampler all --num-ite 10000 --method fused
    python glabc_tpu_torch/examples/mixture.py --sampler all --num-ite 500 --device cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from glabc_tpu_torch import (DiagGaussian, MCMCRunner,  # noqa: E402
                             MixtureProblem, esjd)

ABSMEAN_BAND = (1.40, 1.45)
BAND_DRAWS = 1_000_000


def absmean(chains, burn):
    """Per-dimension E|theta| of ``chains`` (``(T, d)`` or ``(C, T, d)``)
    after ``burn`` steps, summed in float64."""
    ch = chains if chains.ndim == 3 else chains[None]
    return np.abs(ch[:, burn:].astype(np.float64)).reshape(
        -1, ch.shape[-1]).mean(0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sampler", default="glmcmc",
                   choices=["global", "glmcmc", "glmala", "nf", "aglmcmc",
                            "all"])
    p.add_argument("--num-ite", type=int, default=10_000)
    p.add_argument("--chains", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-dir", default="./results")
    p.add_argument("--method", default="scan", choices=["scan", "fused"],
                   help="fused = the CUDA kernels for GlobalMCMC, GLMCMC, "
                        "GLMALA and AGLMCMC and the gf=1 pool-iSIR route "
                        "for NF; scan = the plain torch path")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu', where the plain "
                        "versions of the kernels run")
    args = p.parse_args(argv)

    model = MixtureProblem(epsilon=0.05)
    theta0 = np.zeros(2, np.float32)
    # canonical proposals (examples/Mixture.py:67-70)
    lp = DiagGaussian.create(2, 0.0, float(np.log(0.35)))
    ip = DiagGaussian.create(2, 0.0, 0.0)
    gp = DiagGaussian.create(2, 0.0, 0.0)
    gp_base = DiagGaussian.create(2)

    runner = MCMCRunner(model, output_dir=args.output_dir, seed=args.seed,
                        num_chains=args.chains, device=args.device)
    out = {}

    def report(name, chain, dt):
        c = chain if chain.ndim == 2 else chain[0]
        am = absmean(chain, args.num_ite // 4)
        print(f"{name}: {args.num_ite} iters in {dt:.1f}s "
              f"({args.chains * args.num_ite / dt:,.0f} transitions/s), "
              f"ESJD={float(esjd(c)):.5f}, E|theta| = "
              f"{np.array2string(am, precision=4)}\n", flush=True)
        out[name] = am

    which = args.sampler
    if which in ("global", "all"):
        t = time.time()
        ch = runner.run_global_mcmc(args.num_ite, theta0, None, 0.5, lp, gp,
                                    output_file="global_mcmc_results.csv",
                                    method=args.method)
        report("GlobalMCMC", ch, time.time() - t)
    if which in ("glmcmc", "all"):
        t = time.time()
        ch = runner.run_glmcmc(args.num_ite, theta0, None, 0.9, lp, ip, 5,
                               output_file="glmcmc_results.csv",
                               method=args.method)
        report("GLMCMC", ch, time.time() - t)
        lo, hi = ABSMEAN_BAND
        draws = args.chains * (args.num_ite - args.num_ite // 4)
        if runner.device.type == "cuda" and draws >= BAND_DRAWS:
            if not all(lo <= m <= hi for m in out["GLMCMC"]):
                raise AssertionError(
                    f"posterior self-check failed: GLMCMC per-dim E|theta| "
                    f"= {out['GLMCMC']} outside [{lo}, {hi}] (expected "
                    "~1.4247)")
            print(f"posterior self-check passed: E|theta| in [{lo}, {hi}] "
                  f"over {draws:,} draws", flush=True)
    if which in ("glmala", "all"):
        t = time.time()
        ch = runner.run_glmala(args.num_ite, theta0, None, 0.8, ip, 5, 0.3,
                               100, output_file="glmala_results.csv",
                               method=args.method)
        report("GLMALA", ch, time.time() - t)
    if which in ("nf", "all"):
        t = time.time()
        # --method fused runs the gf=1 pool-iSIR route, scan the pooled
        # default at gf=0.5, as in the JAX example
        nf_method = "fused" if args.method == "fused" else "pooled"
        nf_gf = 1.0 if nf_method == "fused" else 0.5
        if nf_method == "fused":
            print("[GLMCMC-NF] --method fused runs the gf=1 pool-iSIR "
                  "route (every move global); scan/pooled use gf=0.5",
                  flush=True)
        ch = runner.run_glmcmc_nf(args.num_ite, theta0, None, nf_gf, lp,
                                  gp_base, 5, 200, 50,
                                  output_file="glmcmc_nf_results.csv",
                                  method=nf_method)
        report("GLMCMC-NF", ch, time.time() - t)
    if which in ("aglmcmc", "all"):
        t = time.time()
        ch = runner.run_aglmcmc(args.num_ite, theta0, None, 1.0, lp, ip, 5,
                                200, 0.8, 0.2,
                                output_file="aglmcmc_results.csv",
                                method=args.method)
        report("AGLMCMC", ch, time.time() - t)
    return out


if __name__ == "__main__":
    main()
