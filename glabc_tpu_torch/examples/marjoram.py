"""Marjoram-style ABC-MCMC baseline on the Mixture problem, on the
PyTorch / CUDA port.

Port of ``examples/marjoram.py``.  The reference cross-checks its samplers
against R EasyABC's ``ABC_mcmc(method="Marjoram")``
(``examples/easyabc_Marjoram.R:1-17``): plain random-walk ABC-MCMC with a
uniform (indicator) kernel, which accepts a simulated dataset iff its
discrepancy is below epsilon.  In the problem DSL that is an override of
``kernel_log_prob`` and the local-only (global_frequency = 0) sampler.

Usage: python glabc_tpu_torch/examples/marjoram.py --num-ite 100000 --chains 32
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from glabc_tpu_torch import (DiagGaussian, MixtureProblem,  # noqa: E402
                             chain_summary, esjd)
from glabc_tpu_torch.samplers import run_glmcmc  # noqa: E402


class MarjoramMixture(MixtureProblem):
    """Mixture problem with the uniform ABC kernel: log K = 0 if
    discrepancy <= epsilon else -inf (EasyABC Marjoram acceptance)."""

    def kernel_log_prob(self, dis, epsilon=None):
        if epsilon is None:
            epsilon = self.epsilon
        return torch.where(dis <= epsilon, torch.zeros_like(dis),
                           torch.full_like(dis, -math.inf))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-ite", type=int, default=20_000)
    p.add_argument("--chains", type=int, default=32)
    p.add_argument("--epsilon", type=float, default=0.3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    dev = torch.device(args.device)
    model = MarjoramMixture(epsilon=args.epsilon)
    lp = DiagGaussian.create(2, 0.0, float(np.log(0.35)))
    ip = DiagGaussian.create(2, 0.0, 0.0)  # unused at gf=0

    # the indicator kernel needs dis <= eps at the start: start at the
    # observation (dis = 0)
    res = run_glmcmc(model, torch.Generator(dev).manual_seed(args.seed),
                     args.num_ite, np.array([1.5, 1.5], np.float32), ip, lp,
                     global_frequency=0.0, batch_size=1, y0=model.y_obs,
                     num_chains=args.chains,
                     segment_size=min(args.num_ite, 50_000), device=dev)
    ch = res.thetas[:, args.num_ite // 5:, :]
    print(chain_summary(ch).render())
    flat = ch.reshape(-1, 2).astype(np.float64)
    print(f"absmean: {np.abs(flat).mean(0)}")
    print(f"acceptance: {float(res.acceptance_rates()['local'].mean()):.4f}")
    print(f"ESJD (chain 0): {float(esjd(res.thetas[0])):.5f}", flush=True)
    return res


if __name__ == "__main__":
    main()
