"""g-and-k distribution inference on the PyTorch / CUDA port: a heavier,
real-world-style ABC problem.

Port of ``examples/gk.py``: GLMCMC (gf=0.7, B=5) through the plain torch
``run_glmcmc`` on the card.  The default ``num_draws=1000`` observes the
JAX package's ``y_obs``; for another sample size the observation is
simulated here from the true theta (3, 1, 2, 0.5) with the port's own
generator (seed 1234).

Usage: python glabc_tpu_torch/examples/gk.py --num-ite 20000 --chains 64
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from glabc_tpu_torch import (DiagGaussian, GKProblem,  # noqa: E402
                             chain_summary)
from glabc_tpu_torch.samplers import run_glmcmc  # noqa: E402

THETA_TRUE = (3.0, 1.0, 2.0, 0.5)


def make_problem(epsilon: float, num_draws: int) -> GKProblem:
    """The JAX package's problem at ``num_draws=1000``; otherwise one whose
    ``y_obs`` is a simulation at the true theta by the port's generator."""
    if num_draws == 1000:
        return GKProblem(epsilon=epsilon, num_draws=num_draws)
    probe = GKProblem(epsilon, num_draws, y_obs=np.zeros(7, np.float32))
    y_obs = probe.simulate(torch.tensor([THETA_TRUE]),
                           torch.Generator().manual_seed(1234))[0]
    return GKProblem(epsilon, num_draws, y_obs=y_obs)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-ite", type=int, default=10_000)
    p.add_argument("--chains", type=int, default=64)
    p.add_argument("--epsilon", type=float, default=1.0)
    p.add_argument("--num-draws", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    dev = torch.device(args.device)
    prob = make_problem(args.epsilon, args.num_draws)
    print(f"true theta = (3, 1, 2, 0.5); y_obs octiles = "
          f"{np.round(prob.y_obs.numpy(), 2)}")

    ip = DiagGaussian.create(4, loc=5.0, log_scale=float(np.log(3.0)))
    lp = DiagGaussian.create(4, 0.0, float(np.log(0.25)))
    res = run_glmcmc(prob, torch.Generator(dev).manual_seed(args.seed),
                     args.num_ite, np.full(4, 5.0, np.float32), ip, lp, 0.7,
                     5, num_chains=args.chains,
                     segment_size=min(args.num_ite, 20_000), device=dev)
    burn = args.num_ite // 4
    ch = res.thetas[:, burn:, :]
    print(chain_summary(ch).render())
    rates = res.acceptance_rates()
    print(f"acceptance global/local: {float(rates['global'].mean()):.4f} / "
          f"{float(rates['local'].mean()):.4f}", flush=True)
    return res


if __name__ == "__main__":
    main()
