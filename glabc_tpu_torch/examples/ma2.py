"""MA(2) time-series ABC on the PyTorch / CUDA port.

Port of ``examples/ma2.py``.  ``MA2Problem`` supplies the ABC definition
and ``MA2Problem.tile_program()`` its lowering for the generic kernels (a
CUDA header, ``csrc/programs/ma2.cuh``, and its torch twin):

* ``--method fused``: ``run_fused_program``, GLMCMC through the generic
  fused kernel;
* ``--method aglmcmc``: adaptive AGLMCMC at gf=0.5 through the mixed
  pool-iSIR kernel with the MA(2) local move of the tile program, and the
  shared KDE adaptation between segments;
* ``--method scan``: the plain torch ``run_glmcmc``.

The default ``num_draws=100`` observes the JAX package's ``y_obs``; for
another series length the observation is simulated here from the true
theta (0.6, 0.2) with the port's own generator (seed 42), since the port
cannot replay JAX's draws.

Usage:
    python glabc_tpu_torch/examples/ma2.py --method fused --num-ite 10000
    python glabc_tpu_torch/examples/ma2.py --method scan --num-ite 2000
    python glabc_tpu_torch/examples/ma2.py --method aglmcmc --num-ite 4000
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from glabc_tpu_torch import (DiagGaussian, MA2Problem, Uniform,  # noqa: E402
                             chain_summary)


def make_problem(epsilon: float, num_draws: int) -> MA2Problem:
    """The JAX package's problem at ``num_draws=100``; otherwise one whose
    ``y_obs`` is a simulation at the true theta by the port's generator."""
    if num_draws == 100:
        return MA2Problem(epsilon=epsilon, num_draws=num_draws)
    probe = MA2Problem(epsilon, num_draws, y_obs=np.zeros(3, np.float32))
    y_obs = probe.simulate(probe.theta_true[None],
                           torch.Generator().manual_seed(42))[0]
    return MA2Problem(epsilon, num_draws, y_obs=y_obs)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--method", choices=["fused", "scan", "aglmcmc"],
                   default="scan")
    p.add_argument("--num-ite", type=int, default=2000)
    p.add_argument("--chains", type=int, default=None)
    p.add_argument("--num-draws", type=int, default=100)
    p.add_argument("--epsilon", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    dev = torch.device(args.device)
    prob = make_problem(args.epsilon, args.num_draws)
    print(f"true theta = (0.6, 0.2); y_obs autocovariances = "
          f"{np.round(prob.y_obs.numpy(), 3)}")

    gen = torch.Generator(dev).manual_seed(args.seed)
    theta0 = np.zeros(2, np.float32)
    t0 = time.time()
    if args.method == "aglmcmc":
        from glabc_tpu_torch.samplers import run_aglmcmc_fused_mixed

        chains = args.chains or 4096
        ip = DiagGaussian.create(2, 0.0, float(np.log(0.5)))
        res = run_aglmcmc_fused_mixed(
            prob, gen, args.num_ite, theta0, ip, global_frequency=0.5,
            batch_size=5, step_size=200, num_chains=chains,
            shared_support=2048,
            tile_program=prob.tile_program(lp_scale=0.1), device=dev)
    elif args.method == "fused":
        from glabc_tpu_torch.samplers import run_fused_program

        chains = args.chains or 4096
        res = run_fused_program(prob, prob.tile_program(lp_scale=0.1), gen,
                                args.num_ite, theta0, global_frequency=0.8,
                                batch_size=5, num_chains=chains,
                                steps_per_call=256, device=dev)
    else:
        from glabc_tpu_torch.samplers import run_glmcmc

        chains = args.chains or 16
        ip = Uniform(torch.tensor([-2.0, -1.0]), torch.tensor([2.0, 1.0]))
        lp = DiagGaussian.create(2, 0.0, float(np.log(0.1)))
        res = run_glmcmc(prob, gen, args.num_ite, theta0, ip, lp, 0.8, 5,
                         num_chains=chains,
                         segment_size=min(args.num_ite, 20_000), device=dev)
    dt = time.time() - t0   # the history is on the host by now

    burn = args.num_ite // 4
    ch = res.thetas[:, burn:, :]
    print(chain_summary(ch).render())
    rates = res.acceptance_rates()
    print(f"acceptance global/local: {float(rates['global'].mean()):.4f} / "
          f"{float(rates['local'].mean()):.4f}")
    print(f"{args.method}: {chains} chains x {args.num_ite} iters in "
          f"{dt:.1f}s = {chains * (args.num_ite - 1) / dt:,.0f} "
          f"transitions/s", flush=True)
    return res


if __name__ == "__main__":
    main()
