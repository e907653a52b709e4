"""Hyperparameter selection by ESJD per second, on the PyTorch / CUDA port.

Port of ``examples/mixture_hyper.py`` (reference
``glabcmcmc/examples/Mixture_hyper.py:23-41``): a grid of
``global_frequency in {0, 0.1, ..., 1}``, short GLMCMC runs, the score
``esjd(chain) / (wallclock / num_ite)`` (:func:`esjd_per_second`), and the
argmax.  Each grid cell runs every seed as one chain of a single batched
run, so the score stays ESJD per second per chain, comparable to the
reference's.

Usage:
    python glabc_tpu_torch/examples/mixture_hyper.py --num-ite 1000 --seeds 10
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from glabc_tpu_torch import (DiagGaussian, MixtureProblem,  # noqa: E402
                             esjd_per_second)
from glabc_tpu_torch.samplers import run_glmcmc  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-ite", type=int, default=1000)
    p.add_argument("--seeds", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    dev = torch.device(args.device)
    model = MixtureProblem(epsilon=0.05)
    theta0 = np.zeros(2, np.float32)
    lp = DiagGaussian.create(2, 0.0, float(np.log(0.35)))
    ip = DiagGaussian.create(2, 0.0, 0.0)

    gfs = np.round(np.arange(0.0, 1.01, 0.1), 1)
    scores = []
    for gf in gfs:
        t0 = time.time()
        res = run_glmcmc(model, torch.Generator(dev).manual_seed(0),
                         args.num_ite, theta0, ip, lp, float(gf),
                         args.batch_size, num_chains=args.seeds,
                         segment_size=args.num_ite, device=dev)
        wall = time.time() - t0   # the history is on the host by now
        per_seed = esjd_per_second(res.thetas, wall, args.num_ite)
        score = float(per_seed.mean())
        scores.append(score)
        print(f"gf={gf:.1f}  esjd={score * wall / args.num_ite:.5f}  "
              f"wall={wall:.2f}s  esjd/s={score:.3f}", flush=True)

    best = gfs[int(np.argmax(scores))]
    print(f"\nbest global_frequency = {best}")
    return best, scores


if __name__ == "__main__":
    main()
