"""Bayesian optimization of a black-box function with the BayesOpt loop on
the PyTorch/CUDA port (twin of examples/bayesopt_loop.py).

Minimizes the 2-D Branin function (rescaled to [0, 1]²; three global
minima at f* ≈ 0.3979) with the suggest/observe loop on top of an exact
GPR surrogate: hyperparameters re-fitted every third observation, the
cached posterior fantasy-conditioned in between (``condition_on``), each
acquisition scoring thousands of candidates in one batched product and
refining by gradient, then ``suggest_batch`` by Thompson paths and by the
Kriging believer.

Run:  python examples_torch/bayesopt_loop.py --no-plot [--device cpu]
"""

import argparse
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from examples_torch import _runtime  # noqa: E402
from gptorch_tpu_torch import bayesopt  # noqa: E402


def branin(x):
    """Branin-Hoo on the unit square (inputs rescaled to the standard
    domain x1 ∈ [-5, 10], x2 ∈ [0, 15]); global minimum ≈ 0.397887."""
    x1 = 15.0 * x[0] - 5.0
    x2 = 15.0 * x[1]
    a, b, c = 1.0, 5.1 / (4 * math.pi**2), 5.0 / math.pi
    r, s, t = 6.0, 10.0, 1.0 / (8 * math.pi)
    return float(
        a * (x2 - b * x1**2 + c * x1 - r) ** 2
        + s * (1 - t) * math.cos(x1)
        + s
    )


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--no-plot", action="store_true")
    parser.add_argument("--iters", type=int, default=35)
    parser.add_argument("--acquisition", default="logei",
                        choices=sorted(bayesopt.ACQUISITIONS) + ["ts"])
    parser.add_argument("--seed", type=int, default=0)
    _runtime.add_device_argument(parser)
    args = parser.parse_args(argv)

    with _runtime.on_device(args.device):
        bo = bayesopt.BayesOpt(
            bounds=[[0.0, 1.0], [0.0, 1.0]],
            acquisition=args.acquisition,
            fit_iters=150,
            n_candidates=2048,
            seed=args.seed,
            refit_every=3,
        )
        history = []
        for i in range(args.iters):
            x = bo.suggest()
            y = branin(x)
            bo.observe(x, y)
            history.append(bo.best_y)
            if (i + 1) % 5 == 0:
                print(f"iter {i + 1:3d}  best f = {bo.best_y:.5f}")

        print(f"best point {bo.best_x}, best value {bo.best_y:.5f} "
              f"(global optimum 0.39789)")
        print(f"regret {bo.best_y - 0.397887:.5f}")

        batch_ts = bo.suggest_batch(4, strategy="ts")
        batch_kb = bo.suggest_batch(4, strategy="believer")
    print(f"parallel proposals: ts spread {np.ptp(batch_ts, axis=0)}, "
          f"believer spread {np.ptp(batch_kb, axis=0)}")

    if not args.no_plot:
        import matplotlib.pyplot as plt

        plt.semilogy(np.asarray(history) - 0.397887)
        plt.xlabel("iteration")
        plt.ylabel("simple regret")
        plt.show()

    return {"best_y": float(bo.best_y), "regret": float(bo.best_y - 0.397887), "history": np.asarray(history),
            "ts_spread": np.ptp(batch_ts, axis=0), "believer_spread": np.ptp(batch_kb, axis=0)}


if __name__ == "__main__":
    main(sys.argv[1:])
