"""Active learning on the PyTorch/CUDA port (twin of
examples/active_learning.py): choose the next measurements to REDUCE
UNCERTAINTY.

A sensor-placement-style loop on a 1-D function: starting from 5 random
measurements, each round greedily picks a batch of ALC-optimal points
(integrated variance reduction over the domain, from the cached posterior
in closed form; fantasy conditioning between picks) and compares against
random sampling with the same budget.

Run: python examples_torch/active_learning.py [--no-plot] [--rounds 4] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from examples_torch import _runtime  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--no-plot", action="store_true")
    _runtime.add_device_argument(parser)
    args = parser.parse_args(argv)

    from gptorch_tpu_torch import design, kernels, likelihoods, metrics
    from gptorch_tpu_torch.models import GPR

    with _runtime.on_device(args.device):
        rng = np.random.RandomState(0)
        f = lambda x: np.sin(7.0 * x) + 0.4 * np.cos(17.0 * x)  # noqa: E731
        noise = 0.05
        measure = lambda x: f(x) + noise * rng.randn(*x.shape)  # noqa: E731

        grid = np.linspace(0.0, 1.0, 400)[:, None]

        def fit(x, y):
            m = GPR(
                x, y, kernels.Rbf(1, length_scales=0.15),
                likelihood=likelihoods.Gaussian(noise**2), fast=False,
            )
            m.fit_scan(method="Adam", max_iter=200, learning_rate=0.05)
            return m

        x0 = rng.rand(5, 1)
        y0 = measure(x0)

        # -- ALC loop ------------------------------------------------------
        xa, ya = x0.copy(), y0.copy()
        for r in range(args.rounds):
            post = fit(xa, ya).posterior()
            idx, _ = design.suggest_batch(
                post, grid, q=args.batch, strategy="alc"
            )
            x_new = grid[idx]
            xa = np.vstack([xa, x_new])
            ya = np.vstack([ya, measure(x_new)])
            print(
                f"round {r + 1}: measured at "
                + ", ".join(f"{v:.2f}" for v in sorted(x_new[:, 0]))
            )

        # -- random baseline, same budget -----------------------------------
        xr = np.vstack([x0, rng.rand(args.rounds * args.batch, 1)])
        yr = measure(xr[len(x0):])
        yr = np.vstack([y0, yr])

        m_alc, m_rand = fit(xa, ya), fit(xr, yr)
        mu_a, var_a = m_alc.predict_y(grid)
        mu_r, var_r = m_rand.predict_y(grid)
        s_a = metrics.summarize(f(grid), mu_a, var_a)
        s_r = metrics.summarize(f(grid), mu_r, var_r)
    print(
        f"after {len(xa)} measurements: ALC  RMSE {s_a['rmse']:.4f} "
        f"NLPD {s_a['nlpd']:.2f}"
    )
    print(
        f"after {len(xr)} measurements: rand RMSE {s_r['rmse']:.4f} "
        f"NLPD {s_r['nlpd']:.2f}"
    )
    print(f"ALC beats random: {s_a['rmse'] < s_r['rmse']}")

    if not args.no_plot:
        import matplotlib.pyplot as plt

        sd = np.sqrt(var_a[:, 0])
        plt.plot(grid, f(grid), "k--", lw=1)
        plt.plot(grid, mu_a, "C0")
        plt.fill_between(grid[:, 0], mu_a[:, 0] - 2 * sd, mu_a[:, 0] + 2 * sd, alpha=0.3)
        plt.plot(xa, ya, "C3.", ms=8)
        plt.title("ALC active learning")
        plt.show()

    return {"alc_rmse": s_a["rmse"], "alc_nlpd": s_a["nlpd"], "random_rmse": s_r["rmse"],
            "random_nlpd": s_r["nlpd"], "alc_beats_random": bool(s_a["rmse"] < s_r["rmse"])}


if __name__ == "__main__":
    main()
