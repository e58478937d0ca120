"""State-space GP on the PyTorch/CUDA port (twin of
examples/timeseries_statespace.py): exact GP regression on a LONG 1-D
series.

The state-space form of a Matern kernel filters and smooths an s <= 3
latent state instead of storing an n×n Gram -- O(n) memory, exact to
floating point -- with parallel (associative) scans.  This fits n points,
compares the NLML against the dense GPR on a subsample, and forecasts.

Run: python examples_torch/timeseries_statespace.py [--no-plot] [--n 20000]
     [--steps 200] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from examples_torch import _runtime  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=20000)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--no-plot", action="store_true")
    _runtime.add_device_argument(parser)
    args = parser.parse_args(argv)

    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import GPR, StateSpaceGPR

    with _runtime.on_device(args.device):
        rng = np.random.RandomState(0)
        x = np.sort(rng.uniform(0.0, 100.0, args.n))[:, None]
        f_true = np.sin(0.7 * x) + 0.5 * np.sin(0.23 * x + 1.0)
        y = f_true + 0.3 * rng.randn(args.n, 1)

        model = StateSpaceGPR(
            x,
            y,
            kernels.Matern32(1, length_scales=2.0),
            likelihood=likelihoods.Gaussian(0.5),
        )
        losses = model.fit_scan(
            method="Adam", max_iter=args.steps, learning_rate=0.05
        )
        print(f"n={args.n}: NLML {float(losses[0]):.1f} -> {float(losses[-1]):.1f}")

        # exactness check vs the dense GPR on a subsample
        sub = slice(0, 2000)
        dense = GPR(
            model.X[sub].cpu().numpy(),
            model.Y[sub].cpu().numpy(),
            model.kernel,
            likelihood=model.likelihood,
            fast=False,
        )
        ssub = StateSpaceGPR(
            model.X[sub].cpu().numpy(),
            model.Y[sub].cpu().numpy(),
            model.kernel,
            likelihood=model.likelihood,
        )
        ld, ls = float(dense.loss().detach()), float(ssub.loss().detach())
        rel = abs(ld - ls) / abs(ld)
        print(f"dense GPR NLML {ld:.4f} vs state-space {ls:.4f} "
              f"(rel diff {rel:.2e})")

        # forecast past the end of the data
        xs = np.linspace(95.0, 110.0, 200)[:, None]
        mu, var = model.predict_y(xs)
        inside = np.mean(
            np.abs(np.sin(0.7 * xs) + 0.5 * np.sin(0.23 * xs + 1.0) - mu)
            <= 2.0 * np.sqrt(var)
        )
    print(f"forecast: 2sigma coverage of the true function {inside:.0%}")

    if not args.no_plot:
        import matplotlib.pyplot as plt

        sd = np.sqrt(var[:, 0])
        plt.plot(x[-3000:], y[-3000:], "k.", ms=1, alpha=0.3)
        plt.plot(xs, mu, "C0")
        plt.fill_between(xs[:, 0], mu[:, 0] - 2 * sd, mu[:, 0] + 2 * sd, alpha=0.3)
        plt.title("State-space GP: exact fit on long series + forecast")
        plt.show()

    losses = losses.detach().cpu().numpy()
    return {"nlml_first": float(losses[0]), "nlml_last": float(losses[-1]), "dense_nlml": ld,
            "statespace_nlml": ls, "rel_diff": rel, "coverage": float(inside)}


if __name__ == "__main__":
    main()
