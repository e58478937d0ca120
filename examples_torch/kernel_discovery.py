"""Kernel structure discovery on the PyTorch/CUDA port (twin of
examples/kernel_discovery.py): let the data pick its own kernel.

Greedy compositional search over  K ::= B | K + B | K * B  (Duvenaud et
al. 2013), BIC-scored, every candidate trained by L-BFGS on its own copy.
The data is a linear trend plus a fast oscillation; the search must
discover an additive composite, and the found structure extrapolates where
a plain Rbf reverts to the mean.  Runs in float64, as the JAX script does
(the search's "same f64 numerics").

Run: python examples_torch/kernel_discovery.py [--no-plot] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from examples_torch import _runtime  # noqa: E402
from gptorch_tpu_torch import kernels  # noqa: E402
from gptorch_tpu_torch.models import GPR  # noqa: E402
from gptorch_tpu_torch.structure import kernel_search  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--no-plot", action="store_true")
    parser.add_argument("--max-depth", type=int, default=2)
    _runtime.add_device_argument(parser)
    args = parser.parse_args(argv)

    default_dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        with _runtime.on_device(args.device):
            return _search(args)
    finally:
        torch.set_default_dtype(default_dtype)


def _search(args):
    rng = np.random.RandomState(1)
    n = 120
    x = np.sort(rng.uniform(0, 12, n))[:, None]
    f = lambda x: 0.5 * x + np.cos(3.0 * x)  # noqa: E731
    y = f(x) + 0.1 * rng.randn(n, 1)

    result = kernel_search(
        x, y,
        bases=("Rbf", "Linear"),
        max_depth=args.max_depth,
        max_iter=80,
        verbose=True,
    )
    print(f"discovered kernel: {result.expression}  (BIC {result.score:.2f})")

    # extrapolation: the discovered structure carries the trend forward;
    # a plain Rbf reverts to the prior mean
    x_star = np.linspace(12, 15, 40)[:, None]
    mu_found, _ = result.model.predict_y(x_star)
    plain = GPR(x, y, kernels.Rbf(1))
    plain.fit_scan(method="LBFGS", max_iter=80)
    mu_plain, _ = plain.predict_y(x_star)
    rmse_found = float(np.sqrt(np.mean((mu_found - f(x_star)) ** 2)))
    rmse_plain = float(np.sqrt(np.mean((mu_plain - f(x_star)) ** 2)))
    print(
        f"extrapolation RMSE 12<x<15: discovered {rmse_found:.3f} "
        f"vs plain Rbf {rmse_plain:.3f}"
    )

    if not args.no_plot:
        import matplotlib.pyplot as plt

        xg = np.linspace(0, 15, 300)[:, None]
        mu, var = result.model.predict_y(xg)
        plt.fill_between(
            xg.ravel(),
            (mu - 2 * np.sqrt(var)).ravel(),
            (mu + 2 * np.sqrt(var)).ravel(),
            alpha=0.3,
        )
        plt.plot(xg, mu, label=result.expression)
        plt.plot(x, y, "k.", ms=3, label="data")
        plt.axvline(12.0, ls="--", c="gray")
        plt.legend()
        plt.title("Discovered kernel structure")
        plt.show()

    return {"expression": result.expression, "score": float(result.score), "candidates": len(result.history),
            "rmse_found": rmse_found, "rmse_plain": rmse_plain}


if __name__ == "__main__":
    main()
