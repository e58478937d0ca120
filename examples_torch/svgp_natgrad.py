"""Natural-gradient SVGP + cached-posterior serving on the PyTorch/CUDA port
(twin of examples/svgp_natgrad.py).

Trains an SVGP on a synthetic sinusoid with natural-gradient steps on the
variational distribution (Adam on the hyperparameters), minibatches drawn
from an explicit ``torch.Generator``, then serves predictions through a
cached posterior (factorize once, predict many).

Run: python examples_torch/svgp_natgrad.py [--no-plot] [--n 512] [--steps 200] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from examples_torch import _runtime  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=512)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--nat-lr", type=float, default=0.5)
    parser.add_argument("--no-plot", action="store_true")
    _runtime.add_device_argument(parser)
    args = parser.parse_args(argv)

    from gptorch_tpu_torch import kernels, likelihoods
    from gptorch_tpu_torch.models import SVGP
    from gptorch_tpu_torch.training import fit_svgp_natgrad

    with _runtime.on_device(args.device) as device:
        rng = np.random.RandomState(0)
        x = np.sort(rng.uniform(-3, 3, args.n))[:, None]
        y = np.sin(2 * x) + 0.3 * np.cos(5 * x) + 0.1 * rng.randn(args.n, 1)

        model = SVGP(
            x,
            y,
            kernels.Rbf(1),
            num_inducing_points=24,
            likelihood=likelihoods.Gaussian(variance=0.05),
            batch_size=min(128, args.n),
        )
        l0 = float(model.loss(generator=torch.Generator(device).manual_seed(99)).detach())
        model, losses = fit_svgp_natgrad(
            model, n_steps=args.steps, nat_lr=args.nat_lr
        )
        print(f"loss: {l0:.3f} -> {losses[-1]:.3f} ({args.steps} natgrad steps)")

        # cached posterior: one factorization, many cheap predicts
        post = model.posterior()
        x_grid = np.linspace(-3.5, 3.5, 200)[:, None]
        mean, var = post.predict_y(x_grid)
    print(f"serving: predict_y on {x_grid.shape[0]} points, "
          f"mean range [{mean.min():.2f}, {mean.max():.2f}]")

    if not args.no_plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.fill_between(
            x_grid[:, 0],
            (mean - 2 * np.sqrt(var))[:, 0],
            (mean + 2 * np.sqrt(var))[:, 0],
            alpha=0.3,
        )
        plt.plot(x_grid[:, 0], mean[:, 0])
        plt.plot(x[:, 0], y[:, 0], "k.", ms=2)
        plt.savefig("svgp_natgrad.png", dpi=120)
        print("wrote svgp_natgrad.png")

    return {"loss_first": l0, "loss_last": float(losses[-1]), "mean_min": float(mean.min()),
            "mean_max": float(mean.max())}


if __name__ == "__main__":
    main()
