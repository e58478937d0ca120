"""Gradient-enhanced GP regression on the PyTorch/CUDA port (twin of
examples/derivative_gp.py): condition on values AND gradients.

The "simulator" is the 2-D Branin function with gradients from
``torch.func.grad``: with the SAME 12 evaluation points the
gradient-enhanced surrogate (``DerivativeGPR``, each point 1 + d
observations) cuts the test RMSE against the value-only GPR, and
``predict_grad`` recovers the gradient field.

Run: python examples_torch/derivative_gp.py [--no-plot] [--device cpu]
"""

import argparse
import math
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from examples_torch import _runtime  # noqa: E402
from gptorch_tpu_torch import kernels, likelihoods, settings  # noqa: E402
from gptorch_tpu_torch.models import GPR, DerivativeGPR  # noqa: E402


def branin(z):
    """Standard Branin on the unit square (scalar in, scalar out)."""
    x = 15.0 * z[0] - 5.0
    y = 15.0 * z[1]
    a, b, c = 1.0, 5.1 / (4 * math.pi**2), 5.0 / math.pi
    r, s, t = 6.0, 10.0, 1.0 / (8 * math.pi)
    return (
        a * (y - b * x**2 + c * x - r) ** 2
        + s * (1 - t) * torch.cos(x)
        + s
    ) / 50.0  # scale to O(1)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--no-plot", action="store_true")
    parser.add_argument("--n-train", type=int, default=12)
    _runtime.add_device_argument(parser)
    args = parser.parse_args(argv)

    with _runtime.on_device(args.device) as device:
        rng = np.random.RandomState(0)
        x_train = rng.rand(args.n_train, 2)

        value_fn = torch.func.vmap(branin)
        grad_fn = torch.func.vmap(torch.func.grad(branin))

        def on_device(fn, x):
            z = torch.as_tensor(x, dtype=settings.default_float(), device=device)
            return fn(z).cpu().numpy()

        y_train = on_device(value_fn, x_train)[:, None]
        g_train = on_device(grad_fn, x_train)

        x_test = rng.rand(400, 2)
        y_test = on_device(value_fn, x_test)[:, None]
        g_test = on_device(grad_fn, x_test)

        # value-only baseline
        m0 = GPR(x_train, y_train, kernels.Rbf(2, ARD=True, length_scales=0.3),
                 likelihood=likelihoods.Gaussian(1e-4))
        m0.likelihood.variance.trainable = False
        m0.fit_scan(method="Adam", max_iter=800, learning_rate=0.03)
        mu0, _ = m0.predict_f(x_test)
        rmse0 = float(np.sqrt(np.mean((mu0 - y_test) ** 2)))

        # gradient-enhanced: same evaluation points, 1 + 2 observations each
        m1 = DerivativeGPR(
            x_train, y_train, kernels.Rbf(2, ARD=True, length_scales=0.3),
            g_train, likelihood=likelihoods.Gaussian(1e-4), grad_variance=1e-4,
        )
        m1.likelihood.variance.trainable = False
        m1.grad_variance.trainable = False
        m1.fit_scan(method="Adam", max_iter=800, learning_rate=0.03)
        mu1, _ = m1.predict_f(x_test)
        rmse1 = float(np.sqrt(np.mean((mu1 - y_test) ** 2)))

        gm, _ = m1.predict_grad(x_test)
        grad_rmse = float(np.sqrt(np.mean((gm - g_test) ** 2)))
        grad_scale = float(np.sqrt(np.mean(g_test**2)))

        print(f"test RMSE value-only GPR      : {rmse0:.4f}")
        print(f"test RMSE gradient-enhanced   : {rmse1:.4f}")
        print(f"improvement factor            : {rmse0 / rmse1:.1f}x")
        print(f"gradient-field RMSE (rel)     : {grad_rmse / grad_scale:.3f}")
        assert rmse1 < rmse0, "gradient observations must help"

        if not args.no_plot:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, axes = plt.subplots(1, 3, figsize=(13, 4))
            gx, gy = np.meshgrid(np.linspace(0, 1, 60), np.linspace(0, 1, 60))
            grid = np.stack([gx.ravel(), gy.ravel()], 1)
            truth = on_device(value_fn, grid).reshape(60, 60)
            pv, _ = m0.predict_f(grid)
            pg, _ = m1.predict_f(grid)
            for ax, z, title in zip(
                axes,
                [truth, pv.reshape(60, 60), pg.reshape(60, 60)],
                ["Branin (truth)", "value-only GPR", "gradient-enhanced"],
            ):
                ax.contourf(gx, gy, z, levels=25)
                ax.plot(x_train[:, 0], x_train[:, 1], "r.", ms=8)
                ax.set_title(title)
            fig.tight_layout()
            fig.savefig("derivative_gp.png", dpi=120)
            print("saved derivative_gp.png")

    return {"rmse_value_only": rmse0, "rmse_gradient": rmse1, "improvement": rmse0 / rmse1,
            "grad_rel_rmse": grad_rmse / grad_scale}


if __name__ == "__main__":
    main()
