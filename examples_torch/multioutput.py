"""Correlated-output GPs on the PyTorch/CUDA port (twin of
examples/multioutput.py): exact ICM vs sparse-variational LMC.

Two outputs driven by one shared latent function (y2 = -2·y1): a
correlated-output model transfers information across outputs.

Run: python examples_torch/multioutput.py [--no-plot] [--n 160] [--steps 800] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from examples_torch import _runtime  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=160)
    parser.add_argument("--steps", type=int, default=800)
    parser.add_argument("--no-plot", action="store_true")
    _runtime.add_device_argument(parser)
    args = parser.parse_args(argv)

    from gptorch_tpu_torch import kernels
    from gptorch_tpu_torch.models import ICM, LMC

    with _runtime.on_device(args.device):
        rng = np.random.RandomState(0)
        x = np.sort(rng.uniform(-3, 3, args.n))[:, None]
        f = np.sin(1.5 * x)
        y = np.concatenate(
            [f + 0.05 * rng.randn(args.n, 1), -2.0 * f + 0.05 * rng.randn(args.n, 1)],
            axis=1,
        )

        # -- exact ICM -----------------------------------------------------
        # (Adam, not L-BFGS: the coregionalization NLML has a diagonal-B
        # local optimum that quasi-Newton steps from a small-W init fall
        # into.)
        icm = ICM(x, y, kernels.Rbf(1), rank=1)
        icm.optimize(method="Adam", max_iter=max(args.steps, 300), verbose=False)
        mu_icm, _ = icm.predict_y(x)
        icm_rmse = float(np.sqrt(np.mean((mu_icm - y) ** 2)))
        print(f"ICM train RMSE: {icm_rmse:.4f}")
        B = icm.coregion_matrix().detach().cpu().numpy()
        corr = float(B[0, 1] / np.sqrt(B[0, 0] * B[1, 1]))
        print(f"ICM output correlation: {corr:+.3f}")

        # -- sparse LMC ----------------------------------------------------
        lmc = LMC(x, y, kernels.Rbf(1), num_latents=1, num_inducing_points=24)
        lmc.fit_scan(method="Adam", max_iter=args.steps)
        mu_lmc, var_lmc = lmc.predict_y(x)
        lmc_rmse = float(np.sqrt(np.mean((mu_lmc - y) ** 2)))
        print(f"LMC train RMSE: {lmc_rmse:.4f}")
        W = lmc.W.value.detach().cpu().numpy()
        ratio = float(W[1, 0] / W[0, 0])
        print(f"LMC mixing ratio (true -2): {ratio:+.2f}")
        lpd = float(np.mean(lmc.predict_log_density(x, y)))
        print(f"LMC mean log predictive density: {lpd:+.3f}")

    if not args.no_plot:
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 1, sharex=True)
        for q, ax in enumerate(axes):
            ax.plot(x, y[:, q], "k.", ms=3, label=f"y{q + 1}")
            ax.plot(x, mu_lmc[:, q], "C0", label="LMC mean")
            sd = np.sqrt(var_lmc[:, q])
            ax.fill_between(
                x[:, 0], mu_lmc[:, q] - 2 * sd, mu_lmc[:, q] + 2 * sd, alpha=0.3
            )
            ax.legend()
        plt.show()

    return {"icm_rmse": icm_rmse, "icm_correlation": corr, "lmc_rmse": lmc_rmse, "lmc_ratio": ratio, "lmc_lpd": lpd}


if __name__ == "__main__":
    main()
