"""Heteroscedastic GP on the PyTorch/CUDA port (twin of
examples/heteroscedastic.py): input-dependent noise via a log-noise latent.

Data whose noise ramps up with x: a homoscedastic GP must compromise on one
noise level; the heteroscedastic model recovers the noise PROFILE and gives
calibrated intervals everywhere.

Run: python examples_torch/heteroscedastic.py [--no-plot] [--n 240] [--steps 3000] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from examples_torch import _runtime  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=240)
    parser.add_argument("--steps", type=int, default=4000)
    parser.add_argument("--no-plot", action="store_true")
    _runtime.add_device_argument(parser)
    args = parser.parse_args(argv)

    from gptorch_tpu_torch import kernels
    from gptorch_tpu_torch.models import SVGP, HeteroscedasticSVGP

    with _runtime.on_device(args.device):
        rng = np.random.RandomState(0)
        x = np.linspace(-3, 3, args.n)[:, None]
        sigma = 0.05 + 0.4 / (1.0 + np.exp(-2.0 * x[:, 0]))  # noise ramps up
        y = np.sin(1.5 * x) + (sigma * rng.randn(args.n))[:, None]

        het = HeteroscedasticSVGP(x, y, kernels.Rbf(1), num_inducing_points=20)
        het.fit_scan(method="Adam", max_iter=args.steps, learning_rate=0.005)
        mu, var = het.predict_y(x)
        mu_g, s_g = het.predict_noise(x)
        noise_sd = np.sqrt(np.exp(mu_g + 0.5 * s_g))
        corr = np.corrcoef(noise_sd, sigma)[0, 1]
        print(f"learned noise sd: {noise_sd[:20].mean():.3f} (left) -> "
              f"{noise_sd[-20:].mean():.3f} (right); true 0.05 -> 0.45")
        print(f"noise-profile correlation with truth: {corr:.3f}")

        hom = SVGP(x, y, kernels.Rbf(1), num_inducing_points=20, jitter=1e-6)
        hom.fit_scan(method="Adam", max_iter=args.steps, learning_rate=0.005)
        lpd_het = float(np.mean(het.predict_log_density(x, y)))
        lpd_hom = float(np.mean(hom.predict_log_density(x, y)))
    print(f"mean log predictive density: heteroscedastic {lpd_het:+.3f} "
          f"vs homoscedastic {lpd_hom:+.3f}")

    if not args.no_plot:
        import matplotlib.pyplot as plt

        sd = np.sqrt(var[:, 0])
        plt.plot(x, y, "k.", ms=3)
        plt.plot(x, mu, "C0")
        plt.fill_between(x[:, 0], mu[:, 0] - 2 * sd, mu[:, 0] + 2 * sd, alpha=0.3)
        plt.title("Heteroscedastic SVGP: ±2σ(y*) tracks the noise ramp")
        plt.show()

    return {"noise_sd_left": float(noise_sd[:20].mean()), "noise_sd_right": float(noise_sd[-20:].mean()),
            "correlation": float(corr), "lpd_het": lpd_het, "lpd_hom": lpd_hom}


if __name__ == "__main__":
    main()
