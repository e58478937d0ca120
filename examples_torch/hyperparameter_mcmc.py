"""Fully-Bayesian GP regression on the PyTorch/CUDA port (twin of
examples/hyperparameter_mcmc.py): HMC over the hyperparameter posterior.

MAP fitting collapses hyperparameter uncertainty to a point; on small data
that understates predictive variance.  This samples the posterior over
(kernel variance, length scale, noise) with ``gptorch_tpu_torch.mcmc`` --
the chains are one batched state, and on the card each transition is a
captured CUDA graph unless the jitter policy's probe reads the host -- and
compares the posterior-mixture predictive against the MAP predictive.

Run:  python examples_torch/hyperparameter_mcmc.py --no-plot [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from examples_torch import _runtime  # noqa: E402
from gptorch_tpu_torch import kernels, likelihoods, mcmc, priors  # noqa: E402
from gptorch_tpu_torch.models import GPR  # noqa: E402
from gptorch_tpu_torch.param import positive_param  # noqa: E402


def make_model(n=30, device=None):
    """The data (n points, deliberately few: hyperparameter uncertainty
    matters here) and the GPR with LogNormal(0, 1) priors on the Matern52
    variance and length scale, on ``device`` (the port's default if None)."""
    rng = np.random.RandomState(0)
    x = np.sort(rng.uniform(-3, 3, n))[:, None]
    y = np.sin(2.0 * x) + 0.25 * rng.randn(n, 1)

    kernel = kernels.Matern52(1, variance=1.0, length_scales=1.0)
    kernel.variance = positive_param(1.0, prior=priors.LogNormal(0.0, 1.0))
    kernel.length_scales = positive_param(
        1.0, prior=priors.LogNormal(0.0, 1.0)
    )
    return x, y, GPR(x, y, kernel, likelihood=likelihoods.Gaussian(variance=0.1), device=device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--no-plot", action="store_true")
    parser.add_argument("--num-samples", type=int, default=300)
    parser.add_argument("--num-warmup", type=int, default=300)
    parser.add_argument("--num-chains", type=int, default=2)
    parser.add_argument(
        "--sampler",
        choices=("hmc", "nuts"),
        default="hmc",
        help="nuts picks trajectory lengths itself (no num_leapfrog)",
    )
    _runtime.add_device_argument(parser)
    args = parser.parse_args(argv)

    with _runtime.on_device(args.device) as device:
        x, y, model = make_model()

        samples, result = mcmc.sample_posterior(
            model,
            torch.Generator(device).manual_seed(0),
            num_samples=args.num_samples,
            num_warmup=args.num_warmup,
            num_chains=args.num_chains,
            num_leapfrog=16,
            sampler=args.sampler,
        )

        ls = samples["kernel.length_scales"]
        rhat = float(mcmc.potential_scale_reduction(ls).max())
        ess = float(mcmc.effective_sample_size(ls).min())
        accept = float(result.accept_prob.mean())
        divergences = int(result.divergent.sum())
        print(
            f"accept={accept:.2f} "
            f"divergences={divergences} "
            f"length-scale posterior: {float(ls.mean()):.3f} +- {float(ls.std()):.3f} "
            f"(R-hat {rhat:.3f}, ESS {ess:.0f})"
        )

        x_test = np.linspace(-4, 4, 120)[:, None]
        mix_mean, mix_var = mcmc.predict_mixture(model, samples, x_test)
        mix_mean, mix_var = mix_mean.cpu().numpy(), mix_var.cpu().numpy()
        map_mean, map_var = model.predict_y(x_test)
        widen = float(np.mean(np.sqrt(mix_var) / np.sqrt(map_var)))
        mean_diff = float(np.abs(mix_mean - map_mean).mean())
    print(
        f"posterior-mixture vs point predictive: mean |diff| "
        f"{mean_diff:.4f}, "
        f"average sigma ratio {widen:.3f} (mixture is wider where it should be)"
    )

    if not args.no_plot:
        import matplotlib.pyplot as plt

        mm, sv = mix_mean, np.sqrt(mix_var)
        plt.figure(figsize=(9, 4))
        plt.fill_between(
            x_test[:, 0], (mm - 2 * sv)[:, 0], (mm + 2 * sv)[:, 0],
            alpha=0.25, label="mixture +-2 sigma",
        )
        plt.plot(x_test, mm, "C0", label="mixture mean")
        plt.plot(x_test, map_mean, "C1--", label="point-estimate mean")
        plt.plot(x, y, "k.", label="data")
        plt.legend()
        plt.show()

    return {"accept": accept, "divergences": divergences, "rhat": rhat, "ess": ess,
            "length_scale_mean": float(ls.mean()), "length_scale_sd": float(ls.std()),
            "mean_diff": mean_diff, "sigma_ratio": widen}


if __name__ == "__main__":
    main(sys.argv[1:])
