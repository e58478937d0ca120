"""1-D GP regression on the PyTorch/CUDA port (twin of
examples/regression_1d.py).

Train an exact GPR or a VFE sparse GP on a noisy sinusoid with a composite
Linear + RBF + Constant kernel, optimize with scipy L-BFGS-B, predict, and
sample.  The Rbf term's Gram is the hand-written Hopper kernel on the card.
--cuda is kept as a no-op flag for drop-in compatibility; --device picks
where the port runs (the card by default).

Run:  python examples_torch/regression_1d.py --model-type GPR --no-plot [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from examples_torch import _runtime  # noqa: E402
from gptorch_tpu_torch import kernels  # noqa: E402
from gptorch_tpu_torch.models import GPR, VFE  # noqa: E402


def get_data(n=100, seed=1534):
    # The JAX script's data: a noisy sinusoid.
    np.random.seed(seed)
    x = np.random.rand(n, 1)
    y = np.sin(10.0 * x) + 1.0 * x + 0.1 * np.random.randn(*x.shape)
    return x, y


def make_model(model_type, x, y):
    dx = x.shape[1]
    kernel = kernels.Linear(dx) + kernels.Rbf(dx) + kernels.Constant(dx)
    if model_type == "GPR":
        return GPR(x, y, kernel)
    if model_type == "VFE":
        return VFE(x, y, kernel)
    raise ValueError(f"Unknown model type {model_type}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-type", type=str, default="GPR", choices=["GPR", "VFE"])
    parser.add_argument("--cuda", action="store_true", help="(no-op; --device picks the device)")
    parser.add_argument("--no-plot", action="store_true")
    _runtime.add_device_argument(parser)
    args = parser.parse_args(argv)

    with _runtime.on_device(args.device) as device:
        x, y = get_data()
        model = make_model(args.model_type, x, y)
        model.optimize(method="L-BFGS-B", max_iter=100)

        x_test = np.linspace(-0.1, 1.1, 201)[:, None]
        mean, var = model.predict_y(x_test)
        samples = model.predict_f_samples(
            x_test, n_samples=5, generator=torch.Generator(device).manual_seed(0)
        )

    print(f"trained {args.model_type}; predictive mean range "
          f"[{mean.min():.3f}, {mean.max():.3f}]")

    if not args.no_plot:
        import matplotlib.pyplot as plt

        std = np.sqrt(var)
        plt.figure(figsize=(9, 5))
        plt.plot(x_test, mean, "C0", label="mean")
        plt.fill_between(
            x_test[:, 0],
            (mean - 2 * std)[:, 0],
            (mean + 2 * std)[:, 0],
            alpha=0.3,
            color="C0",
            label="±2σ",
        )
        for s in samples:
            plt.plot(x_test, s, "C1", lw=0.7, alpha=0.7)
        plt.plot(x, y, "k.", label="data")
        if hasattr(model, "Z"):
            plt.plot(model.Z.value.detach().cpu().numpy(), np.zeros(model.num_inducing), "r^")
        plt.legend()
        plt.show()

    return {"mean_min": float(mean.min()), "mean_max": float(mean.max()), "mean": mean, "var": var,
            "samples": samples, "loss": float(model.loss().detach())}


if __name__ == "__main__":
    main(sys.argv[1:])
