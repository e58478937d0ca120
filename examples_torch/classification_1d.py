"""1-D GP classification with SVGP + Bernoulli likelihood on the PyTorch/CUDA
port (twin of examples/classification_1d.py).

Variational GP classification with a probit (or logit) link, trained with
``fit_scan``'s Adam loop; every Kuu and Kuf is the hand-written Hopper
Gram on the card.

Run:  python examples_torch/classification_1d.py --no-plot [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from examples_torch import _runtime  # noqa: E402
from gptorch_tpu_torch import kernels, likelihoods  # noqa: E402
from gptorch_tpu_torch.models import SVGP  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--no-plot", action="store_true")
    parser.add_argument("--link", choices=["probit", "logit"], default="probit")
    _runtime.add_device_argument(parser)
    args = parser.parse_args(argv)

    with _runtime.on_device(args.device):
        rng = np.random.RandomState(0)
        n = 120
        x = np.sort(rng.uniform(-3, 3, n))[:, None]
        p_true = 1.0 / (1.0 + np.exp(-3.0 * np.sin(1.5 * x)))
        y = (rng.rand(n, 1) < p_true).astype(float)

        model = SVGP(
            x,
            y,
            kernels.Rbf(1),
            likelihood=likelihoods.Bernoulli(link=args.link),
            num_inducing_points=20,
            jitter=1e-6,
        )
        model.fit_scan(method="Adam", max_iter=1500)

        x_test = np.linspace(-3.5, 3.5, 200)[:, None]
        p, _ = model.predict_y(x_test)
        acc = np.mean((model.predict_y(x)[0] > 0.5) == (y > 0.5))
    print(f"train accuracy: {acc:.3f}; p range [{p.min():.3f}, {p.max():.3f}]")

    if not args.no_plot:
        import matplotlib.pyplot as plt

        plt.figure(figsize=(9, 4))
        plt.plot(x_test, p, "C0", label="p(y=1)")
        plt.plot(x, y, "k.", alpha=0.5, label="data")
        plt.plot(x_test, 1.0 / (1.0 + np.exp(-3.0 * np.sin(1.5 * x_test))), "C2--", label="truth")
        plt.legend()
        plt.show()

    return {"accuracy": float(acc), "p_min": float(p.min()), "p_max": float(p.max())}


if __name__ == "__main__":
    main(sys.argv[1:])
