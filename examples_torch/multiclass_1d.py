"""1-D multiclass GP classification, SVGP + Softmax likelihood, on the
PyTorch/CUDA port (twin of examples/multiclass_1d.py).

Three latent GPs (one per class) trained jointly through the closed-form
log-sum-exp variational bound; predictions are MacKay-moderated softmax
probabilities.

Run:  python examples_torch/multiclass_1d.py --no-plot [--device cpu]
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
    parser.add_argument("--steps", type=int, default=800)
    _runtime.add_device_argument(parser)
    args = parser.parse_args(argv)

    with _runtime.on_device(args.device):
        rng = np.random.RandomState(0)
        n, C = 240, 3
        x = np.sort(rng.uniform(-3, 3, n))[:, None]
        labels = np.clip(
            np.digitize(np.sin(1.2 * x[:, 0]) + 0.2 * rng.randn(n), [-0.4, 0.4]),
            0, 2,
        )

        lik = likelihoods.Softmax(C)
        y = lik.one_hot(labels, C).numpy()
        model = SVGP(
            x, y, kernels.Rbf(1, length_scales=1.0), likelihood=lik,
            num_inducing_points=24, jitter=1e-6,
        )
        model.fit_scan(method="Adam", max_iter=args.steps)

        p, _ = model.predict_y(x)
        acc = float(np.mean(np.argmax(p, axis=1) == labels))
        print(
            f"train accuracy: {acc:.3f}; "
            f"probability rows sum to {p.sum(axis=1).min():.6f}..{p.sum(axis=1).max():.6f}"
        )

        if not args.no_plot:
            import matplotlib.pyplot as plt

            xt = np.linspace(-3.2, 3.2, 300)[:, None]
            pt, _ = model.predict_y(xt)
            plt.figure(figsize=(9, 4))
            for c in range(C):
                plt.plot(xt, pt[:, c], label=f"p(class {c})")
            plt.scatter(x, labels / (C - 1), c="k", s=8, alpha=0.4, label="labels")
            plt.legend()
            plt.show()

    return {"accuracy": acc, "row_sum_min": float(p.sum(axis=1).min()), "row_sum_max": float(p.sum(axis=1).max())}


if __name__ == "__main__":
    main(sys.argv[1:])
