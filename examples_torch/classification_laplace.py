"""Exact-GP (Laplace) classification on the PyTorch/CUDA port (twin of
examples/classification_laplace.py).

LaplaceGP finds the exact-kernel posterior mode by Newton iteration (GPML
Alg. 3.1) and trains its evidence with ``fit_scan``'s Adam loop; the Rbf
Gram is the hand-written Hopper kernel on the card.

Run:  python examples_torch/classification_laplace.py --no-plot [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from examples_torch import _runtime  # noqa: E402
from gptorch_tpu_torch import kernels, likelihoods  # noqa: E402
from gptorch_tpu_torch.models import LaplaceGP  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--no-plot", action="store_true")
    parser.add_argument("--optimize-iters", type=int, default=60)
    _runtime.add_device_argument(parser)
    args = parser.parse_args(argv)

    with _runtime.on_device(args.device):
        rng = np.random.RandomState(0)
        n = 120
        x = np.sort(rng.uniform(-3, 3, n))[:, None]
        p_true = 1.0 / (1.0 + np.exp(-3.0 * np.sin(1.5 * x)))
        y = (rng.rand(n, 1) < p_true).astype(float)

        model = LaplaceGP(
            x,
            y,
            kernels.Rbf(1, length_scales=1.0),
            likelihood=likelihoods.Bernoulli(link="probit"),
        )
        ev_before = float(model.log_likelihood().detach())
        model.fit_scan(method="Adam", max_iter=args.optimize_iters)
        ev_after = float(model.log_likelihood().detach())

        x_test = np.linspace(-3.5, 3.5, 200)[:, None]
        p, _ = model.predict_y(x_test)
        acc = np.mean((model.predict_y(x)[0] > 0.5) == (y > 0.5))
    print(
        f"Laplace evidence: {ev_before:.3f} -> {ev_after:.3f}; "
        f"train accuracy: {acc:.3f}; p range [{p.min():.3f}, {p.max():.3f}]"
    )

    if not args.no_plot:
        import matplotlib.pyplot as plt

        plt.figure(figsize=(9, 4))
        plt.plot(x_test, p, "C0", label="Laplace p(y=1)")
        plt.plot(x, y, "k.", alpha=0.5, label="data")
        plt.plot(x_test, 1.0 / (1.0 + np.exp(-3.0 * np.sin(1.5 * x_test))),
                 "C2--", label="truth")
        plt.legend()
        plt.show()

    return {"evidence_before": ev_before, "evidence_after": ev_after, "accuracy": float(acc),
            "p_min": float(p.min()), "p_max": float(p.max())}


if __name__ == "__main__":
    main(sys.argv[1:])
