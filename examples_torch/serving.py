"""Production serving on the PyTorch/CUDA port (twin of examples/serving.py):
train once, export a GEMM-only posterior, serve.

1. train an exact GP (``fit_scan``: on the card the optimizer's step is one
   captured CUDA graph, replayed; at n >= 4096 every step runs the fused
   NLML, whose Gram and backward contraction are the hand-written Hopper
   kernels),
2. ``model.posterior().for_serving()`` -- one extra n³/3 materializes L⁻¹
   so every later predict is products only (no triangular solve on the
   serving path),
3. checkpoint the serving posterior to disk (a temporary directory),
4. in the "server": load it, capture the predict as one CUDA graph on the
   card (the eager call on the CPU) and answer query batches at GEMM
   latency; ``mean_only`` when no error bars are needed (no n² work).

Run: python examples_torch/serving.py [--n 4096] [--no-plot] [--device cpu]
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

from examples_torch import _runtime  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=4096)
    parser.add_argument("--queries", type=int, default=256)
    parser.add_argument("--no-plot", action="store_true")
    _runtime.add_device_argument(parser)
    args = parser.parse_args(argv)

    from gptorch_tpu_torch import kernels, likelihoods, settings
    from gptorch_tpu_torch.models import GPR
    from gptorch_tpu_torch.training import checkpoint

    with _runtime.on_device(args.device) as device:
        rng = np.random.RandomState(0)
        x = rng.uniform(-3, 3, (args.n, 2)).astype(np.float32)
        y = (
            np.sin(x[:, :1]) * np.cos(0.5 * x[:, 1:])
            + 0.05 * rng.randn(args.n, 1)
        ).astype(np.float32)

        # ---- 1. train ------------------------------------------------------
        model = GPR(
            x, y, kernels.Rbf(2, ARD=True),
            likelihood=likelihoods.Gaussian(0.05),
        )
        losses = model.fit_scan(max_iter=60, learning_rate=0.05)
        print(f"trained: NLML {float(losses[0]):.1f} -> {float(losses[-1]):.1f}")

        # ---- 2. export -----------------------------------------------------
        serving = model.posterior().for_serving()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "_serving_posterior.npz")
            checkpoint.save(path, serving)
            size_mb = os.path.getsize(path) / 1e6
            print(f"exported serving posterior: {size_mb:.1f} MB")

            # ---- 3. "server": load + capture + answer ----------------------
            restored = checkpoint.load(path, serving)

        xq = torch.as_tensor(rng.uniform(-3, 3, (args.queries, 2)).astype(np.float32),
                             dtype=settings.default_float(), device=device)
        serve = _runtime.Compiled(restored.predict_y, xq)
        serve_mean = _runtime.Compiled(restored.mean_only, xq)
        mu, var = serve(xq)
        _ = float(torch.sum(mu))

        times = []
        for i in range(20):
            t0 = _runtime.clock(device)
            mu, var = serve(xq + 1e-4 * i)
            _ = float(torch.sum(mu)) + float(torch.sum(var))
            times.append(_runtime.clock(device) - t0)
        serve_ms = min(times) * 1e3
        print(
            f"serve (mean+var, batch {args.queries}): "
            f"{serve_ms:.2f} ms/batch"
        )

        _ = serve_mean(xq)
        times = []
        for i in range(20):
            t0 = _runtime.clock(device)
            m_only = serve_mean(xq + 1e-4 * i)
            _ = float(torch.sum(m_only))
            times.append(_runtime.clock(device) - t0)
        mean_ms = min(times) * 1e3
        print(f"serve (mean only): {mean_ms:.2f} ms/batch")

        # sanity: served moments match the model's own predict
        xq_host = xq.cpu().numpy()
        mu = mu.cpu().numpy()
        mu_m, var_m = model.predict_y(xq_host)
        err = float(np.max(np.abs(mu - mu_m)) / (np.max(np.abs(mu_m)) + 1e-12))
        print(f"serving vs model predict max rel err: {err:.2e}")
        assert err < 1e-2  # f32 factorization roundoff

    if not args.no_plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        sc = ax.scatter(xq_host[:, 0], xq_host[:, 1], c=mu[:, 0], cmap="viridis", s=18)
        fig.colorbar(sc, label="served mean")
        ax.set_title("served GP mean over query batch")
        fig.savefig("serving.png", dpi=100)
        print("wrote serving.png")

    losses = losses.detach().cpu().numpy()
    return {"nlml_first": float(losses[0]), "nlml_last": float(losses[-1]), "losses": losses,
            "exported_mb": size_mb, "serve_ms": serve_ms, "mean_only_ms": mean_ms, "err": err, "mu": mu,
            "var": var.cpu().numpy(), "mean_only": m_only.cpu().numpy()}


if __name__ == "__main__":
    main()
