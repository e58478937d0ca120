"""Online GP regression on a data stream (StreamingVFE + GPEnsemble) on the
PyTorch/CUDA port (twin of examples/streaming_gp.py).

Fit hyperparameters ONCE on an initial buffer (a random-restart
GPEnsemble fleet: on the card every member's Gram is one batched launch of
the hand-written Hopper kernel), then absorb the live stream through
``StreamingVFE.update`` -- O(m²) state, exact batch-VFE posterior over
everything seen, no stored data -- and replay the whole stream as one
captured CUDA graph on the card (one eager loop on the CPU).

Run: python examples_torch/streaming_gp.py [--no-plot] [--batches 30] [--device cpu]
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
    parser.add_argument("--batches", type=int, default=30)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--no-plot", action="store_true")
    _runtime.add_device_argument(parser)
    args = parser.parse_args(argv)

    from gptorch_tpu_torch import ekernels, likelihoods
    from gptorch_tpu_torch.models import GPEnsemble, OnlineSGPR, StreamingVFE, VFE

    with _runtime.on_device(args.device) as device:
        rng = np.random.RandomState(0)
        f = lambda x: np.sin(6.0 * x) + 0.5 * np.cos(17.0 * x)  # noqa: E731
        make_batch = lambda b: (  # noqa: E731
            (x := rng.rand(b, 1)),
            f(x) + 0.1 * rng.randn(b, 1),
        )

        # 1) hyperparameters from an initial buffer, via a random-restart
        #    fleet: 6 GPRs with diversified inits train in one loop.
        x0, y0 = make_batch(256)
        fleet = GPEnsemble(
            np.repeat(x0[None], 6, axis=0),
            np.repeat(y0[None], 6, axis=0),
            ekernels.Rbf(1),
        ).diversify(torch.Generator(device).manual_seed(0), scale=0.7)
        fleet.fit(max_iter=300, learning_rate=0.05)
        best, idx = fleet.best()
        best_loss = float(best.loss().detach())
        spread = float(np.ptp(fleet.losses().detach().cpu().numpy()))
        print(
            f"restart fleet: best member {idx}, NLML {best_loss:.2f} "
            f"(spread {spread:.2f} across restarts)"
        )

        # 2) stream: absorb batches at the fitted hyperparameters.
        z = np.linspace(0.0, 1.0, 30)[:, None]
        model = StreamingVFE(
            best.kernel, z, likelihood=best.likelihood, jitter=1e-6
        )
        model = model.update(x0, y0)
        xs_all, ys_all = [x0], [y0]
        for _ in range(args.batches):
            xb, yb = make_batch(args.batch_size)
            model = model.update(xb, yb)
            xs_all.append(xb)
            ys_all.append(yb)
        n_total = int(float(model.n_seen))

        # exactness: the streamed posterior == batch VFE on ALL the data
        x_cat = np.concatenate(xs_all)
        y_cat = np.concatenate(ys_all)
        batch = VFE(
            x_cat, y_cat, model.kernel, inducing_points=z,
            likelihood=model.likelihood, jitter=1e-6,
        )
        ls, lb = float(model.log_likelihood().detach()), float(batch.log_likelihood().detach())
        rel = abs(ls - lb) / abs(lb)
        print(
            f"streamed {n_total} points in {args.batches + 1} batches: "
            f"bound {ls:.2f} vs batch VFE {lb:.2f} "
            f"(rel diff {rel:.1e})"
        )

        # 3) the same stream as one captured CUDA graph (replay / backfill path)
        bs = args.batch_size
        n_scan = (len(x_cat) // bs) * bs
        dtype = model.Z.dtype
        cx = torch.as_tensor(x_cat[:n_scan].reshape(-1, bs, 1), dtype=dtype, device=device)
        cy = torch.as_tensor(y_cat[:n_scan].reshape(-1, bs, 1), dtype=dtype, device=device)
        fresh = StreamingVFE(
            model.kernel, z, likelihood=model.likelihood, jitter=1e-6
        )

        def replay(cx, cy):
            s = fresh
            for i in range(cx.shape[0]):
                s = s.update(cx[i], cy[i])
            return s.log_likelihood()

        scanned = float(_runtime.Compiled(replay, cx, cy)(cx, cy))
        print(
            f"scan replay of {n_scan} points: bound "
            f"{scanned:.2f} ({_runtime.mechanism(device)})"
        )

        # 4) held-out accuracy from the streamed state
        xq = np.linspace(0.0, 1.0, 400)[:, None]
        mu, var = model.predict_y(xq)
        rmse = float(np.sqrt(np.mean((mu - f(xq)) ** 2)))
        cover = float(np.mean(np.abs(f(xq) - mu) <= 2.0 * np.sqrt(var)))
        print(f"streamed posterior: RMSE {rmse:.3f}, 2sigma coverage {cover:.0%}")

        # 5) when hyperparameters must ADAPT while streaming (StreamingVFE
        #    holds them fixed), OnlineSGPR carries the old posterior as
        #    pseudo-observations and keeps training θ per batch (Bui 2017):
        online = OnlineSGPR(
            ekernels.Rbf(1, length_scales=1.0),  # deliberately misspecified
            z,
            likelihood=likelihoods.Gaussian(0.5),
            jitter=1e-6,
        )
        for i in range(6):
            xb, yb = make_batch(args.batch_size)
            online.step(xb, yb, fit_iters=60)
        mu_o, var_o = online.predict_y(xq)
        rmse_o = float(np.sqrt(np.mean((mu_o - f(xq)) ** 2)))
        noise_o = float(online.likelihood.variance.value.detach().reshape(()))
        print(
            f"online-adaptive posterior: RMSE {rmse_o:.3f}, learned noise "
            f"{noise_o:.4f} (true 0.01) after 6 adaptive steps from a "
            "misspecified start"
        )

    if not args.no_plot:
        import matplotlib.pyplot as plt

        sd = np.sqrt(var[:, 0])
        plt.plot(x_cat, y_cat, "k.", ms=2, alpha=0.2)
        plt.plot(xq, f(xq), "k--", lw=1)
        plt.plot(xq, mu, "C0")
        plt.fill_between(xq[:, 0], mu[:, 0] - 2 * sd, mu[:, 0] + 2 * sd, alpha=0.3)
        plt.title(f"StreamingVFE after {n_total} streamed points")
        plt.show()

    return {"best_member": idx, "best_nlml": best_loss, "spread": spread, "n_total": n_total, "bound": ls,
            "batch_bound": lb, "rel_diff": rel, "replay_bound": scanned, "rmse": rmse, "coverage": cover,
            "online_rmse": rmse_o, "online_noise": noise_o}


if __name__ == "__main__":
    main()
