#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gptorch_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Builds every hand-written kernel from the sources in the checkout.
2. Kernel phase: each kernel against its plain PyTorch twin on the card, at
   the shapes the serving path gives it, in float32 and float64, with its
   time (CUDA events, warm), the plain version's time and the least time the
   card could take (bytes over 3.35 TB/s or operations over the peak rate,
   whichever is larger).
3. Serving phase: the port's exact-GP serving path at the flagship width,
   n = 32768, d = 8, Rbf-ARD, Gaussian(0.1), fixed jitter, float32:
   GPR -> posterior() -> for_serving() -> 8 batches of 256 queries through
   predict_f and mean_only.  Kernel launch counters are zeroed just before
   and read just after; every kernel of the path must have launched.
   Checks: finite outputs, serving vs the triangular-solve posterior, and a
   float64 rerun at n = 4096 where the card's route and the CPU's plain
   route agree to 1e-8.

Any failed check exits non-zero.  Without a CUDA card it exits 2 and prints
no result.  Lines starting with "#" report each measurement; the line
before the last holds the per-kernel numbers as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # H100 SXM, outside the tensor cores
N, D, Q, BATCHES = 32768, 8, 256, 8
TOL = {"float32": 2e-5, "float64": 1e-12}  # kernel vs plain, absolute, per unit of var
# Serving (L⁻¹ products) vs the posterior's triangular solves, float32, in
# absolute units of the moments (both O(1) here): f32 roundoff (6e-8)
# amplified by cond(K) <= (n·E[k] + σ²)/σ² ≈ 2e4 for this data gives
# ~1.2e-3; the bound leaves a factor 4.
SERVING_TOL = 5e-3
F64_REL_TOL = 1e-8


class CheckFailed(Exception):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0] if out else "unknown"


def time_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` warm calls (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def gram_bound_ms(n1, n2, d, sym, dtype_name, itemsize):
    """Least time for the radial Gram: each input read once, the output
    written once; 3d + 3 operations per output (d differences, d fused
    multiply-adds counted as two, the scale, the exp, the variance)."""
    bytes_moved = ((n1 if sym else n1 + n2) * d + 2 + n1 * n2) * itemsize
    ops = n1 * n2 * (3 * d + 3)
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase(torch, gram):
    cases = [
        ("sym+diag", N, N, True),
        ("cross", N, Q, False),
        ("cross", Q, N, False),
        ("ragged", 4099, 1031, False),
    ]
    rows = []
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).replace("torch.", "")
        gen = torch.Generator(device="cuda").manual_seed(1234)
        for label, n1, n2, sym in cases:
            ell = torch.rand(D, generator=gen, device="cuda", dtype=dtype) + 0.5
            x1 = (torch.randn(n1, D, generator=gen, device="cuda", dtype=dtype) / ell).contiguous()
            x2 = None if sym else (torch.randn(n2, D, generator=gen, device="cuda", dtype=dtype) / ell).contiguous()
            var = torch.full((), 1.3, device="cuda", dtype=dtype)
            diag = torch.full((), 0.1, device="cuda", dtype=dtype) if sym else None
            with torch.no_grad():
                k = gram.rbf_gram(x1, x2, var=var, diag=diag)
                torch.cuda.synchronize()
                p = gram.rbf_gram_plain(x1, x2, var, diag)
                err = float((k - p).abs().max())
                del k, p
                big = n1 * n2 >= N * N
                ms = time_ms(lambda: gram.rbf_gram(x1, x2, var=var, diag=diag), 10 if big else 50)
                plain_ms = time_ms(lambda: gram.rbf_gram_plain(x1, x2, var, diag), 3 if big else 20)
            torch.cuda.empty_cache()
            bound, bound_by = gram_bound_ms(n1, n2, D, sym, name, x1.element_size())
            tol = TOL[name] * 1.3
            row = {
                "case": label, "dtype": name, "n1": n1, "n2": n2, "d": D,
                "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": bound_by,
            }
            print(f"# kernel rbf_gram {label:8s} {name} ({n1}, {n2}) d={D}: "
                  f"max|kernel-plain|={err:.3e} (tol {tol:.1e}) kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})", flush=True)
            check(err <= tol, f"rbf_gram {label} {name} ({n1},{n2}) error {err} > {tol}")
            rows.append(row)
    return rows


@contextlib.contextmanager
def default_dtype(torch, dtype):
    old = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


def make_data(n, d, dtype, seed=0):
    """bench_serving.py's data: x ~ N(0, I), y = sin(x_0) + 0.1·noise, and
    BATCHES query batches of Q points."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(dtype)
    y = (np.sin(x[:, :1]) + 0.1 * rng.randn(n, 1)).astype(dtype)
    xq = [rng.randn(Q, d).astype(dtype) for _ in range(BATCHES)]
    return x, y, xq


def serving_phase(torch, gram):
    from gptorch_tpu_torch import kernels, likelihoods, settings
    from gptorch_tpu_torch.models import GPR

    x, y, xq = make_data(N, D, np.float32)
    out = {"n": N, "d": D, "q": Q, "batches": BATCHES, "dtype": "float32"}
    with settings.override(jitter_policy="fixed"):
        model = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1))
        check(model.device.type == "cuda", "GPR did not land on the card")
        gram.rbf_gram.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        post = model.posterior()
        torch.cuda.synchronize()
        out["factorize_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        serving = post.for_serving()
        torch.cuda.synchronize()
        out["convert_ms"] = 1e3 * (time.perf_counter() - t0)
        predict_ms, mean_ms = [], []
        means, variances, mean_only = [], [], []
        for xb in xq:
            t0 = time.perf_counter()
            mu, var = serving.predict_f(xb)
            predict_ms.append(1e3 * (time.perf_counter() - t0))
            t0 = time.perf_counter()
            m = serving.mean_only(xb)
            mean_ms.append(1e3 * (time.perf_counter() - t0))
            means.append(mu), variances.append(var), mean_only.append(m)
        out["launches"] = {"rbf_gram": gram.rbf_gram.launches}
        out["predict_f_ms"] = predict_ms
        out["mean_only_ms"] = mean_ms
        check(gram.rbf_gram.launches > 0, "the serving path never launched rbf_gram")
        mu, var, m = np.concatenate(means), np.concatenate(variances), np.concatenate(mean_only)
        out["finite"] = bool(np.isfinite(mu).all() and np.isfinite(var).all() and np.isfinite(m).all())
        check(out["finite"], "non-finite serving output")
        check(mu.shape == (Q * BATCHES, 1) and var.shape == mu.shape, "wrong output shape")

        trtrs_ms, ref_mu, ref_var = [], [], []
        for xb in xq:
            t0 = time.perf_counter()
            a, b = post.predict_f(xb)
            trtrs_ms.append(1e3 * (time.perf_counter() - t0))
            ref_mu.append(a), ref_var.append(b)
        ref_mu, ref_var = np.concatenate(ref_mu), np.concatenate(ref_var)
        out["trtrs_predict_f_ms"] = trtrs_ms
        out["serving_vs_trtrs"] = {
            "mean_max_abs": float(np.abs(mu - ref_mu).max()),
            "var_max_abs": float(np.abs(var - ref_var).max()),
            "mean_only_max_abs": float(np.abs(m - mu).max()),
            "tol": SERVING_TOL,
        }
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["stages_ms"] = stage_breakdown(torch, model, post, serving, xq[0])
        del model, post, serving
        torch.cuda.empty_cache()
    agree = out["serving_vs_trtrs"]
    print(f"# serving n={N} d={D} f32: factorize {out['factorize_ms']:.1f} ms, "
          f"convert {out['convert_ms']:.1f} ms, predict_f per batch of {Q} "
          f"median {np.median(predict_ms):.3f} ms, mean_only median {np.median(mean_ms):.3f} ms, "
          f"trtrs predict_f median {np.median(trtrs_ms):.3f} ms, rbf_gram launches "
          f"{out['launches']['rbf_gram']}, outputs finite {out['finite']}; serving vs trtrs max abs: mean "
          f"{agree['mean_max_abs']:.3e}, var {agree['var_max_abs']:.3e}, mean_only "
          f"{agree['mean_only_max_abs']:.3e} (tol {SERVING_TOL})", flush=True)
    for key in ("mean_max_abs", "var_max_abs", "mean_only_max_abs"):
        check(agree[key] <= SERVING_TOL, f"serving vs trtrs {key} {agree[key]} > {SERVING_TOL}")
    out["f64_rerun"] = f64_rerun(torch, kernels, likelihoods, settings, GPR, gram)
    return out


def stage_breakdown(torch, model, post, serving, xb):
    """Warm CUDA-event times of the serving path's stages, one by one, on
    the objects the main run built (after its launch counts were read)."""
    from gptorch_tpu_torch.functions import cholesky, trtrs
    from gptorch_tpu_torch.ops.blocked import blocked_trtri

    with torch.no_grad():
        xq = torch.as_tensor(xb, device=model.device)
        K = model._compute_kyy()
        k_xs = model.kernel.K(model.X, xq)
        stages = {
            "posterior: Gram K(X,X)+noise (rbf_gram)": (model._compute_kyy, 5),
            "posterior: cholesky": (lambda: cholesky(K), 2),
            "posterior: trtrs V": (lambda: trtrs(model.Y, post.L), 5),
            "for_serving: blocked_trtri": (lambda: blocked_trtri(post.L), 2),
            "predict: cross Gram K(X,x*) (rbf_gram)": (lambda: model.kernel.K(model.X, xq), 20),
            "predict: Linv @ k": (lambda: serving.Linv @ k_xs, 20),
            "predict: k.T @ alpha": (lambda: k_xs.T @ serving.alpha, 20),
            "trtrs posterior predict: L^-1 k": (lambda: trtrs(k_xs, post.L), 20),
        }
        times = {name: time_ms(fn, reps) for name, (fn, reps) in stages.items()}
        del K, k_xs
    for name, ms in times.items():
        print(f"# stage {name}: {ms:.3f} ms", flush=True)
    return times


def f64_rerun(torch, kernels, likelihoods, settings, GPR, gram):
    """n = 4096 in float64: the card's route (kernel + cuSOLVER/cuBLAS) and
    the CPU's plain route on the same data must agree to 1e-8."""
    n = 4096
    x, y, xq = make_data(n, D, np.float64, seed=1)
    results = {}
    with default_dtype(torch, torch.float64), settings.override(jitter_policy="fixed"):
        before = gram.rbf_gram.launches
        for device in ("cuda", "cpu"):
            model = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1), device=device)
            serving = model.posterior().for_serving()
            mu, var = serving.predict_f(xq[0])
            results[device] = (mu, var, serving.mean_only(xq[0]))
        launched = gram.rbf_gram.launches - before
    rel = max(
        float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))
        for a, b in zip(results["cuda"], results["cpu"])
    )
    print(f"# f64 rerun n={n}: card vs CPU plain route max rel diff {rel:.3e} "
          f"(tol {F64_REL_TOL}), rbf_gram launches {launched}", flush=True)
    check(launched > 0, "the f64 card route never launched rbf_gram")
    check(rel <= F64_REL_TOL, f"f64 card vs CPU route {rel} > {F64_REL_TOL}")
    return {"n": n, "max_rel_diff": rel, "tol": F64_REL_TOL, "launches": launched}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from gptorch_tpu_torch.ops import _build, gram

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build(["rbf_gram"])
    gram._kernel_library()
    build_s = time.perf_counter() - t0
    print(f"# build {build_s:.2f} s", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"# nvcc {name}: {line.strip()}", flush=True)

    rows = kernel_phase(torch, gram)
    serving = serving_phase(torch, gram)

    main_row = rows[0]
    kernels_line = {"kernels": [{
        "name": "rbf_gram",
        "route": "cuda",
        "source": "gptorch_tpu_torch/csrc/rbf_gram.cu",
        "replaces": "gptorch_tpu/ops/pallas_gram.py:40",
        "launches": serving["launches"]["rbf_gram"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "shape": [main_row["n1"], main_row["n2"], D],
        "dtype": main_row["dtype"],
    }]}
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, peak device memory "
          f"{serving['peak_mem_gb']:.1f} GB", flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: check failed: {exc}", file=sys.stderr)
        sys.exit(1)
