"""Predictive-evaluation metrics for GP models.

Counterpart of ``gptorch_tpu/metrics.py``: the standard held-out scores of
probabilistic regression, computed from (mean, variance) predictions, and
k-fold cross-validation of an exact GP trained as one fleet.  The scores
take broadcastable tensors or numpy arrays (numpy takes the dtype and
device of the first tensor argument, else stays float64 on the CPU),
return tensors, and reduce over all elements unless ``reduce=False``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "rmse",
    "mae",
    "nlpd_gaussian",
    "coverage",
    "crps_gaussian",
    "standardized_residuals",
    "summarize",
    "kfold_cv",
]

_SQRT2 = math.sqrt(2.0)
_INV_SQRT_PI = 1.0 / math.sqrt(math.pi)


def _as_tensors(*values):
    """``values`` as tensors on the dtype and device of the first tensor
    among them (numpy's own dtype on the CPU when none is)."""
    ref = next((v for v in values if isinstance(v, torch.Tensor)), None)
    if ref is None:
        return tuple(torch.as_tensor(np.asarray(v)) for v in values)
    return tuple(torch.as_tensor(v if isinstance(v, torch.Tensor) else np.asarray(v), dtype=ref.dtype,
                                 device=ref.device) for v in values)


def _norm_pdf(z):
    return torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _norm_cdf(z):
    return 0.5 * (1.0 + torch.erf(z / _SQRT2))


def rmse(y_true, mean):
    """Root mean squared error."""
    y_true, mean = _as_tensors(y_true, mean)
    return torch.sqrt(torch.mean(torch.square(y_true - mean)))


def mae(y_true, mean):
    """Mean absolute error."""
    y_true, mean = _as_tensors(y_true, mean)
    return torch.mean(torch.abs(y_true - mean))


def nlpd_gaussian(y_true, mean, var, reduce=True):
    """Negative log predictive density under N(mean, var) -- the
    calibration-sensitive score (− test log-likelihood)."""
    y_true, mean, var = _as_tensors(y_true, mean, var)
    out = 0.5 * (torch.log(2.0 * math.pi * var) + torch.square(y_true - mean) / var)
    return torch.mean(out) if reduce else out


def coverage(y_true, mean, var, level: float = 0.95):
    """Fraction of y_true inside the central ``level`` predictive interval;
    calibrated models return ≈ level."""
    y_true, mean, var = _as_tensors(y_true, mean, var)
    sd = torch.sqrt(var)
    z = _SQRT2 * torch.special.erfinv(torch.as_tensor(level, dtype=sd.dtype, device=sd.device))
    return torch.mean((torch.abs(y_true - mean) <= z * sd).to(sd.dtype))


def crps_gaussian(y_true, mean, var, reduce=True):
    """Continuously ranked probability score of Gaussian predictions
    (Gneiting & Raftery 2007, eq. 21):

        CRPS = σ [ z(2Φ(z) − 1) + 2φ(z) − 1/√π ],  z = (y − μ)/σ

    in the err-factored form err·(2Φ(z) − 1) + σ(2φ(z) − 1/√π), which stays
    finite as σ → 0 (it tends to |err|, the MAE)."""
    y_true, mean, var = _as_tensors(y_true, mean, var)
    sd = torch.sqrt(var)
    err = y_true - mean
    z = err / torch.clamp(sd, min=torch.finfo(sd.dtype).tiny)
    out = err * (2.0 * _norm_cdf(z) - 1.0) + sd * (2.0 * _norm_pdf(z) - _INV_SQRT_PI)
    return torch.mean(out) if reduce else out


def standardized_residuals(y_true, mean, var):
    """(y − μ)/σ -- about N(0, 1) elementwise for a calibrated model."""
    y_true, mean, var = _as_tensors(y_true, mean, var)
    return (y_true - mean) / torch.sqrt(var)


def kfold_cv(
    x,
    y,
    kernel_factory,
    k: int = 5,
    likelihood_factory=None,
    mean_function=None,
    fit_iters: int = 300,
    learning_rate: float = 0.05,
    method: str = "Adam",
    seed: int = 0,
    **gpr_kwargs,
):
    """k-fold cross-validation of an exact GP, the k fold models trained and
    evaluated as one :class:`~gptorch_tpu_torch.models.GPEnsemble`: on the
    card an Rbf's k training Grams are one batched launch of the Gram
    kernel, and ``fit_scan`` trains the fleet (a captured CUDA graph where
    :func:`~gptorch_tpu_torch.training.fit.captures` says so).

    Rows are shuffled by ``np.random.RandomState(seed)`` and the remainder
    ``n mod k`` rows are dropped (the fleet needs equal fold sizes), as in
    the JAX package, so both take the same folds.

    :param kernel_factory: zero-argument callable returning a fresh kernel.
    :param likelihood_factory: optional zero-argument likelihood callable.
    :param gpr_kwargs: forwarded to the members' GPR (``device``, ...).
    :return: dict with the per-fold arrays (``fold_rmse``, ``fold_nlpd``),
        their means and standard deviations, ``n_used`` and the trained
        ``ensemble``.
    """
    from .models import GPEnsemble

    x = np.asarray(x)
    y = np.asarray(y)
    if y.ndim == 1:
        y = y[:, None]
    n = x.shape[0]
    if k < 2 or k > n:
        raise ValueError(f"need 2 <= k <= n, got k={k}, n={n}")
    fold = n // k
    perm = np.random.RandomState(seed).permutation(n)[: k * fold].reshape(k, fold)
    train_idx = np.stack([np.delete(perm, i, axis=0).reshape(-1) for i in range(k)])  # (k, (k-1)*fold)

    ens = GPEnsemble(
        x[train_idx],
        y[train_idx],
        kernel_factory(),
        likelihood=likelihood_factory() if likelihood_factory else None,
        mean_function=mean_function,
        **gpr_kwargs,
    )
    ens.fit(method=method, max_iter=fit_iters, learning_rate=learning_rate, scan=True)

    x_te, y_te = (torch.as_tensor(a[perm], dtype=ens.X.dtype, device=ens.device) for a in (x, y))
    with torch.no_grad():
        mean_b, var_b = ens.predict_y(x_te)  # (k, fold, dy)
        fold_rmse = torch.sqrt(torch.mean(torch.square(y_te - mean_b), dim=(1, 2))).cpu().numpy()
        fold_nlpd = torch.mean(nlpd_gaussian(y_te, mean_b, var_b, reduce=False), dim=(1, 2)).cpu().numpy()
    return {
        "fold_rmse": fold_rmse,
        "fold_nlpd": fold_nlpd,
        "rmse_mean": float(fold_rmse.mean()),
        "rmse_std": float(fold_rmse.std()),
        "nlpd_mean": float(fold_nlpd.mean()),
        "nlpd_std": float(fold_nlpd.std()),
        "n_used": int(k * fold),
        "ensemble": ens,
    }


def summarize(y_true, mean, var, level: float = 0.95) -> dict:
    """All metrics at once, as Python floats: rmse, mae, nlpd, crps,
    coverage and the standardized-residual moments."""
    y_true, mean, var = _as_tensors(y_true, mean, var)
    r = standardized_residuals(y_true, mean, var)
    return {
        "rmse": float(rmse(y_true, mean)),
        "mae": float(mae(y_true, mean)),
        "nlpd": float(nlpd_gaussian(y_true, mean, var)),
        "crps": float(crps_gaussian(y_true, mean, var)),
        f"coverage{int(level * 100)}": float(coverage(y_true, mean, var, level)),
        "resid_mean": float(torch.mean(r)),
        "resid_std": float(torch.std(r, correction=0)),
    }
