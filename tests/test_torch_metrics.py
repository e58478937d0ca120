"""The port's predictive metrics and fold-fleet cross-validation
(gptorch_tpu_torch.metrics) against the JAX package, float64 on the CPU,
inputs from numpy seeds.

* every metric (rmse, mae, nlpd, coverage, crps, standardized residuals,
  summarize) equals the JAX package's on the same inputs: 1e-12 relative;
  numpy in gives a tensor, a tensor keeps its dtype;
* the closed forms' own checks, as the JAX package's tests/test_metrics.py:
  CRPS at zero variance is the MAE, coverage of calibrated draws;
* kfold_cv at k = 3, n = 62 (remainder dropped), 20 Adam iterations: the
  same folds and the same per-fold RMSE and NLPD as the JAX package's
  (1e-8), the fleet's members trained independently; k outside [2, n]
  raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import metrics as jax_metrics
from gptorch_tpu_torch import kernels, metrics
from gptorch_tpu_torch.models import GPEnsemble

REL = 1e-12


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture(scope="module")
def preds():
    rng = np.random.RandomState(0)
    mean = rng.randn(2000, 1)
    var = 0.3 + rng.rand(2000, 1)
    y = mean + np.sqrt(var) * rng.randn(2000, 1)  # perfectly calibrated
    var[:3] = 0.0  # CRPS stays finite as σ → 0
    return y, mean, var


def _close(got, want, rel=REL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rel, atol=0)


@pytest.mark.parametrize("name", ["rmse", "mae"])
def test_point_metrics_match_jax(preds, name):
    y, mean, _ = preds
    got = getattr(metrics, name)(y, mean)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    _close(got, getattr(jax_metrics, name)(y, mean))


@pytest.mark.parametrize("name", ["nlpd_gaussian", "crps_gaussian"])
@pytest.mark.parametrize("reduce", [True, False])
def test_probabilistic_metrics_match_jax(preds, name, reduce):
    y, mean, var = preds
    if name == "nlpd_gaussian":
        y, mean, var = y[3:], mean[3:], var[3:]
    got = getattr(metrics, name)(y, mean, var, reduce=reduce)
    _close(got, getattr(jax_metrics, name)(y, mean, var, reduce=reduce))


@pytest.mark.parametrize("level", [0.5, 0.9, 0.95])
def test_coverage_matches_jax(preds, level):
    y, mean, var = preds
    got = metrics.coverage(y, mean, var, level)
    _close(got, jax_metrics.coverage(y, mean, var, level))
    assert float(got) == pytest.approx(level, abs=0.03)


def test_residuals_and_summary_match_jax(preds):
    y, mean, var = (a[3:] for a in preds)
    _close(metrics.standardized_residuals(y, mean, var), jax_metrics.standardized_residuals(y, mean, var))
    got, want = metrics.summarize(y, mean, var), jax_metrics.summarize(y, mean, var)
    assert set(got) == set(want) >= {"rmse", "mae", "nlpd", "crps", "coverage95"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=REL, abs=1e-15), k


def test_tensors_keep_their_dtype(preds):
    y, mean, var = (torch.as_tensor(a[3:], dtype=torch.float32) for a in preds)
    assert metrics.nlpd_gaussian(y.numpy(), mean, var).dtype == torch.float32
    assert metrics.crps_gaussian(y, mean, var, reduce=False).shape == y.shape


def test_crps_degrades_to_mae_at_zero_variance():
    y, m = np.array([1.0, -2.0]), np.array([0.0, 0.0])
    np.testing.assert_allclose(metrics.crps_gaussian(y, m, np.zeros(2), reduce=False).numpy(), np.abs(y - m),
                               rtol=1e-6)


def _cv_data(n=62):
    rng = np.random.RandomState(0)
    x = np.sort(rng.rand(n, 1) * 4 - 2, axis=0)
    return x, np.sin(2 * x) + 0.1 * rng.randn(n, 1)


@pytest.fixture(scope="module")
def jax_cv():
    x, y = _cv_data()
    return jax_metrics.kfold_cv(x, y, lambda: jax_kernels.Rbf(1), k=3, fit_iters=20, seed=0)


def test_kfold_cv_matches_jax(jax_cv):
    x, y = _cv_data()
    got = metrics.kfold_cv(x, y, lambda: kernels.Rbf(1), k=3, fit_iters=20, seed=0, device="cpu")
    assert got["n_used"] == jax_cv["n_used"] == 60
    assert isinstance(got["ensemble"], GPEnsemble) and got["ensemble"].num_members == 3
    np.testing.assert_array_equal(got["ensemble"].X.numpy(), np.asarray(jax_cv["ensemble"].member.X))
    for key in ("fold_rmse", "fold_nlpd"):
        assert isinstance(got[key], np.ndarray) and got[key].shape == (3,)
        _close(got[key], jax_cv[key], rel=1e-8)
    for key in ("rmse_mean", "rmse_std", "nlpd_mean", "nlpd_std"):
        assert got[key] == pytest.approx(jax_cv[key], rel=1e-8), key
    assert np.isfinite(got["fold_nlpd"]).all()
    # each member trained on its own data: the variances differ
    variances = got["ensemble"].member.kernel.variance.value.detach().numpy().ravel()
    assert len(set(np.round(variances, 12))) == 3


def test_kfold_cv_validation():
    x, y = np.zeros((10, 1)), np.zeros((10, 1))
    with pytest.raises(ValueError, match="2 <= k <= n"):
        metrics.kfold_cv(x, y, lambda: kernels.Rbf(1), k=1, device="cpu")
    with pytest.raises(ValueError, match="2 <= k <= n"):
        metrics.kfold_cv(x, y, lambda: kernels.Rbf(1), k=11, device="cpu")


def test_jax_metrics_take_the_ports_output(preds):
    """The port's tensors convert to the JAX package's inputs unchanged."""
    y, mean, var = (a[3:] for a in preds)
    r = metrics.standardized_residuals(y, mean, var).numpy()
    _close(jax_metrics.rmse(jnp.asarray(r), 0.0), metrics.rmse(r, np.zeros_like(r)))
