"""The port's training (gptorch_tpu_torch.training.fit, GPModel.optimize and
fit_scan) and GPR routing against the JAX package, float64 on the CPU.

Trajectories are compared step by step with fit_optax / fit_scan /
fit_scipy of the JAX package, on the fused radial path (fast=True), with
weights carried across by convert.load_trainable."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu import mean_functions as jax_means
from gptorch_tpu import settings as jax_settings
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.training import fit as jax_fit
from gptorch_tpu_torch import convert, kernels, likelihoods, mean_functions, settings
from gptorch_tpu_torch.models import GPR
from gptorch_tpu_torch.models import gpr as gpr_module
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.training import fit

FIRST_ORDER = ["SGD", "Adam", "Adadelta", "Adagrad", "Adamax", "RMSprop"]


@pytest.fixture
def float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _pair(n=40, seed=0):
    """The same fused-path GPR in both packages."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 2)
    y = np.sin(x[:, :1]) + 0.1 * rng.randn(n, 1)
    common = dict(fast=True, fast_block=16)
    jax_model = JaxGPR(x, y, jax_kernels.Rbf(2, ARD=True), likelihood=jax_likelihoods.Gaussian(0.05), **common)
    model = GPR(x, y, kernels.Rbf(2, ARD=True), likelihood=likelihoods.Gaussian(0.05), device="cpu", **common)
    convert.load_trainable(model, {k: np.asarray(v) for k, v in jax_get_trainable(jax_model).items()})
    assert model._fast_eligible(model.X)
    return jax_model, model


def _assert_same_values(jax_model, model, rtol):
    want = jax_get_trainable(jax_model)
    for path, raw in get_trainable(model).items():
        np.testing.assert_allclose(raw.detach().numpy(), np.asarray(want[path]), rtol=rtol, atol=1e-14)


def _routing_cases():
    n_small, n_big = 100, gpr_module.AUTO_FAST_MIN_N
    W = np.zeros((1, 2))
    return [
        ("rbf small auto", lambda k: k.Rbf(2), None, n_small, None),
        ("rbf big auto", lambda k: k.Rbf(2, ARD=True), None, n_big, None),
        ("rbf small forced", lambda k: k.Rbf(2), None, n_small, True),
        ("rbf big off", lambda k: k.Rbf(2), None, n_big, False),
        ("matern12", lambda k: k.Matern12(2), None, n_big, None),
        ("matern32", lambda k: k.Matern32(2, ARD=True), None, n_big, None),
        ("matern52", lambda k: k.Matern52(2), None, n_big, None),
        ("rq", lambda k: k.RationalQuadratic(2), None, n_big, None),
        ("sum", lambda k: k.Rbf(2) + k.Constant(2), None, n_big, None),
        ("product small", lambda k: k.Rbf(2) * k.Matern32(2), None, n_small, True),
        ("white", lambda k: k.Rbf(2) + k.White(2), None, n_big, None),
        ("linear mean", lambda k: k.Rbf(2), lambda m: m.LinearMean(2, 1, W=W), n_big, None),
        ("constant mean", lambda k: k.Matern32(2), lambda m: m.Constant(1), n_big, True),
    ]


@pytest.mark.parametrize("bijector", ["exp", "softplus"])
@pytest.mark.parametrize("case", _routing_cases(), ids=lambda c: c[0])
def test_routing_matches_jax(case, bijector):
    _, make_kernel, make_mean, n, fast = case
    x, y = np.zeros((n, 2)), np.zeros((n, 1))
    with settings.override(positive_bijector=bijector), jax_settings.override(positive_bijector=bijector):
        jax_model = JaxGPR(
            x, y, make_kernel(jax_kernels), mean_function=make_mean and make_mean(jax_means), fast=fast
        )
        model = GPR(
            x, y, make_kernel(kernels), mean_function=make_mean and make_mean(mean_functions), fast=fast,
            device="cpu",
        )
    assert model._fast_kind() == jax_model._fast_kind()
    assert model._fast_eligible_config() == jax_model._fast_eligible_config()
    assert model._fast_eligible(model.X) == jax_model._fast_eligible(jax_model.X)
    assert model._general_eligible(model.X) == jax_model._general_eligible(jax_model.X)


@pytest.mark.parametrize("method", FIRST_ORDER)
def test_first_order_trajectory_matches_fit_optax(float64, method):
    """optax's update rules: five steps of each method, losses and the
    trained raw values to 1e-8 relative."""
    jax_model, model = _pair()
    jax_trained, want, _ = jax_fit.fit_optax(jax_model, method=method, max_iter=5, verbose=False)
    trained, got, wall = fit.fit_torch(model, method=method, max_iter=5, verbose=False)
    assert trained is model and wall >= 0
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-8)
    _assert_same_values(jax_trained, model, rtol=1e-8)


def test_fit_scan_matches_jax(float64):
    jax_model, model = _pair(seed=1)
    jax_trained, want = jax_fit.fit_scan(jax_model, method="Adam", max_iter=5, learning_rate=0.05)
    got = model.fit_scan("Adam", max_iter=5, learning_rate=0.05)
    assert isinstance(got, torch.Tensor) and got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-8)
    _assert_same_values(jax_trained, model, rtol=1e-8)


def test_fit_scipy_matches_jax(float64):
    jax_model, model = _pair(seed=2)
    jax_trained, want = jax_fit.fit_scipy(jax_model, max_iter=8, disp=False)
    result = model.optimize("L-BFGS-B", max_iter=8, verbose=False)
    assert result.jac.dtype == np.float64
    assert result.nit == want.nit
    assert result.fun == pytest.approx(want.fun, rel=1e-8)
    _assert_same_values(jax_trained, model, rtol=1e-6)


def test_optimize_trains_in_place(float64):
    _, model = _pair(seed=3)
    before = float(model.loss().detach())
    seen = []
    losses, wall = model.optimize("Adam", max_iter=4, verbose=False, callback=lambda i, l: seen.append(i))
    assert losses.shape == (4,) and losses[0] == pytest.approx(before) and seen == [0, 1, 2, 3]
    assert float(model.loss().detach()) < before


def test_unported_and_unknown_methods_raise(float64):
    """LBFGS is ported now (tests/test_torch_lbfgs.py holds it against
    optax): it trains; an unknown method still raises."""
    _, model = _pair()
    losses = model.fit_scan("LBFGS", max_iter=2)
    assert losses.shape == (2,) and bool(torch.isfinite(losses).all()) and float(losses[1]) < float(losses[0])
    with pytest.raises(ValueError):
        fit.make_optimizer("NotAnOptimizer", [torch.zeros(1, requires_grad=True)])


def test_tables_match_jax():
    assert fit.DEFAULT_LEARNING_RATES == jax_fit.DEFAULT_LEARNING_RATES
    assert fit.SCIPY_METHODS == jax_fit.SCIPY_METHODS


def test_nan_guard_probe():
    """Duplicate x rows, Gaussian(1e-12), fast=True, fast_rel_jitter=0 in
    float32: the factorization fails, and training must raise
    FloatingPointError rather than train on NaN."""
    assert torch.get_default_dtype() == torch.float32
    rng = np.random.RandomState(0)
    x = rng.randn(64, 2).astype(np.float32)
    x[32:] = x[:32]
    y = np.sin(x[:, :1]).astype(np.float32)

    def model():
        return GPR(x, y, kernels.Rbf(2), likelihood=likelihoods.Gaussian(1e-12), fast=True,
                   fast_rel_jitter=0.0, fast_block=16, device="cpu")

    with pytest.raises(FloatingPointError, match="non-finite at iteration 0"):
        fit.fit_torch(model(), max_iter=3, verbose=False)
    with pytest.raises(FloatingPointError, match="non-finite at iteration 0"):
        model().fit_scan(max_iter=3)
    with pytest.raises(FloatingPointError, match="fast_jitter"):
        model().loss()
