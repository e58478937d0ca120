"""The port's exact GPR, functions and model base against the JAX package
(float64, CPU).  Weights go across with gptorch_tpu_torch.convert."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import functions as jax_functions
from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu import mean_functions as jax_means
from gptorch_tpu import settings as jax_settings
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu_torch import convert, functions, kernels, likelihoods, mean_functions, settings
from gptorch_tpu_torch.models import GPR

REFERENCE_GPR_LL = -213.268242560154675  # tests/test_models/test_gpr.py


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data():
    rng = np.random.RandomState(0)
    return rng.randn(8, 2), rng.randn(8, 1)


def _np(t):
    return t.detach().numpy()


def test_log_likelihood_anchor():
    x, y = _data()
    model = GPR(x, y, kernels.Rbf(2), device="cpu")
    assert float(model.log_likelihood().detach()) == pytest.approx(REFERENCE_GPR_LL, rel=1e-6)


def test_default_noise_is_population_variance():
    x, y = _data()
    model = GPR(x, y, kernels.Rbf(2), device="cpu")
    jax_model = JaxGPR(x, y, jax_kernels.Rbf(2))
    got = float(model.likelihood.variance.value.detach())
    assert got == pytest.approx(0.001 * y.var(ddof=0), rel=1e-14)
    assert got == pytest.approx(float(jax_model.likelihood.variance.value.reshape(())), rel=1e-14)


def _models(case, n=20, seed=1):
    """The same GPR in both packages, raws perturbed in the JAX model and
    carried across by convert.load_trainable."""
    rng = np.random.RandomState(seed)
    x, y = rng.randn(n, 2), rng.randn(n, 1)
    W, b = np.array([[0.3, -0.2]]), np.array([0.1])
    jk, tk = {
        "rbf": (jax_kernels.Rbf(2), kernels.Rbf(2)),
        "rbf_ard": (jax_kernels.Rbf(2, ARD=True), kernels.Rbf(2, ARD=True)),
        "matern32": (jax_kernels.Matern32(2, ARD=True), kernels.Matern32(2, ARD=True)),
        "sum": (jax_kernels.Rbf(2) + jax_kernels.Constant(2), kernels.Rbf(2) + kernels.Constant(2)),
    }[case]
    jm, tm = {
        "rbf": (None, None),
        "rbf_ard": (jax_means.Constant(1, val=np.array([0.4])), mean_functions.Constant(1, val=np.array([0.4]))),
        "matern32": (jax_means.LinearMean(2, 1, W=W, b=b), mean_functions.LinearMean(2, 1, W=W, b=b)),
        "sum": (None, None),
    }[case]
    jax_model = JaxGPR(x, y, jk, mean_function=jm, likelihood=jax_likelihoods.Gaussian(0.1))
    values = {k: np.asarray(v) for k, v in jax_get_trainable(jax_model).items()}
    values = {k: v + 0.2 * rng.randn(*v.shape) for k, v in values.items()}
    jax_model = jax_with_trainable(jax_model, {k: jnp.asarray(v) for k, v in values.items()})
    model = GPR(x, y, tk, mean_function=tm, likelihood=likelihoods.Gaussian(0.1), device="cpu")
    convert.load_trainable(model, {k: np.asarray(v) for k, v in jax_get_trainable(jax_model).items()})
    return jax_model, model


CASES = ["rbf", "rbf_ard", "matern32", "sum"]


@pytest.mark.parametrize("case", CASES)
def test_log_likelihood_matches_jax(case):
    jax_model, model = _models(case)
    ll = model.log_likelihood()
    assert ll.ndim == 0
    assert float(ll.detach()) == pytest.approx(float(jax_model.log_likelihood()), rel=1e-10)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("what", ["predict_f", "predict_y"])
def test_predictions_match_jax(case, diag, what):
    jax_model, model = _models(case)
    xs = np.random.RandomState(2).randn(6, 2)
    got = getattr(model, what)(xs, diag=diag)
    want = getattr(jax_model, what)(xs, diag=diag)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-8, atol=1e-12)


def test_predict_log_density_matches_jax():
    jax_model, model = _models("rbf_ard")
    rng = np.random.RandomState(3)
    xs, ys = rng.randn(5, 2), rng.randn(5, 1)
    np.testing.assert_allclose(
        model.predict_log_density(xs, ys), np.asarray(jax_model.predict_log_density(xs, ys)), rtol=1e-8
    )


def test_tensor_in_tensor_out_and_gradients():
    _, model = _models("rbf")
    xs = torch.as_tensor(np.random.RandomState(4).randn(3, 2))
    mu, var = model.predict_f(xs)
    assert isinstance(mu, torch.Tensor) and mu.shape == (3, 1) and var.shape == (3, 1)
    model.loss().backward()
    assert torch.isfinite(model.kernel.length_scales.raw.grad).all()


def test_loss_checks_shapes():
    x, y = _data()
    model = GPR(x, y, kernels.Rbf(2), device="cpu")
    with pytest.raises(ValueError):
        model.loss(x=torch.as_tensor(x[:4]), y=torch.as_tensor(y))


def test_load_trainable_rejects_other_structures():
    jax_model, _ = _models("rbf")
    model = GPR(*_data(), kernels.Rbf(2, ARD=True), device="cpu")
    values = {k: np.asarray(v) for k, v in jax_get_trainable(jax_model).items()}
    with pytest.raises(ValueError):
        convert.load_trainable(model, values)
    with pytest.raises(ValueError):
        convert.load_trainable(model, {})


def test_unported_options_raise():
    """solver='iterative' is ported; a configuration it cannot take (a
    composite kernel) raises at construction, as in the JAX package."""
    x, y = _data()
    with pytest.raises(ValueError, match="solver='iterative' requires a radial kernel"):
        GPR(x, y, kernels.Rbf(2) + kernels.Constant(2), solver="iterative", device="cpu")
    with pytest.raises(ValueError, match="requires a radial kernel"):
        JaxGPR(x, y, jax_kernels.Rbf(2) + jax_kernels.Constant(2), solver="iterative")


def _spd(n, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, n)
    return A @ A.T / n + 0.5 * np.eye(n)


def _duplicate_row_gram():
    """An Rbf Gram with repeated rows: singular, so the bare Cholesky fails
    and the adaptive policy has to add jitter."""
    x = np.random.RandomState(3).randn(12, 2)
    x[6:] = x[:6]
    return np.array(jax_kernels.Rbf(2).K(jnp.asarray(x)))


@pytest.mark.parametrize("policy", ["none", "fixed", "adaptive"])
@pytest.mark.parametrize("batched", [False, True])
def test_cholesky_matches_jax(policy, batched):
    a = np.stack([_spd(10, s) for s in range(3)]) if batched else _spd(10)
    got = functions.cholesky(torch.as_tensor(a), policy=policy)
    want = jax_functions.cholesky(jnp.asarray(a), policy=policy)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12, atol=1e-14)


def test_adaptive_engages_the_same_jitter():
    K = _duplicate_row_gram()
    jitter = functions._select_jitter(torch.as_tensor(K))
    want = float(jax_functions._select_jitter(jnp.asarray(K)))
    assert want > 0 and float(jitter) == want
    L = _np(functions.cholesky(torch.as_tensor(K), policy="adaptive"))
    Lj = np.asarray(jax_functions.cholesky(jnp.asarray(K), policy="adaptive"))
    assert np.isfinite(L).all()
    np.testing.assert_allclose(L @ L.T, K + want * np.eye(12), rtol=0, atol=1e-12)
    np.testing.assert_allclose(L, Lj, rtol=0, atol=1e-8)


def test_adaptive_schedule_follows_settings():
    K = _duplicate_row_gram()
    with settings.override(max_jitter_tries=4), jax_settings.override(max_jitter_tries=4):
        jitter = float(functions._select_jitter(torch.as_tensor(K)))
        assert jitter == float(jax_functions._select_jitter(jnp.asarray(K)))
    assert jitter == pytest.approx(1e-4)


def test_failed_factor_is_nan_and_raises():
    a = -np.eye(4)
    assert np.isnan(_np(functions.cholesky(torch.as_tensor(a), policy="none"))).all()
    with pytest.raises(RuntimeError, match="Max tries"):
        functions.cholesky_or_raise(torch.as_tensor(a))


@pytest.mark.parametrize("s_shape", [(), (3,), (3, 5)])
def test_add_diag_matches_jax(s_shape):
    rng = np.random.RandomState(5)
    a, s = rng.randn(3, 5, 5), rng.randn(*s_shape)
    np.testing.assert_allclose(
        _np(functions.add_diag(torch.as_tensor(a), torch.as_tensor(s))),
        np.asarray(jax_functions.add_diag(jnp.asarray(a), jnp.asarray(s))),
        rtol=0,
        atol=0,
    )


def test_solves_and_inverses_match_jax():
    a = _spd(8)
    b = np.random.RandomState(6).randn(8, 3)
    L, Lj = functions.cholesky(torch.as_tensor(a), policy="none"), jax_functions.cholesky(jnp.asarray(a), policy="none")
    pairs = [
        (functions.trtrs(torch.as_tensor(b), L), jax_functions.trtrs(jnp.asarray(b), Lj)),
        (functions.lt_log_determinant(L), jax_functions.lt_log_determinant(Lj)),
        (functions.cholesky_inverse(L), jax_functions.cholesky_inverse(Lj)),
        (functions.inverse(torch.as_tensor(a)), jax_functions.inverse(jnp.asarray(a))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-10, atol=1e-13)
