"""The port's exact-GP serving path as a whole against the JAX package:
GPR(n=512, d=4, Rbf-ARD) -> posterior() -> for_serving("blocked" | "solve")
-> predict_f / predict_y / mean_only / predict_f_batched (float64, CPU).

Tolerance rel 1e-8: the two packages' Cholesky factors and triangular
inverses reassociate differently, and cond(K) carries that roundoff into
the moments.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu_torch import convert, kernels, likelihoods
from gptorch_tpu_torch.models import GPR
from gptorch_tpu_torch.models.posterior import GPRPosterior, ServingGPRPosterior

N, D, NB = 512, 4, 128
RTOL, ATOL = 1e-8, 1e-12


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@functools.lru_cache(maxsize=1)
def _posteriors():
    """Both packages' cached posteriors and serving posteriors (each method)
    for one perturbed model; built once per process (under the float64
    fixture), read only."""
    rng = np.random.RandomState(0)
    x = rng.randn(N, D)
    y = np.sin(x[:, :1]) + 0.1 * rng.randn(N, 1)
    jax_model = JaxGPR(x, y, jax_kernels.Rbf(D, ARD=True), likelihood=jax_likelihoods.Gaussian(0.1))
    values = {k: np.asarray(v) + 0.1 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jax_model).items()}
    jax_model = jax_with_trainable(jax_model, {k: jnp.asarray(v) for k, v in values.items()})
    model = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1), device="cpu")
    convert.load_trainable(model, values)
    jax_post, post = jax_model.posterior(), model.posterior()
    out = {"posterior": (jax_post, post)}
    for method in ("blocked", "solve"):
        out[method] = (jax_post.for_serving(nb=NB, method=method), post.for_serving(nb=NB, method=method))
    return out


def _queries(n=70, seed=1):
    return np.random.RandomState(seed).randn(n, D)


def _close(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


def test_factors_match():
    jax_post, post = _posteriors()["posterior"]
    assert isinstance(post, GPRPosterior)
    np.testing.assert_allclose(post.L.numpy(), np.asarray(jax_post.L), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(post.V.numpy(), np.asarray(jax_post.V), rtol=RTOL, atol=1e-10)
    assert not post.L.requires_grad


@pytest.mark.parametrize("method", ["blocked", "solve"])
def test_inverse_factor_matches(method):
    jax_serving, serving = _posteriors()[method]
    assert isinstance(serving, ServingGPRPosterior)
    np.testing.assert_allclose(serving.Linv.numpy(), np.asarray(jax_serving.Linv), rtol=RTOL, atol=1e-10)
    np.testing.assert_allclose(serving.alpha.numpy(), np.asarray(jax_serving.alpha), rtol=RTOL, atol=1e-10)


@pytest.mark.parametrize("which", ["posterior", "blocked", "solve"])
@pytest.mark.parametrize("what", ["predict_f", "predict_y"])
@pytest.mark.parametrize("diag", [True, False])
def test_predictions_match(which, what, diag):
    jax_post, post = _posteriors()[which]
    xs = _queries()
    _close(getattr(post, what)(xs, diag=diag), getattr(jax_post, what)(xs, diag=diag))


@pytest.mark.parametrize("method", ["blocked", "solve"])
def test_mean_only_matches(method):
    jax_serving, serving = _posteriors()[method]
    xs = _queries()
    _close(serving.mean_only(xs), jax_serving.mean_only(xs))
    np.testing.assert_allclose(serving.mean_only(xs), serving.predict_f(xs)[0], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("which", ["posterior", "blocked"])
@pytest.mark.parametrize("what", ["predict_f_batched", "predict_y_batched"])
def test_batched_matches(which, what):
    jax_post, post = _posteriors()[which]
    xs = _queries(n=150)
    _close(getattr(post, what)(xs, batch_size=64), getattr(jax_post, what)(xs, batch_size=64))


def test_predict_log_density_matches():
    jax_serving, serving = _posteriors()["blocked"]
    xs, ys = _queries(), np.random.RandomState(2).randn(70, 1)
    _close(serving.predict_log_density(xs, ys), jax_serving.predict_log_density(xs, ys))


def test_serving_agrees_with_model():
    _, post = _posteriors()["posterior"]
    _, serving = _posteriors()["blocked"]
    xs = _queries()
    for got, want in zip(serving.predict_f(xs), post.predict_f(xs)):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def test_tensor_queries_stay_tensors():
    _, serving = _posteriors()["blocked"]
    xs = torch.as_tensor(_queries())
    mu, var = serving.predict_f(xs)
    assert isinstance(mu, torch.Tensor) and mu.shape == (70, 1) and var.shape == (70, 1)


def test_for_serving_rejects_unknown_method():
    _, post = _posteriors()["posterior"]
    with pytest.raises(ValueError):
        post.for_serving(method="lu")
