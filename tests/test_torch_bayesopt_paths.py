"""The port's Bayesian optimisation through posterior function samples
(gptorch_tpu_torch.bayesopt suggest_thompson, suggest_qei and qei_mc)
against the JAX package, float64 on the CPU, on one GPR built in both
packages from a numpy seed (n = 30, d = 2, Rbf-ARD), the draws held fixed:
the port's uniforms and normals return the JAX package's draws (the
paths' features, weights and training noise, then the candidates) in the
order the port draws them.

* suggest_thompson (q = 3, 6 refinement steps over 64 candidates; each
  path's gradient at its own point is one grad of the diagonal's sum) and
  suggest_qei (q = 2, 3 paths, 6 steps), from the same candidates and
  paths: the same points to 1e-8, inside the box;
* qei_mc on the same paths: 1e-12.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import bayesopt as jax_bo
from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.models.posterior import GPRPosterior as JaxGPRPosterior
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu_torch import bayesopt, convert, kernels, likelihoods, sampling
from gptorch_tpu_torch.models import GPR

N, D = 30, 2
BOUNDS = [[0.0, 1.0], [-0.5, 1.5]]
REL = 1e-12
POINT = 1e-8


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture
def held(monkeypatch):
    """Replace the port's draws by a queue of given (kind, array)."""
    queue = []

    def take(kind):
        def draw(generator, shape, like):
            got_kind, arr = queue.pop(0)
            assert got_kind == kind and arr.shape == tuple(shape), (kind, shape, got_kind, arr.shape)
            return torch.tensor(arr, dtype=like.dtype, device=like.device)

        return draw

    monkeypatch.setattr(sampling, "standard_normal", take("normal"))
    monkeypatch.setattr(sampling, "uniform", take("uniform"))
    yield queue
    assert not queue, "draws left over"


def _data():
    rng = np.random.RandomState(0)
    x = rng.rand(N, D) * np.array([1.0, 2.0]) + np.array([0.0, -0.5])
    y = np.sum((x - 0.3) ** 2, axis=1, keepdims=True) + 0.01 * rng.randn(N, 1)
    return x, y


@functools.lru_cache(maxsize=None)
def _jax_model():
    """The JAX package's model as the BO functions take it: its posterior
    (one compiled call; op by op it compiles for seconds) and its Y, through
    the package's own adapter."""
    x, y = _data()
    model = JaxGPR(x, y, jax_kernels.Rbf(D, ARD=True, length_scales=[0.3, 0.5]),
                   likelihood=jax_likelihoods.Gaussian(1e-3), fast=False)
    return jax_bo._CachedPosterior(jax.jit(lambda m: m.posterior())(model), np.asarray(model.Y)), model


_JAX_PREDICT = jax.jit(JaxGPRPosterior.predict_f, static_argnames="diag")
_JAX_CONDITION = jax.jit(JaxGPRPosterior.condition_on)


@pytest.fixture(autouse=True)
def _compiled_jax_posterior(monkeypatch):
    """The JAX posterior's predict_f and condition_on as one compiled
    program per shape."""
    monkeypatch.setattr(JaxGPRPosterior, "predict_f", _JAX_PREDICT)
    monkeypatch.setattr(JaxGPRPosterior, "condition_on", _JAX_CONDITION)


def _model():
    x, y = _data()
    m = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1), fast=False, device="cpu")
    convert.load_trainable(m, {k: np.asarray(v) for k, v in jax_get_trainable(_jax_model()[1]).items()})
    return m


def _close(got, want, rel=REL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rel, atol=atol)


def _uniform(key, shape):
    return ("uniform", np.asarray(jax.random.uniform(key, shape, jnp.float64)))


def _path_draws(key, S, F, n):
    """The JAX package's draws of GPRPosterior.sample_paths(key) for an Rbf
    kernel, in the port's order."""
    k_feat, k_w, k_eps = jax.random.split(key, 3)
    k1, k2, _ = jax.random.split(k_feat, 3)
    return [("normal", np.asarray(jax.random.normal(k1, (D, F), jnp.float64))),
            ("uniform", np.asarray(jax.random.uniform(k2, (F,), jnp.float64))),
            ("normal", np.asarray(jax.random.normal(k_w, (S, F, 1), jnp.float64))),
            ("normal", np.asarray(jax.random.normal(k_eps, (S, n, 1), jnp.float64)))]


def test_suggest_thompson_matches_jax(held):
    key = jax.random.PRNGKey(5)
    want = jax_bo.suggest_thompson(_jax_model()[0], BOUNDS, q=3, n_candidates=64, num_features=32, refine_steps=6,
                                   key=key)
    k_path, k_cand = jax.random.split(key)
    held.extend(_path_draws(k_path, 3, 32, N) + [_uniform(k_cand, (64, D))])
    got = bayesopt.suggest_thompson(_model(), BOUNDS, q=3, n_candidates=64, num_features=32, refine_steps=6,
                                    generator=torch.Generator())
    assert got.shape == (3, D)
    _close(got, want, rel=0, atol=POINT)


def test_suggest_qei_matches_jax(held):
    key = jax.random.PRNGKey(6)
    want = jax_bo.suggest_qei(_jax_model()[0], BOUNDS, q=2, n_samples=3, n_candidates=64, num_features=32,
                              refine_steps=6, key=key)
    k_path, k_init = jax.random.split(key)
    held.extend(_path_draws(k_path, 3, 32, N) + [_uniform(k_init, (64, D))])
    got = bayesopt.suggest_qei(_model(), BOUNDS, q=2, n_samples=3, n_candidates=64, num_features=32,
                               refine_steps=6, generator=torch.Generator())
    assert got.shape == (2, D)
    _close(got, want, rel=0, atol=POINT)
    assert np.all(got >= np.array(BOUNDS)[:, 0]) and np.all(got <= np.array(BOUNDS)[:, 1])


def test_qei_mc_matches_jax(held):
    key = jax.random.PRNGKey(7)
    jpaths = _jax_model()[0].posterior().sample_paths(n_samples=3, num_features=32, key=key)
    held.extend(_path_draws(key, 3, 32, N))
    paths = _model().posterior().sample_paths(n_samples=3, num_features=32, generator=torch.Generator())
    xb = np.array([[0.3, 0.2], [0.8, 1.1]])
    _close(bayesopt.qei_mc(paths, torch.as_tensor(xb), 0.05), jax_bo.qei_mc(jpaths, jnp.asarray(xb), 0.05))


