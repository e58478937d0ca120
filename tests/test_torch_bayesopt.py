"""The port's Bayesian optimisation (gptorch_tpu_torch.bayesopt) against the
JAX package, float64 on the CPU, on one GPR built in both packages from a
numpy seed (n = 30, d = 2, Rbf-ARD), the draws held fixed: the port's
uniforms and normals return the JAX package's draws in the order the port
draws them.

* the four acquisitions and their gradients in the mean and the variance,
  at var = 0, −1e-12, 1e-30, 0.5 beside a spread of moments: 1e-12
  relative, every gradient finite (the double ``where`` of ``_safe_sd``);
  score_candidates on a posterior.
  Gradients and EI scores are held to 1e-12 of their largest entry: in
  EI's far tail (z ≈ −15) the two packages' erf differ in the last digits
  of a 1e-48 value;
* suggest (ei; 8 refinement steps over 64 candidates) from the same
  candidates: the same point to 1e-8 (suggest_thompson, suggest_qei and
  qei_mc are in test_torch_bayesopt_paths.py).  The JAX side takes its
  posterior from one compiled call and predict_f and condition_on compiled
  per shape (op by op each new shape costs seconds of compiles on the
  CPU);
* BayesOpt (Matern52 default, 10 Adam iterations, refit_every = 2): one
  refit and suggest, one fantasy observe (condition_on) and suggest: the
  same points to 1e-8 and the same cached posterior (1e-10); a believer
  batch leaves the cached posterior as it was and spreads its picks;
* the loop's rules: random start below two observations, the input warp's
  two ValueErrors, an unknown batch strategy, numpy out.
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


_JAX_POSTERIOR = jax.jit(JaxGPR.posterior)
_JAX_PREDICT = jax.jit(JaxGPRPosterior.predict_f, static_argnames="diag")
_JAX_CONDITION = jax.jit(JaxGPRPosterior.condition_on)


@pytest.fixture(autouse=True)
def _compiled_jax_posterior(monkeypatch):
    """The JAX model's posterior() and the posterior's predict_f and
    condition_on as one compiled program per shape."""
    monkeypatch.setattr(JaxGPR, "posterior", _JAX_POSTERIOR)
    monkeypatch.setattr(JaxGPRPosterior, "predict_f", _JAX_PREDICT)
    monkeypatch.setattr(JaxGPRPosterior, "condition_on", _JAX_CONDITION)


def _model():
    x, y = _data()
    m = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1), fast=False, device="cpu")
    convert.load_trainable(m, {k: np.asarray(v) for k, v in jax_get_trainable(_jax_model()[1]).items()})
    return m


def _close(got, want, rel=REL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rel, atol=atol)


def _close_to_scale(got, want, rel=REL):
    """Within ``rel`` of the largest entry of ``want`` (an entry that
    underflows, as EI's gradient far below the incumbent, is held at the
    scale of the others)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


def _uniform(key, shape):
    return ("uniform", np.asarray(jax.random.uniform(key, shape, jnp.float64)))


MEAN = np.array([0.1, 0.7, 0.1, 0.7, -0.4, 3.0, 0.3])
VAR = np.array([np.nan, 0.2, 0.2, 1e-3, 2.0, 0.05, 0.4])  # the first entry is the parameter v


@functools.lru_cache(maxsize=None)
def _jax_acquisition(name):
    """The JAX acquisition's values and their gradients, each one compiled
    program per acquisition."""
    acq = jax_bo.ACQUISITIONS[name]
    return (jax.jit(lambda m, s: acq(m, s, 0.3)),
            jax.jit(jax.grad(lambda m, s: jnp.sum(acq(m, s, best=0.3)), argnums=(0, 1))))


@pytest.mark.parametrize("name", sorted(bayesopt.ACQUISITIONS))
@pytest.mark.parametrize("v", [0.0, -1e-12, 1e-30, 0.5])
def test_acquisitions_and_gradients_match_jax(name, v):
    var = VAR.copy()
    var[0] = v
    values, grads = _jax_acquisition(name)
    want = values(jnp.asarray(MEAN), jnp.asarray(var))
    jgm, jgv = grads(jnp.asarray(MEAN), jnp.asarray(var))
    m, s = torch.tensor(MEAN, requires_grad=True), torch.tensor(var, requires_grad=True)
    got = bayesopt.ACQUISITIONS[name](m, s, best=0.3)
    gm, gv = torch.autograd.grad(torch.sum(got), (m, s))
    _close(got.detach(), want)
    for g, w in ((gm, jgm), (gv, jgv)):
        assert np.all(np.isfinite(g.numpy())), (name, v)
        _close_to_scale(g, w)


def test_degenerate_ei_and_logei_tail():
    ei = bayesopt.expected_improvement(torch.tensor([0.0, 1.0]), torch.tensor([0.0, 0.0]), best=0.5)
    _close(ei, [0.5, 0.0])
    mean, var = np.array([10.0, 20.0, 30.0]), np.full(3, 0.01)
    lei = bayesopt.log_expected_improvement(mean, var, best=0.0)
    _close(lei, jax_bo.log_expected_improvement(jnp.asarray(mean), jnp.asarray(var), 0.0))
    assert torch.all(torch.isfinite(lei)) and lei[0] > lei[1] > lei[2]


def test_score_candidates_matches_jax():
    cand = np.random.RandomState(1).rand(17, D)
    got = bayesopt.score_candidates(_model().posterior(), torch.as_tensor(cand), 0.05, "ei")
    _close_to_scale(got, jax_bo.score_candidates(_jax_model()[0].posterior(), jnp.asarray(cand), 0.05, "ei"))


def test_suggest_matches_jax(held):
    key = jax.random.PRNGKey(4)
    want = jax_bo.suggest(_jax_model()[0], BOUNDS, n_candidates=64, refine_steps=8, key=key)
    held.append(_uniform(key, (64, D)))
    got = bayesopt.suggest(_model(), BOUNDS, n_candidates=64, refine_steps=8, generator=torch.Generator())
    assert isinstance(got, np.ndarray) and got.shape == (D,)
    _close(got, want, rel=0, atol=POINT)


LOOP_X = np.array([[0.1, 0.2], [0.9, -0.3], [0.5, 1.2], [0.3, 0.4], [0.7, 0.8]])


def _f(x):
    return float(np.sum((np.asarray(x) - 0.3) ** 2))


def _loop_calls(bo):
    """Five observations, suggest (a refit), a fantasy observe, suggest: the
    points proposed."""
    for x in LOOP_X:
        bo.observe(x, _f(x))
    out = [bo.suggest()]
    bo.observe(out[0], _f(out[0]))
    out.append(bo.suggest())
    return out


LOOP = dict(fit_iters=10, n_candidates=32, seed=3, refit_every=2)


@functools.lru_cache(maxsize=None)
def _jax_loop():
    bo = jax_bo.BayesOpt(bounds=BOUNDS, **LOOP)
    out = _loop_calls(bo)
    key, draws = jax.random.PRNGKey(LOOP["seed"]), []
    for _ in range(2):  # one candidate set a suggest
        key, sub = jax.random.split(key)
        draws.append(_uniform(sub, (LOOP["n_candidates"], D)))
    xt = np.random.RandomState(2).rand(6, D)
    return out, draws, bo._n_fit, [np.asarray(a) for a in bo._post.predict_f(jnp.asarray(xt))], xt


def test_bayesopt_loop_matches_jax(held):
    want, draws, n_fit, moments, xt = _jax_loop()
    held.extend(draws)
    bo = bayesopt.BayesOpt(bounds=BOUNDS, device="cpu", **LOOP)
    got = _loop_calls(bo)
    assert bo._n_fit == n_fit == 5 and bo._post.X.shape[0] == 6  # one fantasy observe since the refit
    for g, w in zip(got, want):
        _close(g, w, rel=0, atol=POINT)
    for g, w in zip(bo._post.predict_f(xt), moments):
        _close(g, w, rel=1e-10)
    assert bo.best_y == min(bo.Y) <= min(_f(x) for x in LOOP_X)


def test_believer_batch_keeps_the_cached_posterior():
    bo = bayesopt.BayesOpt(bounds=BOUNDS, fit_iters=10, n_candidates=32, seed=7, device="cpu")
    for x in LOOP_X:
        bo.observe(x, _f(x))
    bo.suggest()
    post = bo._post
    batch = bo.suggest_batch(3, strategy="believer")
    assert batch.shape == (3, D) and bo._post is post and post.X.shape[0] == len(LOOP_X)
    assert np.all(batch >= np.array(BOUNDS)[:, 0]) and np.all(batch <= np.array(BOUNDS)[:, 1])
    assert np.unique(np.round(batch, 6), axis=0).shape[0] == 3
    assert bo.suggest_batch(2, strategy="ts").shape == (2, D)
    assert bo.suggest_batch(2, strategy="qei").shape == (2, D)


def test_bayesopt_random_start_and_rules():
    bo = bayesopt.BayesOpt(bounds=BOUNDS, seed=0, device="cpu")
    x0 = bo.suggest()
    assert isinstance(x0, np.ndarray) and x0.shape == (D,)
    assert np.all(x0 >= np.array(BOUNDS)[:, 0]) and np.all(x0 <= np.array(BOUNDS)[:, 1])
    assert bo.suggest_batch(3).shape == (3, D)
    with pytest.raises(ValueError, match="input_warp"):
        bayesopt.BayesOpt(bounds=BOUNDS, acquisition="ts", input_warp=True, device="cpu")
    warped = bayesopt.BayesOpt(bounds=[[0, 1]], input_warp=True, seed=0, fit_iters=5, n_candidates=16, device="cpu")
    for v in (0.1, 0.9, 0.4):
        warped.observe(np.asarray([v]), v)
    with pytest.raises(ValueError, match="stationary"):
        warped.suggest_batch(2, strategy="qei")
    with pytest.raises(ValueError, match="unknown batch strategy"):
        warped.suggest_batch(2, strategy="nope")
    assert isinstance(warped._model.kernel, kernels.InputWarp)
