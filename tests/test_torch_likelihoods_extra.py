"""The port's StudentT, Gamma, Exponential, Beta, Ordinal and Softmax
likelihoods against the JAX package, float64 on the CPU: pointwise
log-densities, conditional moments, variational expectations (closed form
or quadrature), predictive moments and densities, latent initializations,
and an SVGP ELBO with each likelihood on an explicit batch.

Tolerances: rel 1e-10 for the elementwise functions (the same formulas on
the same inputs; lgamma, erf, Φ and Φ⁻¹ differ between the libraries by a
few ulps, which quadrature sums and the Beta's lgamma differences of
nearby arguments amplify), 1e-9 for the SVGP losses and 1e-8 of the
largest entry for their gradients (cond(Kuu) carries the factorizations'
roundoff).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu.models import SVGP as JaxSVGP
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu_torch import convert, kernels, likelihoods
from gptorch_tpu_torch.models import SVGP
from gptorch_tpu_torch.module import get_trainable

RTOL, LOSS_RTOL, GRAD_RTOL = 1e-10, 1e-9, 1e-8
N, D, M, C = 24, 2, 6, 3
EDGES = [-1.0, 0.3, 1.5]


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _targets(kind, rng, n, dy):
    if kind == "real":
        return rng.randn(n, dy)
    if kind == "positive":
        return np.exp(0.7 * rng.randn(n, dy))
    if kind == "unit":
        return 0.02 + 0.96 * rng.rand(n, dy)
    if kind == "ordinal":
        return rng.randint(0, len(EDGES) + 1, (n, dy)) * 1.0
    return np.eye(C)[rng.randint(0, C, n)]  # one-hot


# name: (target kind, output columns, constructor over a likelihoods module)
LIKELIHOODS = {
    "studentt": ("real", 2, lambda L: L.StudentT(scale2=0.4, df=3.5)),
    "gamma": ("positive", 2, lambda L: L.Gamma(shape=1.7)),
    "exponential": ("positive", 2, lambda L: L.Exponential()),
    "beta_probit": ("unit", 2, lambda L: L.Beta(concentration=6.0, link="probit")),
    "beta_logit": ("unit", 2, lambda L: L.Beta(concentration=6.0, link="logit")),
    "ordinal": ("ordinal", 2, lambda L: L.Ordinal(EDGES, sigma=0.6)),
    "softmax": ("onehot", C, lambda L: L.Softmax(C)),
}


def _inputs(name, seed=0):
    kind, dy, _ = LIKELIHOODS[name]
    rng = np.random.RandomState(seed)
    mean = 1.2 * rng.randn(N, dy)
    var = np.exp(rng.randn(N, dy) - 1.0)
    F = 1.5 * rng.randn(3, N, dy)
    return mean, var, F, _targets(kind, rng, N, dy)


FUNCTIONS = ["logp", "propagate_log", "predict_mean_variance", "predict_log_density", "conditional_mean",
             "conditional_variance", "latent_init"]


def _args(fn, mean, var, F, y):
    return {"logp": (F, y[None]), "propagate_log": (mean, var, y), "predict_mean_variance": (mean, var),
            "predict_log_density": (mean, var, y), "conditional_mean": (F,), "conditional_variance": (F,),
            "latent_init": (y,)}[fn]


@functools.lru_cache(maxsize=None)
def _jax_results(name):
    """Every function of one JAX likelihood on fixed inputs, in one
    compiled call (numpy results)."""
    lik = LIKELIHOODS[name][2](jax_likelihoods)

    def compute(mean, var, F, y):
        return {fn: getattr(lik, fn)(*_args(fn, mean, var, F, y)) for fn in FUNCTIONS}

    return jax.tree_util.tree_map(np.asarray, jax.jit(compute)(*_inputs(name)))


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("name", sorted(LIKELIHOODS))
def test_likelihood_matches_jax(name, fn):
    lik = LIKELIHOODS[name][2](likelihoods)
    got = getattr(lik, fn)(*_args(fn, *(torch.as_tensor(a) for a in _inputs(name))))
    want = _jax_results(name)[fn]
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def test_parameters_carry_the_jax_paths():
    for name, (_, _, make) in LIKELIHOODS.items():
        want = {k: np.asarray(v) for k, v in jax_get_trainable(make(jax_likelihoods)).items()}
        got = {k: v.detach().numpy() for k, v in get_trainable(make(likelihoods)).items()}
        assert set(got) == set(want), name
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-15, err_msg=f"{name}.{k}")
    assert not likelihoods.Exponential().shape.trainable
    assert likelihoods.Softmax.joint_outputs is True


def test_validation_errors():
    with pytest.raises(ValueError, match="link"):
        likelihoods.Beta(link="cauchit")
    with pytest.raises(ValueError, match="strictly increasing"):
        likelihoods.Ordinal([0.0, 0.0])
    with pytest.raises(ValueError, match=">= 1 edge"):
        likelihoods.Ordinal([])
    with pytest.raises(ValueError, match=">= 2 classes"):
        likelihoods.Softmax(1)
    lik = likelihoods.Softmax(C)
    mean, var = torch.zeros(4, C), torch.ones(4, C)
    with pytest.raises(ValueError, match="one-hot with C=3"):
        lik.propagate_log(mean, var, torch.zeros(4, C + 1))
    with pytest.raises(ValueError, match="one-hot with C=3"):
        lik.predict_log_density(mean, var, torch.zeros(4, 1))


@pytest.mark.parametrize("labels", [np.array([0, 2, 1, 2]), np.array([[1], [0], [2], [3]]), [2, 0]])
def test_softmax_one_hot_matches_jax(labels):
    want = np.asarray(jax_likelihoods.Softmax.one_hot(np.asarray(labels), C))
    got = likelihoods.Softmax.one_hot(labels, C)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(likelihoods.Softmax.one_hot(torch.as_tensor(labels), C).numpy(), want)


def _svgp_data(name):
    kind, dy, _ = LIKELIHOODS[name]
    rng = np.random.RandomState(4)
    x = rng.randn(N, D)
    return x, _targets(kind, rng, N, dy), x[:M], rng.permutation(N)[:10]


@functools.lru_cache(maxsize=None)
def _jax_svgp(name):
    """The JAX SVGP's initial trainables and, at perturbed ones, the ELBO
    loss and its gradient on an explicit batch and the predictive moments,
    in one compiled call."""
    make = LIKELIHOODS[name][2]
    x, y, z, batch = _svgp_data(name)
    jm = JaxSVGP(x, y, jax_kernels.Rbf(D, ARD=True), inducing_points=z, likelihood=make(jax_likelihoods))
    initial = {k: np.asarray(v) for k, v in jax_get_trainable(jm).items()}
    rng = np.random.RandomState(7)
    values = {k: v + 0.05 * rng.randn(*v.shape) for k, v in initial.items()}
    xs = rng.randn(5, D)

    def compute(v, xb, yb, xs):
        loss, grads = jax.value_and_grad(lambda v: jax_with_trainable(jm, v)._loss(x=xb, y=yb))(v)
        return loss, grads, jax_with_trainable(jm, v).predict_y(xs)

    out = jax.jit(compute)(values, x[batch], y[batch], xs)
    return initial, values, xs, jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("name", sorted(LIKELIHOODS))
def test_svgp_elbo_matches_jax(name):
    """SVGP's q(u) start at the likelihood's latent scale, then the ELBO on
    an explicit batch (C jointly evaluated columns for Softmax) and its
    gradient, and the predictive moments."""
    make = LIKELIHOODS[name][2]
    initial, values, xs, (want_loss, want_grads, want_pred) = _jax_svgp(name)
    x, y, z, batch = _svgp_data(name)
    m = SVGP(x, y, kernels.Rbf(D, ARD=True), inducing_points=z, likelihood=make(likelihoods), device="cpu")
    for path in ("induced_output_mean", "induced_output_chol_cov"):
        _close(get_trainable(m)[path], initial[path], 1e-9)
    convert.load_trainable(m, values)
    loss = m.loss(x=torch.as_tensor(x[batch]), y=torch.as_tensor(y[batch]))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    scale = max(float(np.abs(g).max()) for g in want_grads.values())
    for path, raw in get_trainable(m).items():
        np.testing.assert_allclose(raw.grad.numpy(), want_grads[path], rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=path)
    for got, want in zip(m.predict_y(xs), want_pred):
        _close(got, want, 1e-9)
