"""The port's likelihoods and Gauss-Hermite quadrature against the JAX
package, float64 on the CPU: Gaussian, FixedNoiseGaussian, Bernoulli
(probit and logit) and Poisson -- pointwise log-densities, variational
expectations (closed form or quadrature), predictive moments and
densities -- and SVGP with the non-conjugate likelihoods end to end.

Tolerance rel 1e-12 for the elementwise functions (the same formulas on
the same inputs; erf, log Φ and lgamma differ between the libraries by a
few ulps), 1e-10 for the SVGP losses and 1e-8 of the largest entry for
their gradients (cond(Kuu) carries the factorizations' roundoff).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu import quadrature as jax_quadrature
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.models import SVGP as JaxSVGP
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu_torch import convert, kernels, likelihoods, quadrature
from gptorch_tpu_torch.models import GPR, SVGP
from gptorch_tpu_torch.module import get_trainable

RTOL = 1e-12
N, D, M = 32, 2, 8


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _inputs(kind, n=N, dy=2, seed=0):
    """Latent moments and targets of the kind the likelihood takes."""
    rng = np.random.RandomState(seed)
    mean = 1.5 * rng.randn(n, dy)
    var = np.exp(rng.randn(n, dy) - 1.0)
    F = 2.0 * rng.randn(3, n, dy)
    if kind == "bernoulli":
        y = (rng.rand(n, dy) > 0.5) * 1.0
    elif kind == "poisson":
        y = rng.poisson(2.0, (n, dy)) * 1.0
    else:
        y = rng.randn(n, dy)
    return mean, var, F, y


LIKELIHOODS = {
    "gaussian": ("gaussian", lambda L: L.Gaussian(0.3)),
    "fixed_noise": ("gaussian", lambda L: L.FixedNoiseGaussian(0.1 + np.arange(N) / N, extra_variance=0.05)),
    "probit": ("bernoulli", lambda L: L.Bernoulli("probit")),
    "logit": ("bernoulli", lambda L: L.Bernoulli("logit")),
    "poisson": ("poisson", lambda L: L.Poisson()),
}


@functools.lru_cache(maxsize=None)
def _jax_results(name):
    """Every function of one JAX likelihood on fixed inputs, in one
    compiled call (numpy results)."""
    kind, make = LIKELIHOODS[name]
    lik = make(jax_likelihoods)
    mean, var, F, y = _inputs(kind)

    def compute(mean, var, F, y):
        return {
            "logp": lik.logp(F, y),
            "propagate_log": lik.propagate_log(mean, var, y),
            "predict_mean_variance": lik.predict_mean_variance(mean, var),
            "predict_log_density": lik.predict_log_density(mean, var, y),
            "conditional_mean": lik.conditional_mean(F),
            "conditional_variance": lik.conditional_variance(F),
            "latent_init": lik.latent_init(y),
        }

    out = jax.jit(compute)(mean, var, F, y)
    return jax.tree_util.tree_map(np.asarray, out)


def _close(got, want, rtol=RTOL):
    got, want = (a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in (got, want))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


FUNCTIONS = ["logp", "propagate_log", "predict_mean_variance", "predict_log_density", "conditional_mean",
             "conditional_variance", "latent_init"]


@pytest.mark.parametrize("fn", FUNCTIONS)
@pytest.mark.parametrize("name", sorted(LIKELIHOODS))
def test_likelihood_matches_jax(name, fn):
    kind, make = LIKELIHOODS[name]
    lik = make(likelihoods)
    mean, var, F, y = (torch.as_tensor(a) for a in _inputs(kind))
    args = {
        "logp": (F, y), "propagate_log": (mean, var, y), "predict_mean_variance": (mean, var),
        "predict_log_density": (mean, var, y), "conditional_mean": (F,), "conditional_variance": (F,),
        "latent_init": (y,),
    }[fn]
    got, want = getattr(lik, fn)(*args), _jax_results(name)[fn]
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


@pytest.mark.parametrize("order", [5, 20])
def test_quadrature_matches_jax(order):
    mean, var, _, _ = _inputs("gaussian")

    def g(f):
        return jnp.sin(f) * f if isinstance(f, jax.Array) else torch.sin(f) * f

    want = jax.jit(lambda m, v: (jax_quadrature.gauss_hermite(g, m, v, order),
                                 jax_quadrature.gauss_hermite_log(g, m, v, order)))(mean, var)
    m_, v_ = torch.as_tensor(mean), torch.as_tensor(var)
    _close(quadrature.gauss_hermite(g, m_, v_, order), want[0])
    _close(quadrature.gauss_hermite_log(g, m_, v_, order), want[1])


def test_quadrature_is_exact_for_low_degree():
    """The 20-point rule integrates polynomials up to degree 39 exactly:
    E[f²] = μ² + s, E[f⁴] = μ⁴ + 6μ²s + 3s²; and it sums in log space."""
    mean, var = torch.tensor([0.3, -1.2]), torch.tensor([0.5, 2.0])
    _close(quadrature.gauss_hermite(torch.square, mean, var), mean ** 2 + var, 1e-13)
    _close(quadrature.gauss_hermite(lambda f: f ** 4, mean, var), mean ** 4 + 6 * mean ** 2 * var + 3 * var ** 2,
           1e-13)
    _close(quadrature.gauss_hermite_log(lambda f: torch.zeros_like(f), mean, var), torch.zeros(2), 1e-14)


def test_quadrature_fallbacks_agree_with_closed_forms():
    """Gaussian's closed-form expectation and Bernoulli-probit's closed-form
    moments against the base class's quadrature."""
    mean, var, _, y = (torch.as_tensor(a) for a in _inputs("gaussian"))
    lik = likelihoods.Gaussian(0.3)
    _close(likelihoods.Likelihood.propagate_log(lik, mean, var, y), lik.propagate_log(mean, var, y), 1e-12)
    mean, var, _, y = (torch.as_tensor(a) for a in _inputs("bernoulli"))
    lik = likelihoods.Bernoulli("probit")
    lik.quadrature_order = 80
    for got, want in zip(likelihoods.Likelihood.predict_mean_variance(lik, mean, var),
                         lik.predict_mean_variance(mean, var)):
        _close(got, want, 1e-8)
    _close(likelihoods.Likelihood.predict_log_density(lik, mean, var, y), lik.predict_log_density(mean, var, y),
           1e-8)


def test_bernoulli_and_fixed_noise_validate():
    with pytest.raises(ValueError, match="link"):
        likelihoods.Bernoulli("cauchit")
    with pytest.raises(ValueError, match="non-negative"):
        likelihoods.FixedNoiseGaussian([0.1, -1.0])
    lik = likelihoods.FixedNoiseGaussian(np.ones(4), learn_extra=False)
    assert not lik.variance.trainable
    with pytest.raises(ValueError, match="4 per-observation"):
        lik.noise_diag(5)


def test_fixed_noise_gpr_matches_jax():
    """The exact GPR reads the per-observation noise into Kyy; predictions
    at new inputs add only the learned part."""
    rng = np.random.RandomState(2)
    x, y = rng.randn(N, D), rng.randn(N, 1)
    noise = 0.05 + 0.2 * rng.rand(N)
    jm = JaxGPR(x, y, jax_kernels.Rbf(D), likelihood=jax_likelihoods.FixedNoiseGaussian(noise, 0.01))
    m = GPR(x, y, kernels.Rbf(D), likelihood=likelihoods.FixedNoiseGaussian(noise, 0.01), device="cpu")
    convert.load_trainable(m, {k: np.asarray(v) for k, v in jax_get_trainable(jm).items()})
    xs = rng.randn(5, D)
    want = jax.jit(lambda v, xs: jax.value_and_grad(lambda v: jax_with_trainable(jm, v)._loss())(v)
                   + (jax_with_trainable(jm, v).predict_y(xs),))(jax_get_trainable(jm), xs)
    loss = m.loss()
    loss.backward()
    assert float(loss) == pytest.approx(float(want[0]), rel=1e-10)
    for path, raw in get_trainable(m).items():
        _close(raw.grad, want[1][path], 1e-9)
    for got, w in zip(m.predict_y(xs), want[2]):
        _close(got, w, 1e-9)


@pytest.mark.parametrize("name", ["probit", "logit", "poisson"])
def test_svgp_with_a_non_conjugate_likelihood_matches_jax(name):
    """SVGP's q(u) init at the likelihood's latent scale, its ELBO (the
    quadrature or closed-form expectation) and gradient, and predictions."""
    kind, make = LIKELIHOODS[name]
    rng = np.random.RandomState(4)
    x = rng.randn(N, D)
    _, _, _, y = _inputs(kind, dy=1, seed=5)
    z = x[:M]
    jm = JaxSVGP(x, y, jax_kernels.Rbf(D, ARD=True), inducing_points=z, likelihood=make(jax_likelihoods))
    m = SVGP(x, y, kernels.Rbf(D, ARD=True), inducing_points=z, likelihood=make(likelihoods), device="cpu")
    init = {k: np.asarray(v) for k, v in jax_get_trainable(jm).items()}
    for path in ("induced_output_mean", "induced_output_chol_cov"):
        _close(get_trainable(m)[path], init[path], 1e-9)
    convert.load_trainable(m, init)
    xs = rng.randn(5, D)
    want = jax.jit(lambda v, xs: jax.value_and_grad(lambda v: jax_with_trainable(jm, v)._loss())(v)
                   + (jax_with_trainable(jm, v).predict_y(xs),))(jax_get_trainable(jm), xs)
    loss = m.loss()
    loss.backward()
    assert float(loss) == pytest.approx(float(want[0]), rel=1e-10)
    scale = max(float(np.abs(np.asarray(g)).max()) for g in want[1].values())
    for path, raw in get_trainable(m).items():
        np.testing.assert_allclose(raw.grad.numpy(), np.asarray(want[1][path]), rtol=0, atol=1e-8 * scale,
                                   err_msg=path)
    for got, w in zip(m.predict_y(xs), want[2]):
        _close(got, w, 1e-9)
