"""The port's fused NLMLs against the JAX package's, float64 on the CPU:
gptorch_tpu_torch.ops.gpr_fast.radial_nlml (value and gradient, all five
kinds), the plain backward contraction, gptorch_tpu_torch.ops.gpr_general,
and GPR.log_likelihood on each of its three routes.  Tolerances are those of
tests/test_ops.py's fused-path tests: NLML to 1e-10 relative, gradients to
1e-6 relative.  The JAX side runs under one jax.jit per call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu import mean_functions as jax_means
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu.ops import gpr_fast as jf
from gptorch_tpu.ops import gpr_general as jg
from gptorch_tpu_torch import convert, kernels, likelihoods, mean_functions
from gptorch_tpu_torch.models import GPR
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.ops import contract
from gptorch_tpu_torch.ops import gpr_fast as tf
from gptorch_tpu_torch.ops import gpr_general as tg

KINDS = ["rbf", "matern12", "matern32", "matern52", "rq"]
N, D, DY, NB = 150, 3, 2, 64
JITTER, REL = 1e-4, 1e-3


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data(seed=7):
    rng = np.random.RandomState(seed)
    return rng.randn(N, D), rng.randn(N, DY)


LOG_ELL = {
    "ard": np.log([0.9, 1.2, 0.7]),
    "scalar": np.asarray(np.log(1.1)),
    "one": np.log([1.1]),
}


@pytest.mark.parametrize(
    "kind, ell", [(k, "ard") for k in KINDS] + [("rbf", "scalar"), ("matern12", "one"), ("rq", "scalar")]
)
def test_radial_nlml_matches_jax(kind, ell):
    x, y = _data()
    theta = [LOG_ELL[ell], np.asarray(np.log(1.4)), np.asarray(np.log(0.08))]
    if kind == "rq":
        theta.append(np.log([0.6]))

    def jax_nlml(*t):
        extra = t[3] if kind == "rq" else None
        return jf.radial_nlml(kind, t[0], t[1], t[2], jnp.asarray(x), jnp.asarray(y), JITTER, NB, REL, extra)

    want, want_grads = jax.jit(jax.value_and_grad(jax_nlml, argnums=tuple(range(len(theta)))))(
        *[jnp.asarray(t) for t in theta]
    )
    params = [torch.tensor(t, requires_grad=True) for t in theta]
    extra = params[3] if kind == "rq" else None
    got = tf.radial_nlml(kind, *params[:3], torch.as_tensor(x), torch.as_tensor(y), JITTER, NB, REL, extra)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-10)
    for p, w in zip(params, want_grads):
        assert p.grad.shape == p.shape
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)


def test_rq_needs_log_extra():
    x, y = _data()
    with pytest.raises(ValueError, match="log_extra"):
        tf.radial_nlml("rq", torch.zeros(3), torch.zeros(()), torch.zeros(()), torch.as_tensor(x), torch.as_tensor(y))


def test_rbf_value_and_grad_matches_radial_nlml():
    x, y = _data()
    args = (torch.as_tensor(LOG_ELL["ard"]), torch.tensor(0.3), torch.tensor(-2.0))
    v, grads = tf.rbf_nlml_value_and_grad(*args, torch.as_tensor(x), torch.as_tensor(y), JITTER, NB)
    want, want_grads = jax.jit(jax.value_and_grad(jf.rbf_nlml, argnums=(0, 1, 2)), static_argnums=(5, 6))(
        *[jnp.asarray(a.numpy()) for a in args], jnp.asarray(x), jnp.asarray(y), JITTER, NB
    )
    assert float(v) == pytest.approx(float(want), rel=1e-10)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_contractions_match_jax(kind):
    """The plain twin of the backward-contraction kernel (K2) against the
    JAX package's _contractions, on a duplicate point so matern12's mask at
    r² = 0 is exercised off the diagonal too."""
    rng = np.random.RandomState(3)
    n = 120
    xs = rng.randn(n, D)
    xs[7] = xs[3]
    M = rng.randn(n, n)
    Kinv = M @ M.T / n + np.eye(n)
    A = rng.randn(n, DY)
    log_var, log_extra = np.asarray(0.2), np.log([0.6])
    extra = log_extra if kind == "rq" else np.zeros((0,))
    want = jax.jit(lambda *a: jf._contractions(*a[:4], DY, kind, a[4]))(
        *[jnp.asarray(a) for a in (Kinv, A, xs, log_var, extra)]
    )
    t = [torch.as_tensor(a) for a in (Kinv, A, xs, log_var, log_extra)]
    got = contract.radial_contractions(*t[:4], DY, kind, t[4] if kind == "rq" else None)
    assert contract.radial_contractions.launches == 0  # the CPU takes the plain twin
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-10)


def test_contractions_reject_bad_shapes():
    Kinv, A, xs = torch.eye(5), torch.zeros(5, 2), torch.zeros(5, 3)
    with pytest.raises(ValueError, match="kind"):
        contract.radial_contractions(Kinv, A, xs, torch.zeros(()), 2, "periodic")
    with pytest.raises(ValueError, match="dy"):
        contract.radial_contractions(Kinv, A, xs, torch.zeros(()), 1, "rbf")
    with pytest.raises(ValueError, match="contiguous"):
        contract.radial_contractions(Kinv.T[:, :], A.T.contiguous().T, xs, torch.zeros(()), 2, "rbf")


def _models(route, n=N):
    """One GPR in both packages on one route, raws perturbed in the JAX model
    and carried across with convert.load_trainable."""
    rng = np.random.RandomState(11)
    x, y = rng.randn(n, D), rng.randn(n, 1)
    if route == "general":
        jk = jax_kernels.Rbf(D, ARD=True) + jax_kernels.Matern32(D)
        tk = kernels.Rbf(D, ARD=True) + kernels.Matern32(D)
        W, b = np.array([[0.3, -0.2, 0.1]]), np.array([0.1])
        jm, tm = jax_means.LinearMean(D, 1, W=W, b=b), mean_functions.LinearMean(D, 1, W=W, b=b)
    else:
        jk, tk, jm, tm = jax_kernels.Rbf(D, ARD=True), kernels.Rbf(D, ARD=True), None, None
    fast = route != "generic"
    common = dict(fast=fast, fast_block=NB, fast_jitter=JITTER, fast_rel_jitter=REL)
    jax_model = JaxGPR(x, y, jk, mean_function=jm, likelihood=jax_likelihoods.Gaussian(0.1), **common)
    values = {k: np.asarray(v) + 0.2 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jax_model).items()}
    model = GPR(x, y, tk, mean_function=tm, likelihood=likelihoods.Gaussian(0.1), device="cpu", **common)
    convert.load_trainable(model, values)
    return jax_model, {k: jnp.asarray(v) for k, v in values.items()}, model


@pytest.mark.parametrize("route", ["fast", "general", "generic"])
def test_log_likelihood_routes_match_jax(route):
    jax_model, values, model = _models(route)
    assert model._fast_eligible(model.X) == (route == "fast")
    assert model._general_eligible(model.X) == (route != "generic")
    want, want_grads = jax.jit(
        jax.value_and_grad(lambda v: jax_with_trainable(jax_model, v).log_likelihood())
    )(values)
    got = model.log_likelihood()
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-10)
    for path, raw in get_trainable(model).items():
        np.testing.assert_allclose(raw.grad.numpy(), np.asarray(want_grads[path]), rtol=1e-6, atol=1e-9)


def test_general_nlml_matches_jax():
    """general_nlml called directly, with the kernel-general backward's
    gradient for every trainable leaf of the kernel and the mean."""
    jax_model, values, model = _models("general")
    x, y = jnp.asarray(np.asarray(jax_model.X)), jnp.asarray(np.asarray(jax_model.Y))

    def jax_nlml(v):
        m = jax_with_trainable(jax_model, v)
        noise = m.likelihood.variance.value.reshape(())
        return jg.general_nlml(m.kernel, m.mean_function, noise, x, y, JITTER, NB, REL)

    want, want_grads = jax.jit(jax.value_and_grad(jax_nlml))(values)
    noise = model.likelihood.variance.value.reshape(())
    got = tg.general_nlml(model.kernel, model.mean_function, noise, model.X, model.Y, JITTER, NB, REL)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-10)
    for path, raw in get_trainable(model).items():
        np.testing.assert_allclose(raw.grad.numpy(), np.asarray(want_grads[path]), rtol=1e-6, atol=1e-9)
