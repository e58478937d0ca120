"""The rest of the port's exact-GP user surface against the JAX package,
float64 on the CPU: the Linear and Polynomial kernels (and GPR with the
reference example's Linear + Rbf + Constant composite through the
kernel-general path at n = 4096), ``functions.cholesky(blocked=)``,
``module.with_trainable`` / ``tree_map_params`` / ``Module.gradcheck``,
``util.PCA``, ``GPModel.loss(params=)``, the posterior samplers and
``GPR(objective="loo")``.

Tolerance rel 1e-9 for values; gradients within 1e-8 of their largest
entry (the two packages' factorizations and solves round differently).
Random draws differ between torch and JAX for the same seed, so the
samplers are held against JAX on the same explicit normals (the port draws
every normal through ``sampling.standard_normal``, which a test can
replace) and, with a ``torch.Generator``, by their moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd.gradcheck import GradcheckError

from gptorch_tpu import functions as jax_functions
from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu import util as jax_util
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import tree_map_params as jax_tree_map_params
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu_torch import convert, functions, kernels, likelihoods, sampling, settings, util
from gptorch_tpu_torch.models import GPR
from gptorch_tpu_torch.module import get_trainable, tree_map_params, with_trainable
from gptorch_tpu_torch.ops import blocked
from gptorch_tpu_torch.param import Param

RTOL, GRAD_RTOL = 1e-9, 1e-8
D = 3
XS = np.random.RandomState(4).randn(6, D) * 1.5


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data(n, d=D, dy=1, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    return x, np.sin(x[:, :1] * np.arange(1, dy + 1)) + 0.1 * rng.randn(n, dy) + 0.2


def _assert_grads(got, want):
    """Gradients by path, within GRAD_RTOL of the largest entry."""
    scale = max(np.abs(np.asarray(g)).max() for g in want.values())
    assert set(got) == set(want)
    for path, g in got.items():
        np.testing.assert_allclose(np.asarray(g), np.asarray(want[path]), rtol=0, atol=GRAD_RTOL * scale)


def _composite(mod, d=D):
    return mod.Linear(d, ARD=True, variance=[0.3, 0.5, 0.7][:d]) + mod.Rbf(d, ARD=True) + mod.Constant(d)


KERNELS = {
    "linear": lambda k: k.Linear(D, variance=0.7),
    "linear ARD": lambda k: k.Linear(D, variance=[0.3, 1.2, 0.8]),
    "poly 1": lambda k: k.Polynomial(D, degree=1, variance=0.7, offset=0.1),
    "poly 2": lambda k: k.Polynomial(D, degree=2, variance=[0.3, 1.2, 0.8], offset=0.1),
    "poly 3": lambda k: k.Polynomial(D, degree=3, variance=0.7, offset=0.1),
    "poly 4 ARD": lambda k: k.Polynomial(D, degree=4, variance=[0.3, 1.2, 0.8], offset=0.2, ARD=True),
    "poly 5": lambda k: k.Polynomial(D, degree=5, variance=0.4, offset=0.3),
}


@pytest.mark.parametrize("name", KERNELS)
def test_dot_product_kernels_match_jax(name):
    """K (self and cross), Kdiag, and the gradient of Σ C⊙K in every
    hyperparameter and in X; the base of Polynomial is negative on about
    half the pairs."""
    rng = np.random.RandomState(1)
    x, x2, C = rng.randn(9, D), rng.randn(5, D), rng.randn(9, 9)
    jk, tk = KERNELS[name](jax_kernels), KERNELS[name](kernels)
    values = {k: np.asarray(v) for k, v in jax_get_trainable(jk).items()}
    convert.load_trainable(tk, values)
    assert tk.ARD == jk.ARD
    np.testing.assert_allclose(tk.K(torch.tensor(x)).detach(), jk.K(jnp.asarray(x)), rtol=RTOL)
    np.testing.assert_allclose(tk.K(torch.tensor(x), torch.tensor(x2)).detach(),
                               jk.K(jnp.asarray(x), jnp.asarray(x2)), rtol=RTOL)
    np.testing.assert_allclose(tk.Kdiag(torch.tensor(x)).detach(), jk.Kdiag(jnp.asarray(x)), rtol=RTOL)
    if name.startswith("poly"):
        base = np.asarray(jax_kernels.Linear.K(jk, jnp.asarray(x))) + float(np.asarray(jk.offset.value)[0])
        assert (base < 0).mean() > 0.2

    def jax_obj(v, xx):
        return jnp.sum(jnp.asarray(C) * jax_with_trainable(jk, v).K(xx))

    want_v, want_x = jax.grad(jax_obj, argnums=(0, 1))({k: jnp.asarray(v) for k, v in values.items()},
                                                       jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    torch.sum(torch.tensor(C) * tk.K(xt)).backward()
    _assert_grads({k: r.grad for k, r in get_trainable(tk).items()}, want_v)
    np.testing.assert_allclose(xt.grad, want_x, rtol=0, atol=GRAD_RTOL * np.abs(want_x).max())


def test_polynomial_rejects_degree_zero():
    with pytest.raises(ValueError, match="degree"):
        kernels.Polynomial(D, degree=0)


def test_composite_paths_carry_across():
    """load_trainable fills a composite's nested paths (kernel.kern1.kern1.variance, ...)."""
    x, y = _data(30)
    jm = JaxGPR(x, y, _composite(jax_kernels) * jax_kernels.Polynomial(D, degree=2),
                likelihood=jax_likelihoods.Gaussian(0.1))
    tm = GPR(x, y, _composite(kernels) * kernels.Polynomial(D, degree=2), likelihood=likelihoods.Gaussian(0.1),
             device="cpu")
    rng = np.random.RandomState(3)
    values = {k: np.asarray(v) + 0.1 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jm).items()}
    assert "kernel.kern1.kern1.kern1.variance" in values and "kernel.kern2.offset" in values
    convert.load_trainable(tm, values)
    want = jax.jit(lambda v: jax_with_trainable(jm, v)._loss())({k: jnp.asarray(v) for k, v in values.items()})
    assert float(tm.loss().detach()) == pytest.approx(float(want), rel=RTOL)


def test_composite_gpr_general_path_at_4096():
    """Linear + Rbf + Constant at n = 4096 takes the kernel-general fused
    path in both packages (auto-routed); NLML and gradient agree."""
    x, y = _data(4096, d=2)
    jm = JaxGPR(x, y, _composite(jax_kernels, 2), likelihood=jax_likelihoods.Gaussian(0.1), fast_block=2048)
    tm = GPR(x, y, _composite(kernels, 2), likelihood=likelihoods.Gaussian(0.1), fast_block=2048, device="cpu")
    assert tm._general_eligible(tm.X) and not tm._fast_eligible(tm.X)
    want, want_grads = jax.jit(jax.value_and_grad(lambda v: jax_with_trainable(jm, v)._loss()))(
        jax_get_trainable(jm))
    got = tm.loss()
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=RTOL)
    _assert_grads({k: r.grad for k, r in get_trainable(tm).items()}, want_grads)


def _spd(n, seed=0):
    a = np.random.RandomState(seed).randn(n, n)
    return a @ a.T / n + np.eye(n)


def test_cholesky_blocked_route(monkeypatch):
    """blocked=True takes ops.blocked.cholesky_blocked from _BLOCKED_MIN_N
    on (the threshold lowered to 32 in both packages, so n = 96 is
    blocked), blocked=False never; value and gradient as the JAX
    package's blocked route."""
    calls = []
    real = blocked.cholesky_blocked
    monkeypatch.setattr(blocked, "cholesky_blocked", lambda a, *r: calls.append(a.shape) or real(a, *r))
    monkeypatch.setattr(functions, "_BLOCKED_MIN_N", 32)
    monkeypatch.setattr(jax_functions, "_BLOCKED_MIN_N", 32)
    a, C = _spd(96), np.tril(np.random.RandomState(1).randn(96, 96))
    for policy in ("none", "fixed", "adaptive"):
        want, want_g = jax.jit(jax.value_and_grad(
            lambda m: jnp.sum(jnp.asarray(C) * jax_functions.cholesky(m, policy=policy, blocked=True))))(
            jnp.asarray(a))
        at = torch.tensor(a, requires_grad=True)
        got = torch.sum(torch.tensor(C) * functions.cholesky(at, policy=policy, blocked=True))
        got.backward()
        assert float(got.detach()) == pytest.approx(float(want), rel=RTOL)
        np.testing.assert_allclose(at.grad, want_g, rtol=0, atol=GRAD_RTOL * np.abs(want_g).max())
    assert calls == [(96, 96)] * 3
    functions.cholesky(torch.tensor(a), blocked=False)
    functions.cholesky(torch.tensor(_spd(20)), blocked=True)
    assert len(calls) == 3


def test_cholesky_blocked_threshold_is_4096(monkeypatch):
    """At the real threshold one matrix of n = 4096 takes the blocked route,
    n = 4095, blocked=False and a batch do not (both routes are spied, not
    run)."""
    calls = []
    monkeypatch.setattr(blocked, "cholesky_blocked", lambda a, *r: calls.append(("blocked", a.shape)) or a)
    ok = torch.zeros((), dtype=torch.int32)
    monkeypatch.setattr(torch.linalg, "cholesky_ex", lambda a: calls.append(("cholesky_ex", a.shape)) or (a, ok))
    assert functions._BLOCKED_MIN_N == 4096
    functions.cholesky(torch.eye(4096), policy="none")
    functions.cholesky(torch.eye(4095), policy="none")
    functions.cholesky(torch.eye(4096), policy="none", blocked=False)
    functions.cholesky(torch.eye(8).expand(2, 8, 8), policy="none")
    assert calls == [("blocked", (4096, 4096)), ("cholesky_ex", (4095, 4095)), ("cholesky_ex", (4096, 4096)),
                     ("cholesky_ex", (2, 8, 8))]


def _gpr_pair(route="generic", n=40, dy=1, objective="nlml"):
    x, y = _data(n, dy=dy)
    kern = {"generic": lambda k: k.Rbf(D, ARD=True), "fast": lambda k: k.Rbf(D, ARD=True),
            "general": lambda k: _composite(k)}[route]
    common = dict(fast={"generic": None, "fast": True, "general": True}[route], fast_block=16, objective=objective)
    jm = JaxGPR(x, y, kern(jax_kernels), likelihood=jax_likelihoods.Gaussian(0.1), **common)
    tm = GPR(x, y, kern(kernels), likelihood=likelihoods.Gaussian(0.1), device="cpu", **common)
    rng = np.random.RandomState(5)
    values = {k: np.asarray(v) + 0.1 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jm).items()}
    convert.load_trainable(tm, values)
    return jax_with_trainable(jm, {k: jnp.asarray(v) for k, v in values.items()}), tm


def test_with_trainable_and_tree_map_params_copy():
    jm, tm = _gpr_pair()
    start = {k: v.detach().clone() for k, v in get_trainable(tm).items()}
    new = {k: v + 0.3 for k, v in start.items()}
    other = with_trainable(tm, new)
    jax_loss = jax.jit(lambda m: m._loss())
    want = jax_loss(jax_with_trainable(jm, {k: jnp.asarray(v.numpy()) for k, v in new.items()}))
    assert float(other.loss().detach()) == pytest.approx(float(want), rel=RTOL)
    for k, v in get_trainable(tm).items():
        assert torch.equal(v.detach(), start[k])  # the original is unchanged

    def double(p):
        return Param(p.value.detach() * 2, transform=p.bijector, prior=p.prior, trainable=p.trainable)

    mapped = tree_map_params(double, tm)
    jmapped = jax_tree_map_params(lambda p: p.with_value(p.value * 2), jm)
    assert float(mapped.loss().detach()) == pytest.approx(float(jax_loss(jmapped)), rel=RTOL)
    assert float(tm.loss().detach()) == pytest.approx(float(jax_loss(jm)), rel=RTOL)
    assert mapped.kernel.variance is not tm.kernel.variance


@pytest.mark.parametrize("route", ["generic", "fast", "general"])
def test_loss_at_given_params_matches_jax(route):
    """loss(params=...) at other values, differentiable in the given
    tensors; the model itself does not change."""
    jm, tm = _gpr_pair(route)
    own = float(tm.loss().detach())
    rng = np.random.RandomState(8)
    values = {k: np.asarray(v) + 0.2 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jm).items()}
    want, want_grads = jax.jit(jax.value_and_grad(lambda v: jm._loss() if v is None else jm.loss(params=v)))(
        {k: jnp.asarray(v) for k, v in values.items()})
    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in values.items()}
    got = tm.loss(params=leaves)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=RTOL)
    _assert_grads({k: v.grad for k, v in leaves.items()}, want_grads)
    assert float(tm.loss().detach()) == own
    assert all(r.grad is None for r in get_trainable(tm).values())


def test_gradcheck():
    jm, tm = _gpr_pair("general")
    assert tm.gradcheck() is True and jm.gradcheck() is True
    assert tm.kernel.kern1.kern1.variance.raw.dtype == torch.float64
    with torch.no_grad():
        tm32 = tm.to(torch.float32)
    assert tm32.gradcheck() is True  # checked on a float64 copy


class _WrongGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v):
        return v.clone()

    @staticmethod
    def backward(ctx, g):
        return 2.0 * g


class _BadLinear(kernels.Linear):
    def K(self, X, X2=None):
        other = X if X2 is None else X2
        return (X * _WrongGrad.apply(self.variance.value)) @ other.T


def test_gradcheck_raises_on_a_wrong_gradient():
    x, y = _data(20)
    tm = GPR(x, y, _BadLinear(D) + kernels.Rbf(D), likelihood=likelihoods.Gaussian(0.1), device="cpu")
    with pytest.raises(GradcheckError):
        tm.gradcheck()


def test_pca_matches_jax():
    X = np.random.RandomState(2).randn(40, 5) @ np.random.RandomState(3).randn(5, 5)
    for q in (1, 3, 5):
        np.testing.assert_allclose(util.PCA(X, q), jax_util.PCA(X, q), rtol=RTOL, atol=1e-12)
    with pytest.raises(ValueError):  # the JAX package asserts
        util.PCA(X, 6)


@pytest.mark.parametrize("observed, dy", [(False, 1), (True, 2)])
def test_samples_match_jax_on_the_same_normals(monkeypatch, observed, dy):
    """predict_f_samples / predict_y_samples with the JAX package's normals
    for its key: μ + chol(Σ)·ε in both."""
    jm, tm = _gpr_pair(dy=dy)
    key, S = jax.random.PRNGKey(3), 4
    eps = np.asarray(jax.random.normal(key, (S, XS.shape[0], dy), jnp.float64))
    drawn = []

    def fixed(generator, shape, like):
        drawn.append(tuple(shape))
        return torch.tensor(eps, dtype=like.dtype)

    monkeypatch.setattr(sampling, "standard_normal", fixed)
    fn = "predict_y_samples" if observed else "predict_f_samples"
    want = jax.jit(lambda k: jm._sample(jnp.asarray(XS), S, k, observed=observed))(key)
    got = getattr(tm, fn)(XS, n_samples=S, generator=torch.Generator())
    assert drawn == [(S, XS.shape[0], dy)] and got.shape == (S, XS.shape[0], dy)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=1e-12)


def test_sample_moments_and_generator():
    """Many draws from a torch.Generator have the posterior's mean and
    covariance (within 5 standard errors); a seeded generator repeats; the
    default generator comes from settings and advances its seed."""
    _, tm = _gpr_pair()
    x = XS[:3]
    mu, cov = tm.predict_f(x, diag=False)
    S = 20000
    draws = tm.predict_f_samples(x, n_samples=S, generator=torch.Generator().manual_seed(0))[..., 0]
    sd = np.sqrt(np.diag(cov))
    assert np.all(np.abs(draws.mean(0) - mu[:, 0]) <= 5 * sd / np.sqrt(S))
    emp = np.cov(draws.T)
    se = np.sqrt((cov ** 2 + np.outer(np.diag(cov), np.diag(cov))) / S)
    assert np.all(np.abs(emp - cov) <= 5 * se)
    a = tm.predict_y_samples(x, 3, generator=torch.Generator().manual_seed(7))
    b = tm.predict_y_samples(x, 3, generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(a, b)
    seed = settings.config.default_seed
    c, d = tm.predict_f_samples(x, 2), tm.predict_f_samples(x, 2)
    assert settings.config.default_seed == seed + 2 and not np.array_equal(c, d)


def test_loo_matches_jax():
    """loo_log_likelihood and the objective="loo" loss, with gradients, for
    two outputs (one output: test_loo_blocked_route_matches_jax)."""
    jm, tm = _gpr_pair(n=60, dy=2, objective="loo")
    want = jax.jit(lambda m: m.loo_log_likelihood())(jm)
    assert float(tm.loo_log_likelihood().detach()) == pytest.approx(float(want), rel=RTOL)
    loss, grads = jax.jit(jax.value_and_grad(lambda v: jax_with_trainable(jm, v)._loss()))(jax_get_trainable(jm))
    got = tm.loss()
    got.backward()
    assert float(got.detach()) == pytest.approx(float(loss), rel=RTOL)
    _assert_grads({k: r.grad for k, r in get_trainable(tm).items()}, grads)
    nlml = GPR(tm.X, tm.Y, tm.kernel, likelihood=tm.likelihood, device="cpu")
    assert float(nlml.loss().detach()) != pytest.approx(float(got.detach()))
    with pytest.raises(ValueError, match="objective"):
        GPR(tm.X, tm.Y, kernels.Rbf(D), objective="kfold", device="cpu")


def test_loo_blocked_route_matches_jax(monkeypatch):
    """With the threshold lowered to 32 in both packages, the LOO factor
    takes the blocked route (cholesky_blocked and its closed-form adjoint)
    and the loss and gradient still agree; one Adam step of optimize moves
    the port's model as the gradient says."""
    monkeypatch.setattr(functions, "_BLOCKED_MIN_N", 32)
    monkeypatch.setattr(jax_functions, "_BLOCKED_MIN_N", 32)
    calls = []
    real = blocked.cholesky_blocked
    monkeypatch.setattr(blocked, "cholesky_blocked", lambda a, *r: calls.append(a.shape) or real(a, *r))
    jm, tm = _gpr_pair(n=60, objective="loo")
    loss, grads = jax.jit(jax.value_and_grad(lambda v: jax_with_trainable(jm, v)._loss()))(jax_get_trainable(jm))
    got = tm.loss()
    got.backward()
    assert calls == [(60, 60)]
    assert float(got.detach()) == pytest.approx(float(loss), rel=RTOL)
    _assert_grads({k: r.grad for k, r in get_trainable(tm).items()}, grads)
    start = {k: v.detach().clone() for k, v in get_trainable(tm).items()}
    tm.optimize("Adam", max_iter=1, learning_rate=0.01, verbose=False)
    for path, raw in get_trainable(tm).items():  # Adam's first step is -lr·sign(g)
        want = start[path] - 0.01 * torch.sign(torch.tensor(np.array(grads[path])))
        torch.testing.assert_close(raw.detach(), want, rtol=0, atol=1e-9)
