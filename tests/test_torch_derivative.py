"""The port's gradient-enhanced exact GP (gptorch_tpu_torch.models.
DerivativeGPR) against the JAX package, float64 on the CPU, data from
numpy seeds (n = 10, d = 3), trainables spread from the start and loaded
into both by ``convert.load_trainable``; the JAX references from one
compiled call per case.

* Loss 1e-10 relative, its gradient 1e-10 of its largest entry, for an
  Rbf-ARD kernel, and for a composite Rbf + RationalQuadratic·Linear with a
  LinearMean (its gradient enters the joint mean) and a FixedNoiseGaussian
  likelihood (per-observation value noise).
* predict_f (diagonal and full) and predict_grad: 1e-10 of each output's
  largest entry.
* The derivative blocks come from the kernels' pair functions: Rbf's own
  scalar formula equals its Gram entry, and a composite composes them.
  Every kernel that holds an Rbf (sums, products, the wrappers,
  ChangePoints, MultiFidelity) reaches ∂²k without calling rbf_gram.
* Non-smooth kernels, a non-Gaussian likelihood, dy > 1 and a wrong dydx
  raise as in the JAX package.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu import mean_functions as jax_means
from gptorch_tpu.models import DerivativeGPR as JaxDerivativeGPR
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu_torch import convert, kernels, likelihoods, mean_functions
from gptorch_tpu_torch.models import DerivativeGPR
from gptorch_tpu_torch.module import get_trainable

N, D = 10, 3
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data():
    rng = np.random.RandomState(0)
    x = rng.randn(N, D)
    s = x.sum(1, keepdims=True)
    return x, np.sin(s) + 0.01 * rng.randn(N, 1), np.cos(s) * np.ones((1, D)), rng.randn(4, D)


def _build(lib, means, liks, case):
    if case == "rbf":
        return dict(kernel=lib.Rbf(D, ARD=True))
    return dict(kernel=lib.Rbf(D, ARD=True) + lib.RationalQuadratic(D) * lib.Linear(D),
                mean_function=means.LinearMean(D, 1, W=np.full((1, D), 0.3), b=np.zeros(1)),
                likelihood=liks.FixedNoiseGaussian(np.linspace(0.01, 0.05, N), extra_variance=0.02))


@functools.lru_cache(maxsize=None)
def _jax(case):
    x, y, g, xs = _data()
    jm = JaxDerivativeGPR(x, y, dydx=g, **_build(jax_kernels, jax_means, jax_likelihoods, case))
    rng = np.random.RandomState(1)
    values = {k: np.asarray(v) + 0.1 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jm).items()}
    jm = jax_with_trainable(jm, values)

    @jax.jit
    def refs(m):
        loss, grads = jax.value_and_grad(lambda mm: mm._loss())(m)
        q = jnp.asarray(xs)
        return {"loss": loss, "grads": jax_get_trainable(grads), "f": m.predict_f(q),
                "f_full": m.predict_f(q, diag=False), "grad": m.predict_grad(q)}

    return values, jax.tree_util.tree_map(np.asarray, refs(jm))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("case", ["rbf", "composite"])
def test_matches_jax(case):
    x, y, g, xs = _data()
    values, refs = _jax(case)
    tm = DerivativeGPR(x, y, dydx=g, device="cpu", **_build(kernels, mean_functions, likelihoods, case))
    convert.load_trainable(tm, values)
    loss = tm._loss()
    assert float(loss) == pytest.approx(float(refs["loss"]), rel=RTOL)
    loss.backward()
    got = {k: v.grad.numpy() for k, v in get_trainable(tm).items()}
    assert set(got) == set(refs["grads"])
    for k, want in refs["grads"].items():
        _close(got[k], want)
    for key, out in (("f", tm.predict_f(xs)), ("f_full", tm.predict_f(xs, diag=False)),
                     ("grad", tm.predict_grad(xs))):
        for a, b in zip(out, refs[key]):
            _close(a, b)


def test_pair_functions():
    """Rbf's scalar formula is its Gram entry; a composite's pair composes
    its parts' (the default ``K`` on two rows)."""
    rng = np.random.RandomState(2)
    a, b = torch.as_tensor(rng.randn(D)), torch.as_tensor(rng.randn(D))
    k = kernels.Rbf(D, ARD=True, length_scales=[0.5, 1.0, 2.0], variance=1.7)
    assert float(k.pair(a, b)) == pytest.approx(float(k.K(a[None], b[None])[0, 0]), rel=1e-14)
    c = k + kernels.RationalQuadratic(D) * kernels.Linear(D)
    assert float(c.pair(a, b)) == pytest.approx(float(c.K(a[None], b[None])[0, 0]), rel=1e-14)
    act = kernels.ActiveDims(kernels.Rbf(2), [0, 2], D)
    assert float(act.pair(a, b)) == pytest.approx(float(act.K(a[None], b[None])[0, 0]), rel=1e-14)
    cp = kernels.ChangePoints([kernels.Rbf(1), kernels.Rbf(1, variance=0.5)], [0.2], steepness=2.0)
    assert float(cp.pair(a[:1], b[:1])) == pytest.approx(float(cp.K(a[None, :1], b[None, :1])[0, 0]), rel=1e-14)
    mf = kernels.MultiFidelity([kernels.Rbf(D - 1, ARD=True), kernels.Rbf(D - 1)], rho=0.7)
    for s1, s2 in ((0.0, 1.0), (1.0, 1.0)):
        fa, fb = a.clone(), b.clone()
        fa[-1], fb[-1] = s1, s2
        assert float(mf.pair(fa, fb)) == pytest.approx(float(mf.K(fa[None], fb[None])[0, 0]), rel=1e-14)


@pytest.mark.parametrize("name", ["sum", "product", "active_dims", "deep", "input_warp", "changepoints",
                                  "multifidelity"])
def test_pair_never_reaches_the_gram_kernel(name, monkeypatch):
    """Every kernel that holds an Rbf composes the parts' ``pair``, so the
    derivative blocks (forward over reverse mode) never call rbf_gram, whose
    card kernel has no forward-mode rule: with rbf_gram made to raise, ∂²k
    still comes out, equal to the finite difference of ∂k."""
    from gptorch_tpu_torch import nn

    rbf = kernels.Rbf
    if name == "sum":
        k, d = rbf(D, ARD=True) + rbf(D), D
    elif name == "product":
        k, d = rbf(D, ARD=True) * kernels.Linear(D), D
    elif name == "active_dims":
        k, d = kernels.ActiveDims(rbf(2), [0, 2], D), D
    elif name == "deep":
        k, d = kernels.DeepKernel(rbf(2), nn.MLP([D, 4, 2])), D
    elif name == "input_warp":
        k, d = kernels.InputWarp(rbf(D), a=1.5, b=0.7), D
    elif name == "changepoints":
        k, d = kernels.ChangePoints([rbf(1), rbf(1, variance=0.5)], [0.2], steepness=2.0), 1
    else:
        k, d = kernels.MultiFidelity([rbf(D - 1, ARD=True), rbf(D - 1)], rho=0.7), D
    rng = np.random.RandomState(3)
    a, b = torch.as_tensor(rng.rand(d)), torch.as_tensor(rng.rand(d))
    if name == "multifidelity":
        a[-1], b[-1] = 0.0, 1.0
    dk = torch.func.grad(k.pair, argnums=0)
    monkeypatch.setattr(kernels, "rbf_gram", lambda *args, **kw: pytest.fail("pair reached rbf_gram"))
    hess = torch.func.jacfwd(dk, argnums=1)(a, b)
    h = 1e-6
    for j in range(d - 1 if name == "multifidelity" else d):  # the fidelity column is discrete
        e = torch.zeros(d, dtype=b.dtype)
        e[j] = h
        fd = (dk(a, b + e) - dk(a, b - e)) / (2 * h)
        np.testing.assert_allclose(hess[:, j].detach().numpy(), fd.detach().numpy(), rtol=0, atol=1e-7)
    if name == "multifidelity":
        assert not hess[:, -1].any() and not hess[-1].any()


def test_rejects():
    x, y, g, _ = _data()
    for k in (kernels.Matern32(D), kernels.Rbf(D) + kernels.White(D), kernels.Exp(D)):
        with pytest.raises(ValueError, match="twice differentiable"):
            DerivativeGPR(x, y, k, g, device="cpu")
    with pytest.raises(ValueError, match="Gaussian likelihood"):
        DerivativeGPR(x, y, kernels.Rbf(D), g, likelihood=likelihoods.Bernoulli(), device="cpu")
    with pytest.raises(ValueError, match="single output"):
        DerivativeGPR(x, np.c_[y, y], kernels.Rbf(D), g, device="cpu")
    with pytest.raises(ValueError, match="dydx"):
        DerivativeGPR(x, y, kernels.Rbf(D), g[:, :2], device="cpu")
    tm = DerivativeGPR(x, y, kernels.Rbf(D), g, device="cpu")
    with pytest.raises(ValueError, match="minibatching"):
        tm.log_likelihood(x=torch.as_tensor(x))
