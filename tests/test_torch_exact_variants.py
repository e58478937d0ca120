"""The port's exact-data variants of GPR (gptorch_tpu_torch.models.TPR,
WarpedGPR with TanhWarp, LaplaceGP) against the JAX package, float64 on
the CPU, data from numpy seeds (n = 20, d = 2), trainables spread from the
start and loaded into both by ``convert.load_trainable``; the JAX
references from one compiled call per case.

* TPR: loss 1e-10 relative, gradient 1e-10 of its largest entry,
  predict_f, predict_y and the Student-t predict_log_density 1e-10;
  posterior draws held by their moments (the multivariate-t's mean and
  covariance).
* WarpedGPR: loss and gradient as above; predict_f, predict_quantiles
  (60 steps of bisection) and predict_mean (Gauss–Hermite of the inverse
  warp) 1e-10.
* LaplaceGP (Bernoulli probit; Poisson on two columns): the evidence
  1e-10 relative, its gradient through the 20 Newton steps 1e-8 of its
  largest entry, the mode 1e-8, predict_f (diagonal and full) 1e-8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu.models import TPR as JaxTPR
from gptorch_tpu.models import LaplaceGP as JaxLaplaceGP
from gptorch_tpu.models import WarpedGPR as JaxWarpedGPR
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu_torch import convert, kernels, likelihoods
from gptorch_tpu_torch.models import TPR, LaplaceGP, WarpedGPR
from gptorch_tpu_torch.module import get_trainable

N, D = 20, 2
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data(case):
    rng = np.random.RandomState(0)
    x = rng.randn(N, D)
    f = np.sin(2.0 * x[:, :1])
    xs = rng.randn(5, D)
    if case == "tpr":
        y = f + 0.1 * rng.randn(N, 1)
        y[3] += 3.0  # an outlier
        return x, y, xs, rng.randn(5, 1)
    if case == "warped":
        return x, np.exp(f + 0.1 * rng.randn(N, 1)), xs, None
    if case == "probit":
        return x, (f + 0.3 * rng.randn(N, 1) > 0).astype(float), xs, None
    return x, rng.poisson(np.exp(np.c_[f, -f])).astype(float), xs, None  # poisson2: two count columns


def _models(lib, liks, case, device=None):
    x, y, _, _ = _data(case)
    kw = {} if device is None else {"device": device}
    if case == "tpr":
        return (JaxTPR if device is None else TPR)(x, y, lib.Rbf(D, ARD=True), likelihood=liks.Gaussian(0.1),
                                                   nu=4.0, **kw)
    if case == "warped":
        return (JaxWarpedGPR if device is None else WarpedGPR)(x, y, lib.Rbf(D, ARD=True), **kw)
    lik = liks.Bernoulli() if case == "probit" else liks.Poisson()
    return (JaxLaplaceGP if device is None else LaplaceGP)(x, y, lib.Rbf(D, ARD=True), likelihood=lik, **kw)


@functools.lru_cache(maxsize=None)
def _jax(case):
    _, _, xs, ys = _data(case)
    jm = _models(jax_kernels, jax_likelihoods, case)
    rng = np.random.RandomState(1)
    values = {k: np.asarray(v) + 0.1 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jm).items()}
    jm = jax_with_trainable(jm, values)
    q = jnp.asarray(xs)

    @jax.jit
    def refs(m):
        loss, grads = jax.value_and_grad(lambda mm: mm._loss())(m)
        out = {"loss": loss, "grads": jax_get_trainable(grads), "f": m.predict_f(q)}
        if case == "tpr":
            out.update(y=m.predict_y(q), lpd=m.predict_log_density(q, jnp.asarray(ys)),
                       full=m._conditional(q[:2], diag=False)[:2])
        elif case == "warped":
            out.update(quantiles=m.predict_quantiles(q), mean=m.predict_mean(q))
        else:
            out.update(mode=m.mode(), f_full=m.predict_f(q, diag=False))
        return out

    return values, jax.tree_util.tree_map(np.asarray, refs(jm))


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _port(case):
    values, refs = _jax(case)
    tm = _models(kernels, likelihoods, case, device="cpu")
    convert.load_trainable(tm, values)
    return tm, refs


@pytest.mark.parametrize("case", ["tpr", "warped", "probit", "poisson2"])
def test_loss_and_gradient_match_jax(case):
    tm, refs = _port(case)
    loss = tm._loss()
    assert float(loss) == pytest.approx(float(refs["loss"]), rel=RTOL)
    loss.backward()
    got = {k: v.grad.numpy() for k, v in get_trainable(tm).items()}
    assert set(got) == set(refs["grads"])
    for k, want in refs["grads"].items():
        _close(got[k], want, RTOL if case in ("tpr", "warped") else 1e-8)


def test_tpr_predictions_and_draws():
    tm, refs = _port("tpr")
    _, _, xs, ys = _data("tpr")
    for key, got in (("f", tm.predict_f(xs)), ("y", tm.predict_y(xs))):
        for a, b in zip(got, refs[key]):
            _close(a, b)
    _close(tm.predict_log_density(xs, ys), refs["lpd"])
    assert tm.predictive_dof() == pytest.approx(float(tm.nu.value) + N)
    # 20000 joint draws at two queries: the multivariate-t's mean and covariance
    mean, cov = refs["full"]
    draws = tm.predict_f_samples(xs[:2], 20000, generator=torch.Generator().manual_seed(0))[..., 0]
    sd = np.sqrt(np.diagonal(cov))
    assert (np.abs(draws.mean(0) - mean[:, 0]) <= 4 * sd / np.sqrt(20000)).all()
    assert np.abs(np.cov(draws.T) - cov).max() <= 0.05 * np.abs(cov).max()


def test_warped_predictions():
    tm, refs = _port("warped")
    _, _, xs, _ = _data("warped")
    for a, b in zip(tm.predict_f(xs), refs["f"]):
        _close(a, b)
    for a, b in zip(tm.predict_quantiles(xs), refs["quantiles"]):
        _close(a, b)
    _close(tm.predict_mean(xs), refs["mean"])
    z = torch.linspace(-3.0, 3.0, 7, dtype=torch.float64)
    np.testing.assert_allclose(tm.warp(tm.warp.inverse(z)).detach().numpy(), z.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", ["probit", "poisson2"])
def test_laplace_mode_and_predictions(case):
    tm, refs = _port(case)
    _, _, xs, _ = _data(case)
    _close(tm.mode().detach().numpy(), refs["mode"], 1e-8)
    for key, args in (("f", (xs,)), ("f_full", (xs, False))):
        for a, b in zip(tm.predict_f(*args), refs[key]):
            _close(a, b, 1e-8)
    assert not tm._reads_jitter_policy()  # B = I + √W K √W is factored bare


def test_rejects():
    x, y, _, _ = _data("tpr")
    with pytest.raises(ValueError, match="nu must exceed 2"):
        TPR(x, y, kernels.Rbf(D), nu=2.0, device="cpu")
    with pytest.raises(ValueError, match="Gaussian likelihood"):
        TPR(x, y, kernels.Rbf(D), likelihood=likelihoods.Bernoulli(), device="cpu")
