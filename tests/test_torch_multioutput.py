"""The port's correlated-output models (gptorch_tpu_torch.models.ICM, LMC,
ICMPosterior, LMCPosterior, lmc_posterior and LMC's stacked-q natural
step) against the JAX package, float64 on the CPU, data from numpy seeds
(n = 24, d = 2, p = 3), trainables spread from the start and loaded into
both by ``convert.load_trainable``; the JAX references from one compiled
call per model.

* ICM: loss 1e-10 relative; gradient 1e-8 of its largest entry (it passes
  through both ``eigh`` backwards, which divide by eigenvalue gaps);
  predict_f, the cached posterior's predict_f and predict_f_joint 1e-10;
  joint samples held by their moments.
* LMC: the ELBO on the full data and on an explicit batch 1e-10 relative,
  its gradient 1e-10 of its largest entry; predict_f, the posterior's
  predict_f and predict_f_joint 1e-10; one stacked-q natural step (q(u) of
  each latent) 1e-9.
* A single kernel is replicated into deep copies: each latent has its own
  Params, as the JAX package's ``copy.deepcopy`` gives each its own leaves.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu.models import ICM as JaxICM
from gptorch_tpu.models import LMC as JaxLMC
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu.training.natgrad import make_natgrad_step as jax_make_natgrad_step
from gptorch_tpu_torch import convert, kernels
from gptorch_tpu_torch.models import ICM, LMC, ICMPosterior, LMCPosterior
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.training.natgrad import make_natgrad_step

N, D, P = 24, 2, 3
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
    f = np.c_[np.sin(x[:, :1]), np.cos(x[:, 1:]), 0.5 * x[:, :1] * x[:, 1:]]
    return x, f @ rng.randn(P, P) + 0.1 * rng.randn(N, P), rng.randn(5, D)


def _spread(jm, seed, scale):
    rng = np.random.RandomState(seed)
    values = {k: np.asarray(v) + scale * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jm).items()}
    return jax_with_trainable(jm, values), values


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _grads(model):
    return {k: v.grad.numpy() for k, v in get_trainable(model).items()}


@functools.lru_cache(maxsize=None)
def _icm():
    x, y, xs = _data()
    jm, values = _spread(JaxICM(x, y, jax_kernels.Rbf(D, ARD=True), rank=2), 1, 0.2)

    @jax.jit
    def refs(m):
        loss, grads = jax.value_and_grad(lambda mm: mm._loss())(m)
        post = m.posterior()
        return {"loss": loss, "grads": jax_get_trainable(grads), "f": m.predict_f(jnp.asarray(xs)),
                "post_f": post.predict_f(jnp.asarray(xs)), "joint": m.predict_f_joint(jnp.asarray(xs))}

    return values, jax.tree_util.tree_map(np.asarray, refs(jm))


def _port_icm():
    x, y, _ = _data()
    values, refs = _icm()
    tm = ICM(x, y, kernels.Rbf(D, ARD=True), rank=2, device="cpu")
    convert.load_trainable(tm, values)
    return tm, refs


def test_icm_loss_and_gradient_match_jax():
    tm, refs = _port_icm()
    loss = tm._loss()
    assert float(loss) == pytest.approx(float(refs["loss"]), rel=RTOL)
    loss.backward()
    got = _grads(tm)
    assert set(got) == set(refs["grads"]) == {"W", "kappa", "kernel.length_scales", "kernel.variance",
                                              "likelihood.variance"}
    for k, want in refs["grads"].items():
        _close(got[k], want, 1e-8)


def test_icm_predictions_match_jax():
    tm, refs = _port_icm()
    _, _, xs = _data()
    post = tm.posterior()
    assert isinstance(post, ICMPosterior)
    for key, got in (("f", tm.predict_f(xs)), ("post_f", post.predict_f(xs)), ("joint", tm.predict_f_joint(xs))):
        for a, b in zip(got, refs[key]):
            _close(a, b)
    with pytest.raises(NotImplementedError, match="predict_f_joint"):
        tm.predict_f(xs, diag=False)


def test_icm_joint_samples_moments():
    """4000 correlated draws at two queries: means within 4 standard errors
    of the joint mean, the (point, output) covariance within 0.1 of its
    largest entry."""
    tm, _ = _port_icm()
    _, _, xs = _data()
    mean, cov = tm.predict_f_joint(xs[:2])
    draws = tm.predict_f_joint_samples(xs[:2], 4000, generator=torch.Generator().manual_seed(0))
    assert draws.shape == (4000, 2, P)
    sd = np.sqrt(np.diagonal(cov.reshape(2 * P, 2 * P))).reshape(2, P)
    assert (np.abs(draws.mean(0) - mean) <= 4 * sd / np.sqrt(4000)).all()
    emp = np.cov(draws.reshape(4000, -1).T)
    assert np.abs(emp - cov.reshape(2 * P, 2 * P)).max() <= 0.1 * np.abs(cov).max()


@functools.lru_cache(maxsize=None)
def _lmc():
    x, y, xs = _data()
    jm = JaxLMC(x, y, jax_kernels.Rbf(D, ARD=True), num_latents=2, inducing_points=x[:6])
    jm, values = _spread(jm, 2, 0.05)
    xb, yb = x[::3], y[::3]

    @jax.jit
    def refs(m):
        loss, grads = jax.value_and_grad(lambda mm: mm._loss())(m)
        return {"loss": loss, "grads": jax_get_trainable(grads), "batch": m._loss(jnp.asarray(xb), jnp.asarray(yb)),
                "f": m.predict_f(jnp.asarray(xs)), "post_f": m.posterior().predict_f(jnp.asarray(xs)),
                "joint": m.predict_f_joint(jnp.asarray(xs))}

    step, vals0, opt_state = jax_make_natgrad_step(jm, nat_lr=0.5, optimizer=optax.sgd(0.0))
    nat, _, nat_loss = step(vals0, opt_state, jm, jax.random.PRNGKey(0), jnp.asarray(0.5))
    out = jax.tree_util.tree_map(np.asarray, refs(jm))
    out["nat"] = {k: np.asarray(v) for k, v in nat.items()}
    out["nat_loss"] = float(nat_loss)
    return np.asarray(jm.Z.value), values, out


def _port_lmc():
    x, y, _ = _data()
    z, values, refs = _lmc()
    tm = LMC(x, y, kernels.Rbf(D, ARD=True), num_latents=2, inducing_points=z, device="cpu")
    convert.load_trainable(tm, values)
    return tm, refs


def test_lmc_elbo_and_gradient_match_jax():
    tm, refs = _port_lmc()
    x, y, _ = _data()
    loss = tm._loss()
    assert float(loss) == pytest.approx(float(refs["loss"]), rel=RTOL)
    xb, yb = torch.as_tensor(x[::3]), torch.as_tensor(y[::3])
    assert float(tm._loss(xb, yb)) == pytest.approx(float(refs["batch"]), rel=RTOL)
    loss.backward()
    got = _grads(tm)
    assert set(got) == set(refs["grads"])
    for k, want in refs["grads"].items():
        _close(got[k], want)


def test_lmc_predictions_match_jax():
    tm, refs = _port_lmc()
    _, _, xs = _data()
    post = tm.posterior()
    assert isinstance(post, LMCPosterior)
    for key, got in (("f", tm.predict_f(xs)), ("post_f", post.predict_f(xs)), ("joint", tm.predict_f_joint(xs))):
        for a, b in zip(got, refs[key]):
            _close(a, b)
    draws = tm.predict_f_joint_samples(xs[:2], 3, generator=torch.Generator().manual_seed(0))
    assert draws.shape == (3, 2, P) and np.isfinite(draws).all()


def test_lmc_stacked_natural_step_matches_jax():
    """One natural step on the stacked q (each latent's own update) with the
    hyperparameters held (SGD at rate 0), against the JAX step: 1e-9."""
    tm, refs = _port_lmc()
    step, _ = make_natgrad_step(tm, nat_lr=0.5, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.0))
    assert float(step()) == pytest.approx(refs["nat_loss"], rel=RTOL)
    got = {k: v.detach().numpy() for k, v in get_trainable(tm).items()}
    for k in ("q_mu", "q_chol"):
        assert got[k].shape == refs["nat"][k].shape
        _close(got[k], refs["nat"][k], 1e-9)


def test_lmc_replicas_are_deep_copies():
    """One kernel given for L latents becomes L deep copies: separate
    modules and Params under kernel.k0.*, kernel.k1.*, as the JAX package's
    separate leaves; the template itself is none of them."""
    x, y, _ = _data()
    template = kernels.Rbf(D, ARD=True)
    tm = LMC(x, y, template, num_latents=2, inducing_points=x[:6], device="cpu")
    k0, k1 = tm.kernels[0], tm.kernels[1]
    assert k0 is not k1 and template is not k0 and template is not k1
    assert k0.variance is not k1.variance and k0.variance.raw is not k1.variance.raw
    with torch.no_grad():
        k0.variance.raw.add_(1.0)
    assert float(k1.variance.value) == pytest.approx(float(template.variance.value))
    paths = [p for p, _ in tm.named_params()]
    assert "kernel.k0.variance" in paths and "kernel.k1.variance" in paths and len(paths) == len(set(paths))
    with pytest.raises(ValueError, match="num_latents"):
        LMC(x, y, [kernels.Rbf(D)], num_latents=2, device="cpu")
