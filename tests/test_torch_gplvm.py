"""The port's Bayesian GPLVM (gptorch_tpu_torch.models.GPLVM and
gplvm_posterior) against the JAX package, float64 on the CPU, data made from
numpy seeds.

The same constructor arguments give the same start in both packages (the
PCA projection, k-means inducing points, the dynamical prior's ridged
solve); the trainables are then perturbed, carried across by
convert.load_trainable, and every result is compared:

* the collapsed bound within 1e-9 relative and its gradient within 1e-9 of
  the largest entry, for the iid prior, the dynamical prior (diagonal and
  reparameterized q), the large-p form and the Linear ψ-kernel;
* predict_f (diagonal and full), the posterior and its serving twin, and
  predict_uncertain (diagonal and full input covariances) within 1e-9;
* project and impute, whose Adam steps compound rounding, within 1e-8, as
  is the bound after a few Adam steps of training.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import ekernels as jax_ekernels
from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu.models.gplvm import GPLVM as JaxGPLVM
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu.training.fit import fit_optax
from gptorch_tpu_torch import convert, ekernels, kernels, likelihoods, mean_functions
from gptorch_tpu_torch.models import GPLVM, VFE, gplvm_posterior
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.training import fit

N, P, Q, M = 20, 5, 2, 6
RTOL, STEP_RTOL = 1e-9, 1e-8
TIMES = np.arange(N, dtype=float)


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _y(n=N, p=P, seed=0):
    rng = np.random.RandomState(seed)
    return np.tanh(rng.randn(n, Q) @ rng.randn(Q, p)) + 0.05 * rng.randn(n, p)


def _config(name, jax_side):
    """Constructor keywords of one configuration for one package."""
    k = jax_kernels if jax_side else kernels
    ek = jax_ekernels if jax_side else ekernels
    dynamical = dict(times=TIMES, time_kernel=k.Rbf(1, length_scales=1.5))
    return {
        "iid": {},
        "dynamical": dynamical,
        "reparam": dict(dynamical, reparam=True),
        "large_p": dict(large_p=True),
        "linear": dict(kernel=ek.Linear(Q, variance=np.array([0.8, 1.3]))),
    }[name]


CONFIGS = ["iid", "dynamical", "reparam", "large_p", "linear"]


def _models(name, y=None):
    y = _y() if y is None else y
    jm = JaxGPLVM(y, Q, num_inducing_points=M, **_config(name, True))
    tm = GPLVM(y, Q, num_inducing_points=M, device="cpu", **_config(name, False))
    return jm, tm


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX package's results for one configuration at perturbed
    trainables, in one compiled call: (initial values, perturbed values,
    results, query inputs), numpy throughout."""
    jm, _ = _models(name)
    initial = {k: np.asarray(v) for k, v in jax_get_trainable(jm).items()}
    rng = np.random.RandomState(1)
    values = {k: v + 0.05 * rng.randn(*v.shape) for k, v in initial.items()}
    xq, xv = rng.randn(4, Q), 0.2 * np.exp(rng.randn(4, Q))
    a = 0.3 * rng.randn(4, Q, Q)
    xs = a @ a.transpose(0, 2, 1) + 0.05 * np.eye(Q)

    def compute(v, xq, xv, xs):
        m = jax_with_trainable(jm, v)
        out = {}
        out["loss"], out["grads"] = jax.value_and_grad(lambda v: jax_with_trainable(jm, v)._loss())(v)
        out["kl"] = m._kl_x()
        for diag in (True, False):
            out[f"f{diag}"] = m._predict(xq, diag=diag)
        post = m.posterior()
        out["post"] = post.predict_f(xq)
        out["serving"] = post.for_serving(nb=4).predict_f(xq)
        out["u_diag"] = m.predict_uncertain(xq, xv)
        out["u_full"] = m.predict_uncertain(xq, xs)
        return out

    args = ({k: jnp.asarray(v) for k, v in values.items()}, xq, xv, xs)
    out = jax.jit(compute).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)
    return initial, values, jax.tree_util.tree_map(np.asarray, out), (xq, xv, xs)


def _close(got, want, rtol=RTOL):
    got, want = (a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in (got, want))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def _port(name, values):
    _, tm = _models(name)
    convert.load_trainable(tm, values)
    return tm


@pytest.mark.parametrize("name", CONFIGS)
def test_construction_matches_jax(name):
    initial, _, _, _ = _reference(name)
    _, tm = _models(name)
    raws = get_trainable(tm)
    assert sorted(raws) == sorted(initial)
    for path, raw in raws.items():
        _close(raw, initial[path], 1e-12)
    assert tm.num_inducing == M and tm.latent_dimension == Q and tm.output_dimension == P
    assert tm.large_p == (name == "large_p") and tm.dynamical == (name in ("dynamical", "reparam"))


@pytest.mark.parametrize("name", CONFIGS)
def test_bound_and_gradient_match_jax(name):
    _, values, ref, _ = _reference(name)
    tm = _port(name, values)
    loss = tm._loss()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref["loss"]), rel=RTOL)
    _close(tm._kl_x(), ref["kl"])
    scale = max(np.abs(g).max() for g in ref["grads"].values())
    for path, raw in get_trainable(tm).items():
        np.testing.assert_allclose(raw.grad.numpy(), ref["grads"][path], rtol=0, atol=RTOL * scale, err_msg=path)


@pytest.mark.parametrize("name", ["iid", "reparam", "linear"])
def test_predictions_match_jax(name):
    _, values, ref, (xq, xv, xs) = _reference(name)
    tm = _port(name, values)
    for diag in (True, False):
        for got, want in zip(tm.predict_f(xq, diag=diag), ref[f"f{diag}"]):
            _close(got, want)
    post = tm.posterior()
    for key, got in (("post", post.predict_f(xq)), ("serving", post.for_serving(nb=4).predict_f(xq)),
                     ("u_diag", tm.predict_uncertain(xq, xv)), ("u_full", tm.predict_uncertain(xq, xs))):
        for g, w in zip(got, ref[key]):
            _close(g, w)


def test_predict_uncertain_at_zero_variance_is_predict_f():
    _, values, _, (xq, _, _) = _reference("iid")
    tm = _port("iid", values)
    mu_f, var_f = tm.predict_f(xq)
    mu_u, var_u = tm.predict_uncertain(xq, np.zeros_like(xq))
    np.testing.assert_allclose(mu_u, mu_f, rtol=0, atol=1e-10)
    np.testing.assert_allclose(var_u, var_f, rtol=0, atol=1e-10)


def test_posterior_is_frozen_and_holds_no_mean():
    _, values, _, (xq, _, _) = _reference("iid")
    tm = _port("iid", values)
    post = gplvm_posterior(tm)
    before = post.predict_f(xq)
    with torch.no_grad():
        tm.kernel.variance.raw.add_(0.5)
    assert post.mean_function is None
    np.testing.assert_array_equal(post.predict_f(xq)[0], before[0])


def test_project_and_impute_match_jax():
    """A few Adam steps of project (all outputs observed), and impute (two
    observed): the same steps, then predict_uncertain."""
    _, values, _, _ = _reference("iid")
    jm = jax_with_trainable(_models("iid")[0], {k: jnp.asarray(v) for k, v in values.items()})
    tm = _port("iid", values)
    y_new = _y(n=3, seed=5)
    want = jm.project(y_new, max_iter=6, learning_rate=0.05)
    got = tm.project(y_new, max_iter=6, learning_rate=0.05)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        _close(g, w, STEP_RTOL)
    want = jm.impute(y_new[:, [1, 2]], np.array([1, 2]), max_iter=6)
    got = tm.impute(y_new[:, [1, 2]], np.array([1, 2]), max_iter=6)
    for g, w in zip(got, want):
        assert g.shape == (3, P)
        _close(g, w, STEP_RTOL)


def test_adam_steps_match_jax():
    """Three Adam steps of training (the port's optax-rule Adam) give the
    JAX package's losses and bound."""
    _, values, _, _ = _reference("iid")
    jm = jax_with_trainable(_models("iid")[0], {k: jnp.asarray(v) for k, v in values.items()})
    tm = _port("iid", values)
    jm, jlosses, _ = fit_optax(jm, max_iter=3, verbose=False)
    _, tlosses, _ = fit.fit_torch(tm, "Adam", max_iter=3, verbose=False)
    _close(tlosses, jlosses, STEP_RTOL)
    assert float(tm.log_likelihood().detach()) == pytest.approx(float(jm.log_likelihood()), rel=STEP_RTOL)


def test_fit_scan_trains_in_place():
    tm = _models("iid")[1]
    losses = tm.fit_scan("Adam", max_iter=5)
    assert not fit.fit_scan.last_run["captured"]  # the CPU runs eagerly
    assert torch.all(torch.isfinite(losses)) and float(losses[-1]) < float(losses[0])


def test_collapses_to_vfe_at_zero_latent_variance():
    """q(X) pinned at the inputs (variance → 0, set by with_value as the
    JAX tests do) with the KL removed: the bound is VFE's."""
    rng = np.random.RandomState(1)
    x, y, z = rng.randn(16, Q), rng.randn(16, 1), rng.randn(6, Q)
    kern, lik = ekernels.Rbf(Q), likelihoods.Gaussian(variance=0.1)
    model = GPLVM(y, Q, kernel=kern, inducing_points=z, likelihood=lik, jitter=0.0, device="cpu")
    model.Xmean = model.Xmean.with_value(torch.as_tensor(x))
    model.Xvar = model.Xvar.with_value(1e-12 * torch.ones(16, Q))
    bound = float((model.log_likelihood() + model._kl_x()).detach())
    vfe = VFE(x, y, kern, inducing_points=z, likelihood=lik, mean_function=mean_functions.Zero(1), device="cpu")
    assert bound == pytest.approx(float(vfe.log_likelihood().detach()), rel=1e-6)


def test_random_start_when_latents_exceed_outputs():
    y = _y(p=2)
    jm, tm = JaxGPLVM(y, 3, num_inducing_points=4), GPLVM(y, 3, num_inducing_points=4, device="cpu")
    _close(tm.Xmean.value, np.asarray(jm.Xmean.value), 1e-12)


def test_errors_match_jax():
    y = _y()
    with pytest.raises(ValueError, match="requires times"):
        GPLVM(y, Q, reparam=True, device="cpu")
    with pytest.raises(ValueError, match="one entry per datum"):
        GPLVM(y, Q, times=TIMES[:-1], device="cpu")
    with pytest.raises(TypeError, match="psi-statistics"):
        GPLVM(y, Q, kernel=kernels.Rbf(Q), device="cpu")
    dyn = GPLVM(y, Q, num_inducing_points=M, device="cpu", **_config("dynamical", False))
    with pytest.raises(NotImplementedError, match="iid"):
        dyn.project(y[:2])
    iid = _models("iid")[1]
    with pytest.raises(ValueError, match="observed_dims"):
        iid.project(y[:2, :3])
    with pytest.raises(ValueError, match="match observed_dims"):
        iid.project(y[:2, :3], np.array([0, 1]))
