"""The port's sparse models (VFE, FITC, SVGP in both parameterizations)
against the JAX package, float64 on the CPU, with the JAX model's weights
carried across by convert.load_trainable.

Tolerances: losses rel 1e-10, gradients 1e-8 of the largest entry,
moments and posteriors rel 1e-9 -- the two packages' Cholesky factors
and triangular solves round differently, and cond(Kuu) (up to ~1e4 at
these sizes) carries that roundoff into the results.  The reference
anchors (tests/test_models/test_sparse_gpr.py) are held at rel 1e-9.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import ekernels as jax_ekernels
from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu import mean_functions as jax_means
from gptorch_tpu.bijectors import LowerCholesky as JaxLowerCholesky
from gptorch_tpu.models import FITC as JaxFITC
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.models import SVGP as JaxSVGP
from gptorch_tpu.models import VFE as JaxVFE
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu.models.sparse_gpr import init_inducing_points as jax_init_inducing_points
from gptorch_tpu.models.sparse_gpr import latent_marginals as jax_latent_marginals
from gptorch_tpu.util import kmeans_centers as jax_kmeans_centers
from gptorch_tpu_torch import bijectors, convert, ekernels, kernels, likelihoods, mean_functions, settings
from gptorch_tpu_torch.models import FITC, GPR, SVGP, VFE
from gptorch_tpu_torch.models import posterior as posterior_module
from gptorch_tpu_torch.models import sparse_gpr
from gptorch_tpu_torch.models.sparse_gpr import init_inducing_points
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.training import fit
from gptorch_tpu_torch.util import kmeans_centers

DATA_DIR = os.path.join(os.path.dirname(__file__), "data", "models", "sparse_gpr")
VFE_LOSS_LIVE = 8.842239516197395
SVGP_LOSS_ANCHOR = 9.534628739243518
LOSS_RTOL, GRAD_RTOL, RTOL = 1e-10, 1e-8, 1e-9
N, D, M = 48, 2, 12


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _matrix(name):
    a = np.loadtxt(os.path.join(DATA_DIR, name + ".dat"))
    return a[:, None] if a.ndim == 1 else a


def _data(n=N, d=D, dy=1, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    y = np.sin(x[:, :dy]) + 0.1 * rng.randn(n, dy) + 0.3
    return x, y, x[rng.permutation(n)[:M]] + 0.05 * rng.randn(M, d)


CLASSES = {"vfe": (JaxVFE, VFE, {}), "fitc": (JaxFITC, FITC, {}),
           "svgp": (JaxSVGP, SVGP, {}), "svgp_white": (JaxSVGP, SVGP, {"whiten": True})}
MEANS = {
    "zero": (lambda m, dy: None),
    "linear": (lambda m, dy: m.LinearMean(D, dy, W=0.2 * np.ones((dy, D)), b=0.1 * np.ones(dy))),
}
# (class, mean function, output columns) of every parity case; FITC shares
# VFE's low-rank algebra (_low_rank_solve), so one case of it suffices
CASES = [(cls, mean, dy) for cls in CLASSES for mean, dy in (("zero", 1), ("linear", 2))
         if (cls, mean) != ("fitc", "zero")]
XS = np.random.RandomState(4).randn(9, D)
BATCH = np.random.RandomState(3).permutation(N)[:16]


def _jax_model(cls, mean, dy):
    jax_cls, _, kw = CLASSES[cls]
    x, y, z = _data(dy=dy)
    return jax_cls(x, y, jax_kernels.Rbf(D, ARD=True, variance=1.2), inducing_points=z,
                   likelihood=jax_likelihoods.Gaussian(0.1), mean_function=MEANS[mean](jax_means, dy), **kw)


def _port_model(cls, mean, dy, values=None, **extra):
    _, port_cls, kw = CLASSES[cls]
    x, y, z = _data(dy=dy)
    m = port_cls(x, y, kernels.Rbf(D, ARD=True, variance=1.2), inducing_points=z,
                 likelihood=likelihoods.Gaussian(0.1), mean_function=MEANS[mean](mean_functions, dy),
                 device="cpu", **kw, **extra)
    if values is not None:
        convert.load_trainable(m, values)
    return m


@functools.lru_cache(maxsize=None)
def _reference(cls, mean, dy):
    """The JAX package's results for one case, in one compiled call: the
    initial trainables, and at perturbed trainables the loss and its
    gradient (full data and an explicit batch), the moments, the
    uncertain-input statistics, the bounds, and the posterior's and its
    serving twin's moments.  Returns (initial values, perturbed values,
    results), numpy throughout."""
    jm = _jax_model(cls, mean, dy)
    initial = {k: np.asarray(v) for k, v in jax_get_trainable(jm).items()}
    rng = np.random.RandomState(7)
    values = {k: v + 0.05 * rng.randn(*v.shape) for k, v in initial.items()}
    x, y, _ = _data(dy=dy)
    ys = np.random.RandomState(5).randn(XS.shape[0], dy)

    def compute(v, xs, ys, xb, yb):
        m = jax_with_trainable(jm, v)
        out = {}
        out["loss"], out["grads"] = jax.value_and_grad(lambda v: jax_with_trainable(jm, v)._loss())(v)
        batch_loss = lambda v: jax_with_trainable(jm, v)._loss(x=xb, y=yb)  # noqa: E731
        if cls.startswith("svgp"):  # the ELBO's scaling to the full data
            out["batch_loss"], out["batch_grads"] = jax.value_and_grad(batch_loss)(v)
        else:
            out["batch_loss"] = batch_loss(v)
        for diag in (True, False):
            out[f"f{diag}"] = m._predict(xs, diag=diag)
        out["y"] = m.predict_y(xs)
        out["lpd"] = m.predict_log_density(xs, ys)
        out["wG"] = m._uncertain_wG()
        if cls == "vfe":
            out["upper"] = m.upper_bound()
        post = m.posterior()
        serving = post.for_serving(nb=4)
        for diag in (True, False):
            out[f"post{diag}"] = post.predict_f(xs, diag=diag)
            out[f"serving{diag}"] = serving.predict_f(xs, diag=diag)
        return out

    args = ({k: jnp.asarray(v) for k, v in values.items()}, XS, ys, x[BATCH], y[BATCH])
    # XLA's backend optimizations cost more time than this small program saves
    out = jax.jit(compute).lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})(*args)
    return initial, values, jax.tree_util.tree_map(np.asarray, out), ys


def _pair(cls, mean="zero", dy=1):
    """The JAX results of a case and the port's model at its perturbed
    trainables."""
    _, values, ref, ys = _reference(cls, mean, dy)
    return ref, ys, _port_model(cls, mean, dy, values)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def _close_grads(m, want_grads):
    raws = get_trainable(m)
    assert sorted(raws) == sorted(want_grads)
    scale = max(float(np.abs(g).max()) for g in want_grads.values())
    for path, raw in raws.items():
        np.testing.assert_allclose(raw.grad.numpy(), want_grads[path], rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=path)


# -- the reference's anchors ---------------------------------------------------


def _anchor_kernel():
    k = kernels.Matern32(1)
    k.length_scales.set_raw(torch.zeros(1))
    k.variance.set_raw(torch.zeros(1))
    return k


def test_vfe_anchor_and_goldens():
    model = VFE(_matrix("x"), _matrix("y"), _anchor_kernel(), inducing_points=_matrix("z"),
                likelihood=likelihoods.Gaussian(1.0), mean_function=mean_functions.Zero(1), device="cpu")
    assert float(model.loss()) == pytest.approx(VFE_LOSS_LIVE, rel=1e-9)
    x_test = _matrix("x_test")
    mu, s = model.predict_f(x_test, diag=False)
    _close(mu, _matrix("vfe_y_mean"), 1e-6)
    _close(s, _matrix("vfe_y_cov"), 1e-6)


def test_svgp_anchor_and_goldens():
    model = SVGP(_matrix("x"), _matrix("y"), _anchor_kernel(), inducing_points=_matrix("z"),
                 likelihood=likelihoods.Gaussian(1.0), mean_function=mean_functions.Zero(1), device="cpu")
    model.induced_output_mean.set_raw(torch.as_tensor(_matrix("q_mu")))
    model.induced_output_chol_cov.set_raw(bijectors.LowerCholesky().inverse(torch.as_tensor(_matrix("l_s"))))
    assert float(model.loss()) == pytest.approx(SVGP_LOSS_ANCHOR, rel=1e-9)
    mu, s = model.predict_f(_matrix("x_test"), diag=False)
    _close(mu, _matrix("svgp_y_mean"), 1e-6)
    _close(s, _matrix("svgp_y_cov"), 1e-6)


# -- loss and gradient -----------------------------------------------------------


@pytest.mark.parametrize("cls, mean, dy", CASES)
def test_loss_and_gradient_match_jax(cls, mean, dy):
    ref, _, m = _pair(cls, mean, dy)
    loss = m.loss()
    loss.backward()
    assert float(loss) == pytest.approx(float(ref["loss"]), rel=LOSS_RTOL)
    _close_grads(m, ref["grads"])


@pytest.mark.parametrize("cls, mean, dy", CASES)
def test_loss_on_an_explicit_batch_matches_jax(cls, mean, dy):
    """A batch passed as (x, y): the minibatched ELBO scaled to the full
    data and its gradient (SVGP), the bound on that batch (VFE, FITC)."""
    ref, _, m = _pair(cls, mean, dy)
    loss = m.loss(x=m.X[BATCH], y=m.Y[BATCH])
    assert float(loss) == pytest.approx(float(ref["batch_loss"]), rel=LOSS_RTOL)
    if "batch_grads" in ref:
        loss.backward()
        _close_grads(m, ref["batch_grads"])


def test_loss_from_a_generator_equals_the_loss_on_its_batch():
    m = _port_model("svgp", "zero", 1, batch_size=16)
    g = torch.Generator().manual_seed(11)
    xb, yb = sparse_gpr.draw_minibatch(torch.Generator().manual_seed(11), m.X, m.Y, 16)
    assert float(m.loss(generator=g)) == float(m.loss(x=xb, y=yb))
    # the generator's state advanced: the next draw is another batch
    assert float(m.loss(generator=g)) != float(m.loss(x=xb, y=yb))


def test_draw_minibatch_properties():
    x = torch.arange(40.0)[:, None]
    y = 2.0 * x
    xb, yb = sparse_gpr.draw_minibatch(torch.Generator().manual_seed(5), x, y, 17)
    assert xb.shape == (17, 1) and torch.equal(yb, 2.0 * xb)
    assert len(set(xb[:, 0].tolist())) == 17  # without replacement
    again, _ = sparse_gpr.draw_minibatch(torch.Generator().manual_seed(5), x, y, 17)
    assert torch.equal(xb, again)
    full, _ = sparse_gpr.draw_minibatch(torch.Generator().manual_seed(6), x, y, 40)
    assert sorted(full[:, 0].tolist()) == x[:, 0].tolist()


def test_minibatched_loss_without_generator_draws_from_settings():
    m = _port_model("svgp", "zero", 1, batch_size=8)
    with settings.override(default_seed=21):
        a = float(m.loss())
        assert settings.config.default_seed == 22
    xb, yb = sparse_gpr.draw_minibatch(torch.Generator().manual_seed(21), m.X, m.Y, 8)
    assert a == float(m.loss(x=xb, y=yb))


# -- predictions, bounds, posteriors -------------------------------------------


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("cls, mean, dy", CASES)
def test_predict_matches_jax(cls, mean, dy, diag):
    ref, ys, m = _pair(cls, mean, dy)
    for got, want in zip(m.predict_f(XS, diag=diag), ref[f"f{diag}"]):
        _close(got, want)
    if diag:
        for got, want in zip(m.predict_y(XS), ref["y"]):
            _close(got, want)
        _close(m.predict_log_density(XS, ys), ref["lpd"])


@pytest.mark.parametrize("mean, dy", [("zero", 1), ("linear", 2)])
def test_upper_bound_matches_jax_and_brackets_the_bound(mean, dy):
    ref, _, m = _pair("vfe", mean, dy)
    upper = m.upper_bound()
    assert float(upper) == pytest.approx(float(ref["upper"]), rel=LOSS_RTOL)
    assert float(upper) >= float(m.log_likelihood())


@pytest.mark.parametrize("cls, mean, dy", CASES)
def test_uncertain_wG_matches_jax(cls, mean, dy):
    ref, _, m = _pair(cls, mean, dy)
    for got, want in zip(m._uncertain_wG(), ref["wG"]):
        _close(got, want)


@pytest.mark.parametrize("diag", [True, False])
def test_latent_marginals_match_jax(diag):
    """The single-latent SVGP helper of the multi-latent models."""
    rng = np.random.RandomState(12)
    x, z = rng.randn(N, D), rng.randn(M, D)
    q_mu, q_chol = rng.randn(M, 1), np.tril(0.2 * rng.randn(M, M)) + np.eye(M)
    want = jax.jit(lambda *a: jax_latent_marginals(jax_kernels.Rbf(D, variance=1.3), *a, 1e-6, diag=diag))(
        z, q_mu, q_chol, x)
    got = sparse_gpr.latent_marginals(kernels.Rbf(D, variance=1.3), *(torch.as_tensor(a) for a in (z, q_mu, q_chol, x)),
                                      1e-6, diag=diag)
    for g, w in zip(got, want):
        _close(g, w)


def test_predict_uncertain_is_not_ported():
    """Named when the method raised; it now holds ``predict_uncertain`` of
    VFE, FITC, SVGP (plain and whitened) and GPR, built with the ψ-statistics
    Rbf, to the JAX package's (diagonal and full input covariances, rel
    1e-9) and to ``predict_f`` at zero input variance (abs 1e-10)."""
    x, y, z = _data(dy=2)
    rng = np.random.RandomState(9)
    xq, s, a = rng.randn(5, D), 0.2 * np.exp(rng.randn(5, D)), 0.3 * rng.randn(5, D, D)
    covs = (s, a @ a.transpose(0, 2, 1) + 0.05 * np.eye(D))
    for jax_cls, port_cls, kw in [(JaxVFE, VFE, {}), (JaxFITC, FITC, {}), (JaxSVGP, SVGP, {}),
                                  (JaxSVGP, SVGP, {"whiten": True}), (JaxGPR, GPR, None)]:
        sparse = {} if kw is None else dict(inducing_points=z, **kw)
        jm = jax_cls(x, y, jax_ekernels.Rbf(D, ARD=True, variance=1.2), likelihood=jax_likelihoods.Gaussian(0.1),
                     **sparse)
        tm = port_cls(x, y, ekernels.Rbf(D, ARD=True, variance=1.2), likelihood=likelihoods.Gaussian(0.1),
                      device="cpu", **sparse)
        values = {k: np.asarray(v) + 0.05 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jm).items()}
        convert.load_trainable(tm, values)
        # one compiled call for both covariances (eager JAX dispatches op by op)
        want = jax.jit(lambda v, xq, *covs: [jax_with_trainable(jm, v).predict_uncertain(xq, c) for c in covs])(
            {k: jnp.asarray(v) for k, v in values.items()}, xq, *covs)
        for cov, w in zip(covs, want):
            for got, wt in zip(tm.predict_uncertain(xq, cov), w):
                _close(got, wt)
        mu_f, var_f = tm.predict_f(xq)
        mu_u, var_u = tm.predict_uncertain(xq, np.zeros_like(xq))
        np.testing.assert_allclose(mu_u, mu_f, rtol=0, atol=1e-10, err_msg=port_cls.__name__)
        np.testing.assert_allclose(var_u, var_f, rtol=0, atol=1e-10, err_msg=port_cls.__name__)


@pytest.mark.parametrize("diag", [True, False])
@pytest.mark.parametrize("cls, mean, dy", CASES)
def test_posterior_and_serving_twin_match_jax(cls, mean, dy, diag):
    ref, _, m = _pair(cls, mean, dy)
    post = m.posterior()
    want_type = posterior_module.SVGPPosterior if cls.startswith("svgp") else posterior_module.LowRankPosterior
    assert type(post) is want_type
    for got, want in zip(post.predict_f(XS, diag=diag), ref[f"post{diag}"]):
        _close(got, want)
    serving = post.for_serving(nb=4)
    for got, want in zip(serving.predict_f(XS, diag=diag), ref[f"serving{diag}"]):
        _close(got, want)
    # the posterior, its serving twin and the model agree with one another
    for got, want in zip(serving.predict_f(XS, diag=diag), m.predict_f(XS, diag=diag)):
        _close(got, want)
    if diag:
        for got, want in zip(post.predict_y_batched(XS, batch_size=4), m.predict_y(XS)):
            _close(got, want)


# -- initialization ------------------------------------------------------------


def test_kmeans_centers_equal_jax():
    x = np.random.RandomState(8).randn(64, 3)
    np.testing.assert_array_equal(kmeans_centers(x, 7), jax_kmeans_centers(x, 7))


@pytest.mark.parametrize("num", [None, 6])
def test_init_inducing_points_match_jax(num):
    x, y, _ = _data()
    z = init_inducing_points(x, num)
    np.testing.assert_array_equal(z, jax_init_inducing_points(x, num))
    m = VFE(x, y, kernels.Rbf(D), num_inducing_points=num, device="cpu")
    assert m.num_inducing == (num or N // 10)
    np.testing.assert_array_equal(m.Z.value.detach().numpy(), z)


@pytest.mark.parametrize("cls, mean, dy", [c for c in CASES if c[0].startswith("svgp")])
def test_init_posterior_matches_jax(cls, mean, dy):
    """q(u) from the exact GPR on a subsample, at Z, in both
    parameterizations."""
    initial, _, _, _ = _reference(cls, mean, dy)
    m = _port_model(cls, mean, dy)
    for path in ("induced_output_mean", "induced_output_chol_cov"):
        _close(get_trainable(m)[path], initial[path])
    assert isinstance(m.induced_output_chol_cov.bijector, bijectors.LowerCholesky)


def test_lower_cholesky_matches_jax():
    x = np.random.RandomState(10).randn(5, 5)
    got = bijectors.LowerCholesky().forward(torch.as_tensor(x))
    _close(got, JaxLowerCholesky().forward(jnp.asarray(x)), 1e-15)
    _close(bijectors.LowerCholesky().inverse(got), np.tril(x), 1e-15)
    assert float(bijectors.LowerCholesky().forward_log_det_jacobian(torch.as_tensor(x))) == pytest.approx(
        float(np.trace(x)))


def test_sparse_models_refuse_fixed_noise_and_need_a_device():
    x, y, z = _data()
    with pytest.raises(ValueError, match="exact GPR only"):
        SVGP(x, y, kernels.Rbf(D), inducing_points=z, likelihood=likelihoods.FixedNoiseGaussian(np.ones(N)),
             device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            VFE(x, y, kernels.Rbf(D), inducing_points=z)


def test_init_posterior_runs_a_port_gpr(monkeypatch):
    """SVGP's q(u) init goes through the port's GPR.predict_f on the model's
    device (no CPU copy of the data)."""
    calls = []
    original = GPR.predict_f

    def spy(self, x_new, diag=True):
        calls.append((x_new.device.type, diag, tuple(self.X.shape)))
        return original(self, x_new, diag=diag)

    monkeypatch.setattr(GPR, "predict_f", spy)
    _port_model("svgp", "zero", 1)
    assert calls == [("cpu", False, (N, D))]


# -- training ------------------------------------------------------------------


def test_fit_scan_minibatches_come_from_the_generator():
    """Each step draws its batch from the generator: two runs from the same
    seed agree exactly, and fit_torch takes the same batches as fit_scan."""
    runs = []
    for fit_loop in ("scan", "scan", "torch"):
        m = _port_model("svgp", "zero", 1, batch_size=16)
        g = torch.Generator().manual_seed(3)
        if fit_loop == "scan":
            runs.append(m.fit_scan("Adam", max_iter=4, generator=g).numpy())
        else:
            runs.append(m.optimize("Adam", max_iter=4, verbose=False, generator=g)[0])
        assert not torch.equal(g.get_state(), torch.Generator().manual_seed(3).get_state())
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[0], runs[2])
    assert len(set(runs[0].tolist())) == 4


def test_fit_scipy_sees_one_fixed_batch(monkeypatch):
    """fit_scipy's objective is deterministic: every evaluation draws the
    batch of a generator seeded 0."""
    m = _port_model("svgp", "zero", 1, batch_size=16)
    xb, yb = sparse_gpr.draw_minibatch(torch.Generator().manual_seed(0), m.X, m.Y, 16)
    first = float(m.loss(x=xb, y=yb))
    seen = []
    original = m._loss

    def spy(**kw):
        out = original(**kw)
        seen.append((kw["generator"].initial_seed(), float(out)))
        return out

    monkeypatch.setattr(m, "_loss", spy)
    fit.fit_scipy(m, max_iter=2, disp=False)
    assert len(seen) > 1 and {seed for seed, _ in seen} == {0}
    assert seen[0][1] == first
