"""The port's Kronecker grid GP (gptorch_tpu_torch.models.GridGPR,
GridGPRPosterior) against the JAX package, float64 on the CPU, data made
from numpy seeds.

* Loss at perturbed trainables: 1e-10 relative; predict_f, diagonal and
  full, and the cached posterior's: 1e-10 of each output's largest entry.
* The gradient: 1e-8 of its largest entry against the JAX package's.  It
  passes through ``eigh``'s backward, which divides by eigenvalue gaps: the
  Rbf axis's Gram has eigenvalues down to 1e-11, and the two packages'
  LAPACK calls round apart by up to 2.4e-9 of an entry (the JAX package's
  kern0.variance gradient is the one off: the three variance gradients are
  equal in exact arithmetic, and the port's agree to 1e-13).  The port's
  gradient is also held to the dense GPR's at 1e-10.
* The shared first kernel: the JAX model lists it under ``kernel.*`` and
  ``kern0.*`` as two leaves, and so does the port.  A JAX model trained by
  Adam (where the two have parted) loads into the port and gives the JAX
  loss (1e-10) and predictions (1e-10); three L-BFGS-B iterations give the
  JAX iterates to 1e-8.
* Against the port's dense GPR with the product kernel on the full grid:
  NLML 1e-10 relative, its gradient 1e-10 of the largest entry,
  predictions 1e-8 absolute.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu.models.kronecker import GridGPR as JaxGridGPR
from gptorch_tpu.models.kronecker import grid_points as jax_grid_points
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu.training.fit import fit_optax
from gptorch_tpu_torch import convert, kernels, likelihoods
from gptorch_tpu_torch.models import GPR, GridGPR, GridGPRPosterior
from gptorch_tpu_torch.models.kronecker import grid_points
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.training import fit

RTOL, GRAD_RTOL = 1e-10, 1e-8
SIZES = (6, 5, 4)


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _grid(seed=0, dy=2):
    rng = np.random.RandomState(seed)
    axes = [np.sort(rng.rand(n) * (1.0 + d)) for d, n in enumerate(SIZES)]
    return axes, rng.randn(int(np.prod(SIZES)), dy)


def _kernels(lib):
    return [lib.Rbf(1, variance=1.3, length_scales=0.4), lib.Matern32(1, length_scales=0.7),
            lib.Matern52(1, variance=0.8, length_scales=1.1)]


def _models():
    axes, y = _grid()
    jm = JaxGridGPR(axes, y, _kernels(jax_kernels), likelihood=jax_likelihoods.Gaussian(0.05))
    tm = GridGPR(axes, y, _kernels(kernels), likelihood=likelihoods.Gaussian(0.05), device="cpu")
    return jm, tm


def _queries():
    return np.random.RandomState(1).rand(7, 3) * np.array([1.0, 2.0, 3.0])


@functools.lru_cache(maxsize=None)
def _reference():
    """The JAX model's loss and gradient at perturbed trainables, and its
    predictions (diagonal, full, and through the cached posterior) there."""
    jm, _ = _models()
    rng = np.random.RandomState(3)
    values = {k: np.asarray(v) + 0.05 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jm).items()}
    xq = jnp.asarray(_queries())

    def compute(v):
        loss, grads = jax.value_and_grad(lambda v: jax_with_trainable(jm, v)._loss())(v)
        m = jax_with_trainable(jm, v)
        return loss, grads, m.predict_f(xq), m.predict_f(xq, diag=False), m.posterior().predict_f(xq)

    out = jax.jit(compute)({k: jnp.asarray(v) for k, v in values.items()})
    return values, jax.tree_util.tree_map(np.asarray, out)


def _port_at_reference():
    values, _ = _reference()
    _, tm = _models()
    return convert.load_trainable(tm, values)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def test_loss_and_gradient_match_jax():
    _, (loss_j, grads_j, *_) = _reference()
    tm = _port_at_reference()
    loss = tm._loss()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=RTOL)
    scale = max(np.abs(g).max() for g in grads_j.values())
    raws = get_trainable(tm)
    assert sorted(raws) == sorted(grads_j)
    for path, raw in raws.items():
        got = np.zeros_like(grads_j[path]) if raw.grad is None else raw.grad.numpy()
        np.testing.assert_allclose(got, grads_j[path], rtol=0, atol=GRAD_RTOL * scale, err_msg=path)
    # the loss reads only the kern{d}: the duplicate kernel.* paths have no gradient in either package
    assert all(not np.any(grads_j[p]) for p in grads_j if p.startswith("kernel."))


@pytest.mark.parametrize("diag", [True, False])
def test_predict_f_matches_jax(diag):
    _, (_, _, pred_diag, pred_full, _) = _reference()
    tm = _port_at_reference()
    for got, want in zip(tm.predict_f(_queries(), diag=diag), pred_diag if diag else pred_full):
        _close(got, want)


def test_posterior_matches_jax_and_stays_frozen():
    _, (_, _, _, _, pred_post) = _reference()
    tm = _port_at_reference()
    post = tm.posterior()
    assert isinstance(post, GridGPRPosterior)
    before = post.predict_f(_queries())
    for got, want in zip(before, pred_post):
        _close(got, want)
    tm.optimize("Adam", max_iter=3, learning_rate=0.1, verbose=False)
    for got, want in zip(post.predict_f(_queries()), before):
        np.testing.assert_array_equal(got, want)
    assert not np.allclose(tm.predict_f(_queries())[0], before[0])


def test_grid_points_and_validation_match_jax():
    axes, y = _grid()
    np.testing.assert_array_equal(grid_points(axes), jax_grid_points(axes))
    for lib, model, kw in ((jax_kernels, JaxGridGPR, {}), (kernels, GridGPR, {"device": "cpu"})):
        with pytest.raises(ValueError, match="one kernel per grid axis"):
            model(axes, y, _kernels(lib)[:2], **kw)
        with pytest.raises(ValueError, match="rows; grid has"):
            model(axes, y[:-1], _kernels(lib), **kw)
    _, tm = _models()
    with pytest.raises(ValueError, match="x override"):
        tm.log_likelihood(x=tm.X)
    half = tm.Y * 0.5
    jm, _ = _models()
    assert float(tm.log_likelihood(y=half).detach()) == pytest.approx(
        float(jm.log_likelihood(y=jnp.asarray(half.numpy()))), rel=RTOL)
    assert not tm._capturable() and not fit.captures(tm, "Adam")


def test_matches_dense_gpr():
    """The port's GridGPR against the port's dense GPR with the product of
    the axis kernels, each on its column of the full grid."""
    axes, y = _grid()
    tm = _port_at_reference()
    ks = [tm.kern0, tm.kern1, tm.kern2]
    product = kernels.ActiveDims(ks[0], [0], 3) * kernels.ActiveDims(ks[1], [1], 3) * kernels.ActiveDims(ks[2], [2], 3)
    dense = GPR(grid_points(axes), y, product, likelihood=tm.likelihood, fast=False, device="cpu")
    grid_loss, dense_loss = tm._loss(), dense._loss()
    assert float(grid_loss.detach()) == pytest.approx(float(dense_loss.detach()), rel=RTOL)
    raws = [p for path, p in get_trainable(tm).items() if not path.startswith("kernel.")]
    g_grid = torch.autograd.grad(grid_loss, raws)
    g_dense = torch.autograd.grad(dense_loss, raws)
    scale = max(float(g.abs().max()) for g in g_dense)
    for a, b in zip(g_grid, g_dense):
        torch.testing.assert_close(a, b, rtol=0, atol=RTOL * scale)
    xq = _queries()
    for diag in (True, False):
        for got, want in zip(tm.predict_f(xq, diag=diag), dense.predict_f(xq, diag=diag)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


def test_adam_trained_jax_model_loads_into_the_port():
    """Shared first kernel, case (a): after Adam the JAX model's kernel.* and
    kern0.* leaves differ (only kern0.* moved); the port keeps both, and
    its loss and predictions are the JAX model's."""
    jm, tm = _models()
    trained, _, _ = fit_optax(jm, "Adam", max_iter=4, learning_rate=0.1, verbose=False)
    values = {k: np.asarray(v) for k, v in jax_get_trainable(trained).items()}
    assert not np.allclose(values["kernel.length_scales"], values["kern0.length_scales"])
    convert.load_trainable(tm, values)
    for path, raw in get_trainable(tm).items():
        np.testing.assert_array_equal(raw.detach().numpy(), values[path], err_msg=path)
    assert float(tm.loss().detach()) == pytest.approx(float(trained.loss()), rel=RTOL)
    for got, want in zip(tm.predict_f(_queries()), trained.predict_f(_queries())):
        _close(got, want)


def test_lbfgsb_iterates_match_jax():
    """Shared first kernel, case (b): three L-BFGS-B iterations of each
    package from the same start reach the same trainables (1e-8), the
    duplicate kernel.* paths untouched."""
    jm, tm = _models()
    start = {k: np.asarray(v) for k, v in jax_get_trainable(jm).items()}
    result_j = jm.optimize("L-BFGS-B", max_iter=3, verbose=False)
    result_t = tm.optimize("L-BFGS-B", max_iter=3, verbose=False)
    assert result_t.nit == result_j.nit == 3
    want = {k: np.asarray(v) for k, v in jax_get_trainable(jm).items()}
    for path, raw in get_trainable(tm).items():
        np.testing.assert_allclose(raw.detach().numpy(), want[path], rtol=0, atol=1e-8, err_msg=path)
    for path in ("kernel.variance", "kernel.length_scales"):
        np.testing.assert_array_equal(want[path], start[path])
    assert float(result_t.fun) == pytest.approx(float(result_j.fun), rel=1e-10)
