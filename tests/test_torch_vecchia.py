"""The port's Vecchia GP (gptorch_tpu_torch.ops.vecchia, models.VecchiaGPR)
against the JAX package, float64 on the CPU, data made from numpy seeds.

* The host-side orderings and neighbour searches are copies of the JAX
  package's numpy code: their outputs are equal, index for index.
* The Vecchia log-likelihood and its gradient agree within 1e-10 relative
  (the gradient within 1e-10 of its largest entry), for Rbf and Matern32,
  in chunks and in one chunk, and predictions within 1e-10.
* With full history (m = n − 1) the likelihood is the dense GPR's by the
  chain rule: the port's VecchiaGPR against the port's GPR, 1e-10.

One deliberate difference from the JAX package: the neighbour indices are
an int64 buffer, where the JAX model keeps them as floats (an integer leaf
would stop ``jax.grad`` over the model); the values are the same.
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
from gptorch_tpu.models import VecchiaGPR as JaxVecchiaGPR
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu.ops import vecchia as jax_vops
from gptorch_tpu_torch import convert, kernels, likelihoods, mean_functions
from gptorch_tpu_torch.models import GPR, VecchiaGPR
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.ops import vecchia as vops
from gptorch_tpu_torch.training import fit

N, D, RTOL = 200, 2, 1e-10


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data(n=N, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, D)
    return x, np.sin(6.0 * x[:, :1]) + 0.5 * x[:, 1:] + 0.1 * rng.randn(n, 1)


def _kernel(lib, kind):
    return getattr(lib, kind)(D, ARD=True, length_scales=np.array([0.3, 0.5]), variance=1.3)


def _models(kind, m, chunk, mean="zero", n=N, ordering="auto"):
    x, y = _data(n)
    kw = dict(num_neighbors=m, chunk=chunk, ordering=ordering)
    jm = JaxVecchiaGPR(x, y, _kernel(jax_kernels, kind), likelihood=jax_likelihoods.Gaussian(0.05),
                       mean_function=None if mean == "zero" else jax_means.Constant(1, np.array([0.2])), **kw)
    tm = VecchiaGPR(x, y, _kernel(kernels, kind), likelihood=likelihoods.Gaussian(0.05),
                    mean_function=None if mean == "zero" else mean_functions.Constant(1, np.array([0.2])),
                    device="cpu", **kw)
    return jm, tm


@functools.lru_cache(maxsize=None)
def _reference(kind, m, chunk, mean):
    """The JAX model's loss and gradient at perturbed trainables and its
    predictions there, in one compiled call."""
    jm, _ = _models(kind, m, chunk, mean)
    rng = np.random.RandomState(3)
    values = {k: np.asarray(v) + 0.05 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jm).items()}
    xq = rng.rand(7, D)

    def compute(v):
        loss, grads = jax.value_and_grad(lambda v: jax_with_trainable(jm, v)._loss())(v)
        return loss, grads

    loss, grads = jax.jit(compute)({k: jnp.asarray(v) for k, v in values.items()})
    pred = jax_with_trainable(jm, {k: jnp.asarray(v) for k, v in values.items()}).predict_y(xq)
    return values, float(loss), {k: np.asarray(g) for k, g in grads.items()}, tuple(map(np.asarray, pred)), xq


def _port(kind, m, chunk, mean, values):
    _, tm = _models(kind, m, chunk, mean)
    convert.load_trainable(tm, values)
    return tm


CASES = [("Rbf", 8, 64, "zero"), ("Rbf", 8, 4096, "zero"), ("Matern32", 8, 64, "zero"),
         ("Matern32", 16, 4096, "constant"), ("Rbf", N - 1, 4096, "zero"), ("Rbf", 12, 77, "constant")]


@pytest.mark.parametrize("kind, m, chunk, mean", CASES)
def test_nlml_and_gradient_match_jax(kind, m, chunk, mean):
    values, want, want_grads, _, _ = _reference(kind, m, chunk, mean)
    tm = _port(kind, m, chunk, mean, values)
    loss = tm._loss()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(want, rel=RTOL)
    scale = max(np.abs(g).max() for g in want_grads.values())
    raws = get_trainable(tm)
    assert sorted(raws) == sorted(want_grads)
    for path, raw in raws.items():
        np.testing.assert_allclose(raw.grad.numpy(), want_grads[path], rtol=0, atol=RTOL * scale, err_msg=path)


@pytest.mark.parametrize("kind, m, chunk, mean", CASES[:4])
def test_predictions_match_jax(kind, m, chunk, mean):
    values, _, _, want, xq = _reference(kind, m, chunk, mean)
    tm = _port(kind, m, chunk, mean, values)
    for got, w in zip(tm.predict_y(xq), want):
        np.testing.assert_allclose(got, w, rtol=RTOL, atol=RTOL * np.abs(w).max())
    with pytest.raises(NotImplementedError, match="diag=True"):
        tm.predict_f(xq, diag=False)


@pytest.mark.parametrize("ordering", ["maxmin", "coord"])
def test_model_order_and_neighbours_match_jax(ordering):
    jm, tm = _models("Rbf", 8, 4096, ordering=ordering)
    assert tm.ordering == ordering
    np.testing.assert_array_equal(tm.X.numpy(), np.asarray(jm.X))
    np.testing.assert_array_equal(tm.Y.numpy(), np.asarray(jm.Y))
    assert tm.nn_idx.dtype == torch.int64 and np.asarray(jm.nn_idx).dtype == np.float64
    np.testing.assert_array_equal(tm.nn_idx.numpy(), np.asarray(jm.nn_idx).astype(np.int64))
    np.testing.assert_array_equal(tm.nn_mask.numpy(), np.asarray(jm.nn_mask))


def test_host_orderings_and_neighbours_match_jax():
    x = np.random.RandomState(4).randn(150, 3)
    np.testing.assert_array_equal(vops.maxmin_ordering(x), jax_vops.maxmin_ordering(x))
    np.testing.assert_array_equal(vops.coordinate_ordering(x), jax_vops.coordinate_ordering(x))
    for m, oversample in ((5, 4), (40, 1)):  # oversample 1 leaves rows short: the exact top-up
        got, want = vops.previous_neighbors(x, m, oversample), jax_vops.previous_neighbors(x, m, oversample)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    xq = np.random.RandomState(5).randn(9, 3)
    for m, n_train in ((4, 150), (1, 150), (6, 3)):  # k = 1 squeezes; n_train < m pads
        got = vops.test_point_neighbors(x[:n_train], xq, m)
        assert got.shape == (9, m) and got.dtype == np.int64
        np.testing.assert_array_equal(got, jax_vops.test_point_neighbors(x[:n_train], xq, m))


def test_batched_gram_is_the_kernels_gram():
    """batched_gram (``torch.func.vmap`` of kernel.K) against kernel.K on
    each batch member, for Rbf, the four other radial kinds, Linear and a
    sum."""
    rng = np.random.RandomState(6)
    a, b = torch.as_tensor(rng.randn(3, 5, D)), torch.as_tensor(rng.randn(3, 2, D))
    cases = [_kernel(kernels, "Rbf"), _kernel(kernels, "Matern12"), _kernel(kernels, "Matern32"),
             _kernel(kernels, "Matern52"), kernels.RationalQuadratic(D, alpha=0.7),
             _kernel(kernels, "Rbf") + kernels.Linear(D), kernels.Linear(D, variance=np.array([0.4, 1.1]))]
    for kernel in cases:
        for other in (None, b):
            got = vops.batched_gram(kernel, a, other)
            want = torch.stack([kernel.K(a[i], None if other is None else other[i]) for i in range(3)])
            np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-13, atol=1e-13,
                                       err_msg=type(kernel).__name__)


@pytest.mark.parametrize("ordering", ["maxmin", "coord"])
def test_full_history_equals_dense_gpr(ordering):
    """The chain rule: with every previous point as a neighbour, the Vecchia
    NLML and gradient are the dense GPR's (both the port's)."""
    x, y = _data(130)
    dense = GPR(x, y, _kernel(kernels, "Rbf"), likelihood=likelihoods.Gaussian(0.05), fast=False, device="cpu")
    v = VecchiaGPR(x, y, _kernel(kernels, "Rbf"), likelihood=likelihoods.Gaussian(0.05), num_neighbors=129,
                   ordering=ordering, chunk=50, device="cpu")
    ld, lv = dense._loss(), v._loss()
    assert float(lv.detach()) == pytest.approx(float(ld.detach()), rel=RTOL)
    ld.backward()
    lv.backward()
    for path, raw in get_trainable(v).items():
        want = get_trainable(dense)[path].grad.numpy()
        np.testing.assert_allclose(raw.grad.numpy(), want, rtol=1e-8, atol=1e-10 * np.abs(want).max(), err_msg=path)


def test_fit_scan_trains_and_errors():
    _, tm = _models("Rbf", 8, 64)
    losses = tm.fit_scan("Adam", max_iter=4)
    assert not tm._reads_jitter_policy() and fit.captures(tm, "Adam") is False  # the CPU runs eagerly
    assert torch.all(torch.isfinite(losses)) and float(losses[-1]) < float(losses[0])
    with pytest.raises(ValueError, match="constructor data"):
        tm.log_likelihood(x=tm.X)
    x, y = _data(20)
    with pytest.raises(ValueError, match="ordering"):
        VecchiaGPR(x, y, kernels.Rbf(D), ordering="random", device="cpu")
    with pytest.raises(ValueError, match="Gaussian likelihood"):
        VecchiaGPR(x, y, kernels.Rbf(D), likelihood=likelihoods.Bernoulli(), device="cpu")
    assert VecchiaGPR(x[:3], y[:3], kernels.Rbf(D), num_neighbors=32, device="cpu").num_neighbors == 2
