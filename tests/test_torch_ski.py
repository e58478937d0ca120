"""The port's SKI / KISS-GP (gptorch_tpu_torch.ops.ski, models.SKIGPR,
SKIPosterior) against the JAX package, float64 on the CPU, data made from
numpy seeds.

Operations:

* the Toeplitz product against the dense Toeplitz matrix (1e-12 of the
  output's largest entry) and against the JAX function (1e-13); the
  Kronecker–Toeplitz product against ``np.kron`` (1e-12) and JAX (1e-13);
* the cubic stencil: the JAX package's indices exactly and its weights to
  1e-14, weights summing to 1 and quadratics interpolated exactly (1e-10);
  ``combine_dims`` and ``make_grid`` as the JAX package's;
* Wᵀ: the JAX scatter-add's sums (1e-14 of the largest entry; the port
  sums each node's entries in the data's order, as a sequential scatter
  does), the adjoint of W (1e-12), the same bits on every call, and the
  gradients of W and Wᵀ each other's product (autograd's gradcheck).

The model, with CG run to 1e-12 (so that both packages' solves converge
and agree; at the default 1e-6 they agree only to about 1e-6): loss 1e-10
relative, gradient 1e-9 of its largest entry, predict_f (diagonal and
full), the cached posterior's moments and ``predict_mean`` 1e-9 of each
output's largest entry, in 1-D and as a 3-D product kernel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu.models.ski import SKIGPR as JaxSKIGPR
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu.ops import ski as jax_ski
from gptorch_tpu_torch import convert, kernels, likelihoods
from gptorch_tpu_torch.models import SKIGPR, SKIPosterior
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.ops import ski
from gptorch_tpu_torch.training import fit

RTOL, MODEL_RTOL = 1e-10, 1e-9


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _toeplitz(r):
    g = r.shape[0]
    return np.array([[r[abs(i - j)] for j in range(g)] for i in range(g)])


# -- operations --------------------------------------------------------------------


@pytest.mark.parametrize("cols", [None, 3])
def test_toeplitz_matvec_matches_dense_and_jax(cols):
    rng = np.random.RandomState(0)
    r = np.exp(-0.5 * np.arange(17) ** 2 / 9.0)
    v = rng.randn(17) if cols is None else rng.randn(17, cols)
    got = ski.toeplitz_matvec(torch.as_tensor(r), torch.as_tensor(v))
    _close(got, _toeplitz(r) @ v, 1e-12)
    _close(got, jax_ski.toeplitz_matvec(jnp.asarray(r), jnp.asarray(v)), 1e-13)


def test_kron_toeplitz_matches_dense_kron_and_jax():
    rng = np.random.RandomState(1)
    r1, r2, r3 = np.exp(-np.arange(11) / 4.0), 1.0 / (1.0 + np.arange(7)), np.exp(-0.1 * np.arange(5) ** 2)
    v = rng.randn(11 * 7 * 5, 2)
    got = ski.kron_toeplitz_matvec([torch.as_tensor(r) for r in (r1, r2, r3)], torch.as_tensor(v), (11, 7, 5))
    _close(got, np.kron(np.kron(_toeplitz(r1), _toeplitz(r2)), _toeplitz(r3)) @ v, 1e-12)
    want = jax.jit(lambda rows, v: jax_ski.kron_toeplitz_matvec(rows, v, (11, 7, 5)))([r1, r2, r3], v)
    _close(got, want, 1e-13)


def _stencil(lib, x, g):
    asarray = jnp.asarray if lib is jax_ski else torch.as_tensor
    lows, hs = lib.make_grid(asarray(x), (g,))
    return lows, hs, lib.cubic_interp((asarray(x[:, 0]) - lows[0]) / hs[0], g)


def test_cubic_interp_matches_jax_and_is_exact_on_quadratics():
    x = np.sort(np.random.RandomState(2).uniform(-2, 2, 50))[:, None]
    lows, hs, (idx, w) = _stencil(ski, x, 64)
    lows_j, hs_j, (idx_j, w_j) = _stencil(jax_ski, x, 64)
    _close(lows, lows_j, 1e-15)
    _close(hs, hs_j, 1e-15)
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    _close(w, w_j, 1e-14)
    np.testing.assert_allclose(w.sum(1).numpy(), 1.0, atol=1e-12)
    nodes = lows[0] + torch.arange(64) * hs[0]
    for fn in (lambda z: z, lambda z: z ** 2, lambda z: 1.0 + z - 0.5 * z ** 2):
        np.testing.assert_allclose(ski.interp_matvec(idx, w, fn(nodes)).numpy(), fn(x[:, 0]), atol=1e-10)


@pytest.mark.parametrize("d", [2, 3])
def test_combine_dims_matches_jax(d):
    rng = np.random.RandomState(d)
    shape = (9, 12, 8)[:d]
    per_dim = [(rng.randint(0, g, (20, 4)), rng.rand(20, 4)) for g in shape]
    idx, w = ski.combine_dims([(torch.as_tensor(i), torch.as_tensor(v)) for i, v in per_dim], shape)
    idx_j, w_j = jax_ski.combine_dims([(jnp.asarray(i), jnp.asarray(v)) for i, v in per_dim], shape)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))


def _stencil_2d(n=40, shape=(10, 12), seed=3):
    x = np.random.RandomState(seed).uniform(-2, 2, (n, 2))
    xt = torch.as_tensor(x)
    lows, hs = ski.make_grid(xt, shape)
    per_dim = [ski.cubic_interp((xt[:, k] - lows[k]) / hs[k], g) for k, g in enumerate(shape)]
    return ski.combine_dims(per_dim, shape), int(np.prod(shape))


@pytest.mark.parametrize("cols", [None, 3])
def test_interp_rmatvec_matches_jax_and_is_the_adjoint(cols):
    (idx, w), G = _stencil_2d()
    rng = np.random.RandomState(4)
    u = rng.randn(40) if cols is None else rng.randn(40, cols)
    v = rng.randn(G) if cols is None else rng.randn(G, cols)
    got = ski.interp_rmatvec(idx, w, torch.as_tensor(u), G)
    _close(got, jax_ski.interp_rmatvec(jnp.asarray(idx.numpy()), jnp.asarray(w.numpy()), jnp.asarray(u), G), 1e-14)
    lhs = np.sum(u * ski.interp_matvec(idx, w, torch.as_tensor(v)).numpy())
    assert lhs == pytest.approx(float(np.sum(got.numpy() * v)), rel=1e-12)
    plan = ski.transpose_plan(idx, w, G)
    assert int(plan[2].sum()) == idx.numel() and plan[2].shape == (G,)
    again = ski.interp_rmatvec(idx, w, torch.as_tensor(u), G, plan=plan)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


def test_interp_gradients_are_each_others_products():
    (idx, w), G = _stencil_2d(n=12, shape=(8, 9))
    rng = np.random.RandomState(5)
    v = torch.tensor(rng.randn(G, 2), requires_grad=True)
    u = torch.tensor(rng.randn(12, 2), requires_grad=True)
    plan = ski.transpose_plan(idx, w, G)
    assert torch.autograd.gradcheck(lambda v: ski.interp_matvec(idx, w, v, plan=plan), (v,))
    assert torch.autograd.gradcheck(lambda u: ski.interp_rmatvec(idx, w, u, G, plan=plan), (u,))


# -- the model -----------------------------------------------------------------------

CASES = {
    "1d": dict(n=100, d=1, grid_shape=32),
    "3d": dict(n=80, d=3, grid_shape=10),
}
SETTINGS = dict(cg_tol=1e-12, max_cg_iters=128, num_probes=8)


def _data(n, d, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.0, 1.0, (n, d))
    return x, np.sin(2.0 * x[:, :1]) + 0.5 * x[:, -1:] ** 2 + 0.1 * rng.randn(n, 1)


def _factors(lib, d):
    if d == 1:
        return lib.Matern32(1, variance=1.2, length_scales=0.5)
    return [lib.Matern32(1, length_scales=0.5), lib.Rbf(1, length_scales=0.7), lib.Matern52(1, variance=0.9)][:d]


def _models(case):
    c = CASES[case]
    x, y = _data(c["n"], c["d"])
    kw = dict(grid_shape=c["grid_shape"], **SETTINGS)
    jm = JaxSKIGPR(x, y, _factors(jax_kernels, c["d"]), likelihood=jax_likelihoods.Gaussian(0.05), **kw)
    tm = SKIGPR(x, y, _factors(kernels, c["d"]), likelihood=likelihoods.Gaussian(0.05), device="cpu", **kw)
    return jm, tm


def _queries(d):
    return np.random.RandomState(7).uniform(-0.9, 0.9, (6, d))


@functools.lru_cache(maxsize=None)
def _reference(case):
    """In one compiled call: the JAX model's loss and gradient at perturbed
    trainables, predict_f (diagonal and full), and the cached posterior's
    predict_f and predict_mean there."""
    jm, _ = _models(case)
    rng = np.random.RandomState(3)
    values = {k: np.asarray(v) + 0.05 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jm).items()}
    xq = jnp.asarray(_queries(CASES[case]["d"]))

    def compute(v):
        loss, grads = jax.value_and_grad(lambda v: jax_with_trainable(jm, v)._loss())(v)
        m = jax_with_trainable(jm, v)
        post = m.posterior()
        return loss, grads, m.predict_f(xq), m.predict_f(xq, diag=False), post.predict_f(xq), post.predict_mean(xq)

    out = jax.jit(compute)({k: jnp.asarray(v) for k, v in values.items()})
    return values, jax.tree_util.tree_map(np.asarray, out)


def _port_at_reference(case):
    values, _ = _reference(case)
    _, tm = _models(case)
    return convert.load_trainable(tm, values)


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_gradient_match_jax(case):
    _, (loss_j, grads_j, *_) = _reference(case)
    tm = _port_at_reference(case)
    loss = tm._loss()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=RTOL)
    scale = max(np.abs(g).max() for g in grads_j.values())
    raws = get_trainable(tm)
    assert sorted(raws) == sorted(grads_j)
    for path, raw in raws.items():
        np.testing.assert_allclose(raw.grad.numpy(), grads_j[path], rtol=0, atol=MODEL_RTOL * scale, err_msg=path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_predictions_match_jax(case):
    _, (_, _, pred_diag, pred_full, post_f, post_mean) = _reference(case)
    tm = _port_at_reference(case)
    xq = _queries(CASES[case]["d"])
    for diag, want in ((True, pred_diag), (False, pred_full)):
        for got, w in zip(tm.predict_f(xq, diag=diag), want):
            _close(got, w, MODEL_RTOL)
    post = tm.posterior()
    assert isinstance(post, SKIPosterior)
    for got, w in zip(post.predict_f(xq), post_f):
        _close(got, w, MODEL_RTOL)
    _close(post.predict_mean(xq), post_mean, MODEL_RTOL)
    _close(post.predict_mean(xq), post.predict_f(xq)[0], 1e-12)


def test_posterior_stays_frozen_and_training_runs_eagerly():
    tm = _port_at_reference("1d")
    post = tm.posterior()
    xq = _queries(1)
    before = post.predict_mean(xq)
    losses = tm.fit_scan("Adam", max_iter=3, learning_rate=0.05)
    assert not fit.fit_scan.last_run["captured"] and not fit.captures(tm, "Adam")
    assert bool(torch.isfinite(losses).all())
    np.testing.assert_array_equal(post.predict_mean(xq), before)
    assert not np.allclose(tm.posterior().predict_mean(xq), before)


def test_constructor_and_call_errors_match_jax():
    x, y = _data(30, 2)
    cases = [
        (lambda lib: [lib.Linear(1), lib.Rbf(1)], {}, "stationary"),
        (lambda lib: [lib.Rbf(2)], {}, "one-dimensional"),
        (lambda lib: [lib.Rbf(1)], {}, "kernel factor"),
        (lambda lib: [lib.Rbf(1), lib.Rbf(1)], {"grid_shape": 6}, ">= 8 nodes"),
        (lambda lib: [lib.Rbf(1), lib.Rbf(1)], {"grid_shape": (10, 10, 10)}, "one entry per dimension"),
    ]
    for make, kw, match in cases:
        for lib, model, extra in ((jax_kernels, JaxSKIGPR, {}), (kernels, SKIGPR, {"device": "cpu"})):
            with pytest.raises(ValueError, match=match):
                model(x, y, make(lib), **kw, **extra)
    for liks, model, extra in ((jax_likelihoods, JaxSKIGPR, {}), (likelihoods, SKIGPR, {"device": "cpu"})):
        lib = jax_kernels if model is JaxSKIGPR else kernels
        with pytest.raises(ValueError, match="Gaussian likelihood"):
            model(x, y, [lib.Rbf(1), lib.Rbf(1)], likelihood=liks.Bernoulli(), **extra)
    tm = SKIGPR(x, y, [kernels.Rbf(1), kernels.Rbf(1)], grid_shape=10, device="cpu")
    with pytest.raises(ValueError, match="minibatch"):
        tm.loss(x=tm.X[:5], y=tm.Y[:5])
