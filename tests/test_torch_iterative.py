"""The port's matrix-free exact GP (gptorch_tpu_torch.ops.iterative, the
plain twins of K3 and K4, GPR(solver="iterative") and its posterior)
against the JAX package's gptorch_tpu.ops.iterative, float64 on the CPU.

The same numpy inputs go through both; the shapes are those of
tests/test_iterative.py (n = 300-400, d = 3, dy = 2).  Same seeds and the
same algorithm, so values agree to about 1e-9 relative: the two packages
sum in other orders, and CG and Lanczos carry those roundoff differences
through their iterations.  The data has no near-ties among the pivoted
Cholesky's diagonals, so both packages pick the same pivots.

CG's per-step coefficients are chaotic in floating point once a run goes
on long enough: with a rank-20 preconditioner at noise 0.1 (46 steps), the
two packages' α coefficients differ by 7e-16 relative at step 0, 3e-13 at
step 15, 1e-4 at step 20 and O(1) from step 25, and the steps used differ
by one or two, while the solutions agree to 8e-8 and the SLQ logdets to
1e-9.  So the tests that compare coefficients, step counts and masks use
the model's default preconditioner rank (64; 60 in the mBCG test), under
which every column converges within 18 steps and the coefficients agree to
1e-13; the long run is held by its solution.  The JAX side
runs under jax.jit, once per case."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu.ops import iterative as ji
from gptorch_tpu_torch import convert, kernels, likelihoods, mean_functions
from gptorch_tpu_torch.models import GPR, IterativeGPRPosterior
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.ops import iterative as ti
from gptorch_tpu_torch.ops import lowrank_contract, mvm

KINDS = ["rbf", "matern12", "matern32", "matern52", "rq"]
RTOL = 1e-9


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@functools.cache
def _data(n=300, d=3, dy=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    y = np.sin(x[:, :dy]) + 0.1 * rng.randn(n, dy)
    return x, y


THETA = {"log_ell": np.log([0.9, 1.2, 0.8]), "log_var": np.asarray(np.log(1.3)),
         "log_noise": np.asarray(np.log(0.1)), "log_extra": np.log([0.7])}


def _theta(kind, names=("log_ell", "log_var", "log_noise")):
    """The log hyperparameters as numpy arrays, rq's log α last."""
    return [THETA[k] for k in names] + ([THETA["log_extra"]] if kind == "rq" else [])


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# -- the matrix-free product (K3's plain twin) and its gradient -------------------


@functools.cache
def _jax_mvm(kind, slab):
    x, _ = _data()
    V = np.random.RandomState(1).randn(300, 4)
    C = np.random.RandomState(2).randn(300, 4)

    def f(le, lv, ln, V, *extra):
        out = ji.radial_mvm(kind, le, lv, ln, jnp.asarray(x), V, 1e-4, slab, extra[0] if extra else None)
        return jnp.sum(out * C), out

    args = [jnp.asarray(a) for a in _theta(kind)[:3] + [V] + _theta(kind)[3:]]
    (_, out), grads = jax.jit(jax.value_and_grad(f, argnums=tuple(range(len(args))), has_aux=True))(*args)
    return V, C, np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("slab", [64, 100, 512])
@pytest.mark.parametrize("kind", KINDS)
def test_radial_mvm_matches_jax(kind, slab):
    x, _ = _data()
    V, C, want, want_grads = _jax_mvm(kind, slab)
    theta = _theta(kind)
    args = [_t(a, True) for a in theta[:3]] + [_t(V, True)] + [_t(a, True) for a in theta[3:]]
    before = mvm.gram_mvm.launches, lowrank_contract.lowrank_contractions.launches
    out = ti.radial_mvm(kind, *args[:3], _t(x), args[3], 1e-4, slab, args[4] if kind == "rq" else None)
    _close(out, want)
    torch.sum(out * _t(C)).backward()
    for a, w in zip(args, want_grads):
        assert a.grad.shape == a.shape
        _close(a.grad, w, rtol=1e-8)
    assert (mvm.gram_mvm.launches, lowrank_contract.lowrank_contractions.launches) == before  # the CPU's twins


def test_gram_mvm_ragged_slab_and_widths():
    """The twin's overlapping final slab, a single column and a wide block
    against the dense product."""
    x, _ = _data(n=301)
    xs = torch.as_tensor(x) / torch.exp(_t(THETA["log_ell"]))
    r2 = torch.cdist(xs, xs) ** 2
    K = 1.3 * torch.exp(-0.5 * r2) + 0.1 * torch.eye(301)
    for k in (1, 9, 40):
        V = torch.as_tensor(np.random.RandomState(k).randn(301, k))
        got = mvm.gram_mvm("rbf", xs, _t(np.log(1.3)), 0.1, V, slab=64)
        _close(got, K @ V, rtol=1e-11, atol=1e-12)


# -- pivoted Cholesky, Woodbury, mBCG, Lanczos -----------------------------------


@pytest.mark.parametrize("kind", ["rbf", "matern32", "rq"])
def test_pivoted_cholesky_matches_jax(kind):
    x, _ = _data()
    theta = _theta(kind)
    extra = (lambda a: a[3]) if kind == "rq" else (lambda a: None)
    want = jax.jit(lambda *a: ji.pivoted_cholesky(kind, a[0], a[1], jnp.asarray(x), 40, extra(a)))(
        *[jnp.asarray(a) for a in theta])
    got = ti.pivoted_cholesky(kind, _t(theta[0]), _t(theta[1]), _t(x), 40, extra([_t(a) for a in theta]))
    _close(got, want, atol=1e-12)


def test_woodbury_matches_jax():
    rng = np.random.RandomState(2)
    L, B = rng.randn(50, 7), rng.randn(50, 3)
    _close(ti.woodbury_solve(_t(L), 0.3, _t(B)), ji.woodbury_solve(jnp.asarray(L), 0.3, jnp.asarray(B)), rtol=1e-12)
    _close(ti.woodbury_logdet(_t(L), 0.3, 50), ji.woodbury_logdet(jnp.asarray(L), 0.3, 50), rtol=1e-13)


def _jax_operator(x, kind="rbf", slab=128):
    le, lv, ln = (jnp.asarray(a) for a in _theta(kind)[:3])
    return lambda V: ji.radial_mvm(kind, le, lv, ln, jnp.asarray(x), V, slab=slab)


def _torch_operator(x, kind="rbf", slab=128):
    le, lv, ln = (_t(a) for a in _theta(kind)[:3])
    return lambda V: ti.radial_mvm(kind, le, lv, ln, _t(x), V, slab=slab)


@pytest.mark.parametrize("rank", [60, 20])
def test_mbcg_matches_jax(rank):
    x, y = _data()
    B = np.concatenate([y, np.random.RandomState(3).randn(300, 4)], axis=1)

    @jax.jit
    def run(B):
        L = ji.pivoted_cholesky("rbf", *(jnp.asarray(a) for a in _theta("rbf")[:2]), jnp.asarray(x), rank)
        return ji.mbcg(_jax_operator(x), lambda V: ji.woodbury_solve(L, 0.1, V), B, 60, 1e-6)

    want = run(jnp.asarray(B))
    L = ti.pivoted_cholesky("rbf", *(_t(a) for a in _theta("rbf")[:2]), _t(x), rank)
    got = ti.mbcg(_torch_operator(x), lambda V: ti.woodbury_solve(L, 0.1, V), _t(B), 60, 1e-6)
    steps = got[3].sum(dim=0)
    assert 0 < int(steps.min()) and int(steps.max()) < 60  # every column converged, then stayed masked
    if rank == 20:  # the long run: coefficients chaotic (module docstring), solutions held
        # each stops at a relative residual ‖B − K̂X‖ ≤ 1e-6·‖B‖ per column,
        # so ‖K̂(X_port − X_jax)‖ ≤ 2e-6·‖B‖
        gap = _torch_operator(x)(got[0] - _t(np.asarray(want[0])))
        assert bool(torch.all(torch.linalg.norm(gap, dim=0) <= 2e-6 * torch.linalg.norm(_t(B), dim=0)))
        return
    assert torch.equal(got[3], torch.as_tensor(np.asarray(want[3])))  # valid: the same steps used
    for g, w in zip(got[:3], want[:3]):
        _close(g, w, atol=1e-12)


def test_lanczos_root_inverse_matches_jax():
    x, _ = _data()
    q0 = np.random.RandomState(4).randn(300)
    want = jax.jit(lambda q: ji.lanczos_root_inverse(_jax_operator(x), q, 48))(jnp.asarray(q0))
    got = ti.lanczos_root_inverse(_torch_operator(x), _t(q0), 48)
    _close(got, want, rtol=1e-8, atol=1e-10)


# -- the backward contraction (K4's plain twin) -----------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_lowrank_contractions_match_jax(kind):
    x, _ = _data(n=400)
    rng = np.random.RandomState(5)
    Wl, Wr = rng.randn(400, 5), rng.randn(400, 5)  # an asymmetric W
    xs = x / np.exp(THETA["log_ell"])
    extra = THETA["log_extra"] if kind == "rq" else None
    want = jax.jit(lambda *a: ji._lowrank_contractions(kind, *a, 128, None if extra is None else jnp.asarray(extra)))(
        jnp.asarray(xs), jnp.asarray(1.3), jnp.asarray(Wl), jnp.asarray(Wr))
    got = lowrank_contract.lowrank_contractions(kind, _t(xs), _t(1.3), _t(Wl), _t(Wr), 128,
                                                None if extra is None else _t(extra))
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-10, atol=1e-10)
    # the scales a kernel is held against bound each output
    scales = lowrank_contract.lowrank_scales(kind, _t(xs), _t(1.3), _t(Wl), _t(Wr), 128,
                                             None if extra is None else _t(extra))
    for g, s in zip(got, scales):
        assert bool(torch.all(g.abs() <= s * (1 + 1e-12)))


# -- the NLML, its gradient and the diagnostics -----------------------------------

IT = dict(jitter=1e-4, slab=128, probes=6, max_iters=80, precond_rank=64, tol=1e-8)


def _seeds(n=300):
    return np.random.RandomState(6).randn(n + IT["precond_rank"], IT["probes"])


@functools.cache
def _jax_nlml(kind, ell):
    x, y = _data()
    theta = _theta(kind)
    theta[0] = {"ard": theta[0], "scalar": np.asarray(np.log(1.1)), "one": np.log([1.1])}[ell]

    def f(*t):
        return ji.radial_nlml_iterative(kind, *t[:3], jnp.asarray(x), jnp.asarray(y), jnp.asarray(_seeds()),
                                        IT["jitter"], IT["slab"], IT["probes"], IT["max_iters"], IT["precond_rank"],
                                        IT["tol"], t[3] if kind == "rq" else None)

    value, grads = jax.jit(jax.value_and_grad(f, argnums=tuple(range(len(theta)))))(
        *[jnp.asarray(a) for a in theta])
    return theta, float(value), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("kind, ell", [("rbf", "ard"), ("matern32", "ard"), ("rq", "ard"), ("rbf", "scalar"),
                                       ("matern12", "one")])
def test_radial_nlml_iterative_matches_jax(kind, ell):
    x, y = _data()
    theta, want, want_grads = _jax_nlml(kind, ell)
    params = [_t(a, True) for a in theta]
    got = ti.radial_nlml_iterative(kind, *params[:3], _t(x), _t(y), _t(_seeds()), IT["jitter"], IT["slab"],
                                   IT["probes"], IT["max_iters"], IT["precond_rank"], IT["tol"],
                                   params[3] if kind == "rq" else None)
    assert float(got.detach()) == pytest.approx(want, rel=RTOL)
    got.backward()
    for p, w in zip(params, want_grads):
        assert p.grad.shape == p.shape
        _close(p.grad, w, rtol=1e-8, atol=1e-10)


def test_rq_needs_log_extra():
    x, y = _data()
    with pytest.raises(ValueError, match="log_extra"):
        ti.radial_nlml_iterative("rq", *(_t(a) for a in _theta("rbf")), _t(x), _t(y), _t(_seeds()))


def test_radial_slq_diagnostics_match_jax():
    x, y = _data()
    theta = _theta("rbf")
    args = (IT["jitter"], IT["slab"], IT["probes"], IT["max_iters"], IT["precond_rank"], IT["tol"])
    want = jax.jit(lambda *t: ji.radial_slq_diagnostics("rbf", *t, jnp.asarray(x), jnp.asarray(y),
                                                        jnp.asarray(_seeds()), *args))(
        *[jnp.asarray(a) for a in theta])
    got = ti.radial_slq_diagnostics("rbf", *(_t(a) for a in theta), _t(x), _t(y), _t(_seeds()), *args)
    assert set(got) == set(want)
    for k in want:
        # a converged column's final residual is roundoff-sized (~tol/2 here):
        # its digits beyond 1e-3 of tol are the summation order's
        atol = 1e-3 * IT["tol"] if k == "cg_relres" else 1e-12
        _close(got[k], want[k], rtol=1e-8, atol=atol)
    assert int(got["cg_iters"].max()) < IT["max_iters"] and float(got["cg_relres"].max()) < IT["tol"]


# -- GPR(solver="iterative") and its posterior ------------------------------------

GPR_IT = dict(solver="iterative", probes=6, max_cg_iters=80, precond_rank=64, cg_tol=1e-8, mvm_slab=128,
              probe_seed=3, fast_jitter=1e-4)


@functools.cache
def _gpr_pair():
    """The same iterative GPR in both packages; raws perturbed in the JAX
    model and carried across by convert.load_trainable."""
    x, y = _data()
    jax_model = JaxGPR(x, y, jax_kernels.Rbf(3, ARD=True), likelihood=jax_likelihoods.Gaussian(0.1), **GPR_IT)
    rng = np.random.RandomState(7)
    values = {k: np.asarray(v) + 0.2 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jax_model).items()}
    jax_model = jax_with_trainable(jax_model, {k: jnp.asarray(v) for k, v in values.items()})
    return jax_model, values


def _gpr():
    x, y = _data()
    model = GPR(x, y, kernels.Rbf(3, ARD=True), likelihood=likelihoods.Gaussian(0.1), device="cpu", **GPR_IT)
    convert.load_trainable(model, _gpr_pair()[1])
    return model


@functools.cache
def _jax_gpr_reference():
    jax_model, values = _gpr_pair()

    def loss(v):
        return jax_with_trainable(jax_model, v).loss()

    value, grads = jax.jit(jax.value_and_grad(loss))({k: jnp.asarray(v) for k, v in values.items()})
    xq = np.random.RandomState(8).randn(16, 3)
    cg = jax_model.predict_f(xq)
    love = jax_model.posterior(love_rank=64).predict_f(xq)
    return float(value), {k: np.asarray(g) for k, g in grads.items()}, xq, cg, love, jax_model.iterative_diagnostics()


def test_gpr_iterative_probe_seeds_match_jax():
    model = _gpr()
    assert model.probe_seeds.shape == (300 + 64, 6)
    np.testing.assert_array_equal(model.probe_seeds.numpy(), np.asarray(_gpr_pair()[0].probe_seeds))


def test_gpr_iterative_loss_and_gradient_match_jax():
    want, want_grads = _jax_gpr_reference()[:2]
    model = _gpr()
    loss = model.loss()
    assert float(loss.detach()) == pytest.approx(want, rel=RTOL)
    loss.backward()
    grads = {k: p.grad.numpy() for k, p in get_trainable(model).items()}
    assert set(grads) == set(want_grads)
    for k in grads:
        _close(grads[k], want_grads[k], rtol=1e-8, atol=1e-10)


def test_gpr_iterative_predictions_match_jax():
    _, _, xq, cg, love, _ = _jax_gpr_reference()
    model = _gpr()
    for got, want in ((model.predict_f(xq), cg), (model.posterior(love_rank=64).predict_f(xq), love)):
        _close(got[0], want[0], rtol=1e-8, atol=1e-10)
        _close(got[1], want[1], rtol=1e-7, atol=1e-9)


def test_gpr_iterative_diagnostics_match_jax():
    want = _jax_gpr_reference()[5]
    got = _gpr().iterative_diagnostics()
    assert set(got) == set(want) and all(isinstance(v, np.ndarray) for v in got.values())
    for k in want:
        _close(got[k], want[k], rtol=1e-8, atol=1e-3 * GPR_IT["cg_tol"] if k == "cg_relres" else 1e-12)


def test_iterative_posterior_is_frozen():
    """A posterior taken before training predicts the same after it."""
    model = _gpr()
    xq = np.random.RandomState(9).randn(5, 3)
    post = model.posterior(love_rank=32)
    assert isinstance(post, IterativeGPRPosterior)
    before = post.predict_f(xq)
    with torch.no_grad():
        model.kernel.length_scales.raw.add_(0.3)
        model.likelihood.variance.raw.sub_(0.2)
    after = post.predict_f(xq)
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])
    assert not np.allclose(model.predict_f(xq)[0], before[0])


def test_iterative_errors():
    x, y = _data()
    model = _gpr()
    with pytest.raises(ValueError, match="minibatched"):
        model.loss(x=torch.as_tensor(x[:100]), y=torch.as_tensor(y[:100]))
    with pytest.raises(ValueError, match="requires a radial kernel"):
        GPR(x, y, kernels.Rbf(3), mean_function=mean_functions.Constant(2), solver="iterative", device="cpu")
    dense = GPR(x, y, kernels.Rbf(3), device="cpu")
    with pytest.raises(ValueError, match="love_rank"):
        dense.posterior(love_rank=8)
    with pytest.raises(ValueError, match="solver='iterative'"):
        dense.iterative_diagnostics()
    with pytest.raises(NotImplementedError, match="dense solver"):
        model.predict_uncertain(x[:2], np.zeros((2, 3)))
