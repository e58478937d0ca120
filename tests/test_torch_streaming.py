"""The port's streaming sparse GPs (gptorch_tpu_torch.models.StreamingVFE
and OnlineSGPR) against the JAX package and against the port's batch VFE,
float64 on the CPU, data from a numpy seed (n = 60, d = 2, m = 8, batches
of 20).

StreamingVFE (mirrors the JAX package's tests/test_streaming.py):
* the bound and predict_f (diagonal, full) after streaming equal the JAX
  package's and the port's batch VFE on all the data: 1e-10;
* predict_y and predict_uncertain (ψ-statistics Rbf) equal batch VFE's;
* any order of batches gives the same bound, downdate inverts update,
  update leaves the old model as it was, observe works in place, a
  constant mean is residualized, a non-Gaussian likelihood is rejected.

OnlineSGPR (mirrors tests/test_online.py):
* with θ and Z fixed (fit_iters = 0) the streamed posterior equals batch
  VFE (1e-8) and the JAX package's (1e-10); the per-step bounds sum to the batch
  bound (the JAX package's test allows 2e-3; here 1e-8 relative, the
  first step's bound equals batch VFE's to 1e-10);
* five Adam iterations of step (lr 0.05) from the same values, on each of
  three batches: the trainables, the summary and predict_f match the JAX
  package's to 1e-9;
* validation: Gaussian only, no bound without a batch, no prediction
  before a step, no L-BFGS; a full covariance is symmetric.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu.models import OnlineSGPR as JaxOnline
from gptorch_tpu.models import StreamingVFE as JaxStreaming
from gptorch_tpu.models.online import _cached_step
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu_torch import ekernels, kernels, likelihoods, mean_functions
from gptorch_tpu_torch.models import VFE, OnlineSGPR, StreamingVFE
from gptorch_tpu_torch.module import get_trainable

N, D, M, B = 60, 2, 8, 20
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
    y = np.sin(x.sum(-1, keepdims=True)) + 0.1 * rng.randn(N, 1)
    z = x[rng.permutation(N)[:M]].copy()
    return x, y, z, rng.randn(5, D)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


LS = np.array([0.8, 1.1])


def _kern(lib=kernels):
    return lib.Rbf(D, ARD=True, length_scales=LS)


def _stream(**kw):
    x, y, z, _ = _data()
    s = StreamingVFE(_kern(kw.pop("lib", kernels)), z, likelihood=likelihoods.Gaussian(0.05), device="cpu", **kw)
    for lo in range(0, N, B):
        s = s.update(x[lo : lo + B], y[lo : lo + B])
    return s


def _batch(**kw):
    x, y, z, _ = _data()
    return VFE(x, y, _kern(kw.pop("lib", kernels)), inducing_points=z, likelihood=likelihoods.Gaussian(0.05),
               jitter=1e-6, device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def _jax_stream():
    x, y, z, xs = _data()
    s = JaxStreaming(_kern(jax_kernels), z, likelihood=jax_likelihoods.Gaussian(0.05))

    @jax.jit
    def refs(s):
        for lo in range(0, N, B):
            s = s.update(jnp.asarray(x[lo : lo + B]), jnp.asarray(y[lo : lo + B]))
        return s.log_likelihood(), s.predict_f(jnp.asarray(xs)), s.predict_f(jnp.asarray(xs), diag=False)

    return jax.tree_util.tree_map(np.asarray, refs(s))


def test_stream_matches_jax_and_batch_vfe():
    _, _, _, xs = _data()
    s, batch = _stream(), _batch()
    bound, f, f_full = _jax_stream()
    assert float(s.log_likelihood().detach()) == pytest.approx(float(bound), rel=RTOL)
    assert float(s.log_likelihood().detach()) == pytest.approx(float(batch.log_likelihood().detach()), rel=RTOL)
    for got, jax_want, batch_want in ((s.predict_f(xs), f, batch.predict_f(xs)),
                                      (s.predict_f(xs, diag=False), f_full, batch.predict_f(xs, diag=False))):
        for g, w, bw in zip(got, jax_want, batch_want):
            _close(g, w)
            _close(g, bw)
    mu, var = s.predict_y(xs)
    assert isinstance(mu, np.ndarray)
    _close(var, s.predict_f(xs)[1] + 0.05, 1e-14)


def test_predict_uncertain_matches_batch():
    rng = np.random.RandomState(3)
    xq, xv = rng.randn(6, D), 0.05 * np.ones((6, D))
    got = _stream(lib=ekernels).predict_uncertain(xq, xv)
    want = _batch(lib=ekernels).predict_uncertain(xq, xv)
    for g, w in zip(got, want):
        _close(g, w)


def test_order_invariance_and_downdate():
    x, y, z, _ = _data()
    target = float(_stream().log_likelihood().detach())
    perm = np.random.RandomState(4).permutation(N)
    s = StreamingVFE(_kern(), z, likelihood=likelihoods.Gaussian(0.05), device="cpu")
    for lo in range(0, N, 25):
        s = s.update(x[perm[lo : lo + 25]], y[perm[lo : lo + 25]])
    assert float(s.log_likelihood().detach()) == pytest.approx(target, rel=1e-12)
    extra_x, extra_y = x[:15] + 1.0, y[:15] - 0.5
    back = s.update(extra_x, extra_y).downdate(extra_x, extra_y)
    assert float(back.log_likelihood().detach()) == pytest.approx(target, rel=1e-12)
    assert float(back.n_seen) == N


def test_update_is_pure_and_observe_in_place():
    x, y, z, _ = _data()
    s0 = StreamingVFE(_kern(), z, likelihood=likelihoods.Gaussian(0.05), device="cpu")
    s1 = s0.update(x[:B], y[:B])
    assert float(s0.n_seen) == 0 and float(s1.n_seen) == B and not torch.any(s0.phi_w != 0)
    assert s1.kernel is s0.kernel and s1.Z is s0.Z and s1.likelihood is s0.likelihood
    assert s0.observe(x[:B], y[:B]) is s0
    for name in ("phi_w", "r_w", "yy", "kdiag_sum", "n_seen"):
        assert torch.equal(getattr(s0, name), getattr(s1, name))
    assert "n_seen=20" in repr(s0) and "n_seen=60" in repr(_stream())


def test_mean_function_residualization():
    x, y, z, xs = _data()
    mf = mean_functions.Constant(1, np.array([2.0]))
    batch = VFE(x, y + 2.0, _kern(), inducing_points=z, likelihood=likelihoods.Gaussian(0.05), jitter=1e-6,
                mean_function=mf, device="cpu")
    s = StreamingVFE(_kern(), z, likelihood=likelihoods.Gaussian(0.05), mean_function=mf, device="cpu")
    s = s.update(x, y + 2.0)
    assert float(s.log_likelihood().detach()) == pytest.approx(float(batch.log_likelihood().detach()), rel=RTOL)
    _close(s.predict_f(xs)[0], batch.predict_f(xs)[0])


def test_streaming_rejects_non_gaussian():
    _, _, z, _ = _data()
    with pytest.raises(ValueError, match="Gaussian"):
        StreamingVFE(_kern(), z, likelihood=likelihoods.Poisson(), device="cpu")


# -- OnlineSGPR ---------------------------------------------------------------------


def _online(lib=kernels, jitter=1e-6, device="cpu"):
    _, _, z, _ = _data()
    kw = {} if lib is jax_kernels else {"device": device}
    liks = jax_likelihoods if lib is jax_kernels else likelihoods
    return (JaxOnline if lib is jax_kernels else OnlineSGPR)(_kern(lib), z, likelihood=liks.Gaussian(0.05),
                                                             jitter=jitter, **kw)


@jax.jit
def _jax_absorb(o, x, y):
    o = o.replace(X=x, Y=y)
    o._absorb()
    return o


@jax.jit
def _jax_predict(o, xs):
    return o.predict_f(xs)


@functools.lru_cache(maxsize=None)
def _jax_online(fit_iters):
    """The JAX package's model after each of the three steps (its
    ``step`` with the absorb and the predictions compiled): the trainables,
    the summary and predict_f."""
    x, y, _, xs = _data()
    o = _online(jax_kernels, jitter=1e-6 if fit_iters else 1e-9)
    out = []
    for lo in range(0, N, B):
        xb, yb = jnp.asarray(x[lo : lo + B]), jnp.asarray(y[lo : lo + B])
        if fit_iters:
            o = o.replace(X=xb, Y=yb)
            step = _cached_step("Adam", 0.05)
            values = jax_get_trainable(o)
            opt_state = step.init(values)
            for _ in range(fit_iters):
                values, opt_state, _ = step(values, opt_state, o)
            o = jax_with_trainable(o, values)
        o = _jax_absorb(o, xb, yb)
        out.append(jax.tree_util.tree_map(np.asarray, (
            jax_get_trainable(o), {k: getattr(o, k) for k in ("Z_old", "m_a", "L_Sa", "L_D", "r_a")},
            _jax_predict(o, jnp.asarray(xs)))))
    return out


def test_fixed_theta_stream_equals_batch_vfe_and_jax():
    x, y, z, xs = _data()
    o = _online(jitter=1e-9)
    for lo in range(0, N, B):
        o.step(x[lo : lo + B], y[lo : lo + B], fit_iters=0)
    batch = VFE(x, y, _kern(), inducing_points=z, likelihood=likelihoods.Gaussian(0.05), jitter=1e-9, device="cpu")
    want = batch.predict_f(xs)
    got = o.predict_f(xs)
    for g, w, jw in zip(got, want, _jax_online(0)[-1][2]):
        _close(g, w, 1e-8)
        _close(g, jw)


def test_per_step_bounds_telescope_to_batch_bound():
    x, y, z, _ = _data()
    o = _online(jitter=1e-9)
    total = 0.0
    for lo in range(0, N, B):
        o.X, o.Y = torch.as_tensor(x[lo : lo + B]), torch.as_tensor(y[lo : lo + B])
        bound = float(o.log_likelihood().detach())
        if lo == 0:
            first = VFE(x[:B], y[:B], _kern(), inducing_points=z, likelihood=likelihoods.Gaussian(0.05),
                        jitter=1e-9, device="cpu")
            assert bound == pytest.approx(float(first.log_likelihood().detach()), rel=RTOL)
        total += bound
        o._absorb()
    batch = VFE(x, y, _kern(), inducing_points=z, likelihood=likelihoods.Gaussian(0.05), jitter=1e-9, device="cpu")
    assert total == pytest.approx(float(batch.log_likelihood().detach()), rel=1e-8)


def test_five_adam_iterations_per_step_match_jax():
    x, y, _, xs = _data()
    o = _online(jitter=1e-6)
    for i, lo in enumerate(range(0, N, B)):
        o.step(x[lo : lo + B], y[lo : lo + B], fit_iters=5, learning_rate=0.05)
        values, summary, f = _jax_online(5)[i]
        got = get_trainable(o)
        assert sorted(got) == sorted(values)
        for path, w in values.items():
            _close(got[path].detach().numpy(), w, 1e-9)
        for name, w in summary.items():
            _close(getattr(o, name).numpy(), w, 1e-9)
        for g, w in zip(o.predict_f(xs), f):
            _close(g, w, 1e-9)
    assert o.X.shape == (0, D) and "has_old=True" in repr(o)


def test_online_validation():
    x, y, _, _ = _data()
    _, _, z, _ = _data()
    with pytest.raises(ValueError, match="Gaussian"):
        OnlineSGPR(_kern(), z, likelihood=likelihoods.Poisson(), device="cpu")
    o = _online()
    with pytest.raises(ValueError, match="batch"):
        o.log_likelihood()
    with pytest.raises(ValueError, match="step"):
        o.predict_f(np.zeros((3, D)))
    with pytest.raises(ValueError, match="first-order"):
        o.step(x[:B], y[:B], method="LBFGS")
    o.step(x[:B], y[:B], fit_iters=0)
    _, cov = o.predict_f(x[:6], diag=False)
    np.testing.assert_allclose(cov, cov.T, atol=1e-12)


def test_online_predict_uncertain_at_zero_variance():
    x, y, _, xs = _data()
    o = _online(ekernels)
    o.step(x[:40], y[:40], fit_iters=0)
    mu0, var0 = o.predict_f(xs)
    mu_u, var_u = o.predict_uncertain(xs, np.zeros_like(xs))
    _close(mu_u, mu0, 1e-8)
    _close(var_u, var0, 1e-8)


def test_online_summary_float32_nan_in_both_packages():
    """The summary's factor of D = S_a + T Tᵀ, T = S_a chol(V_aa − S_a)⁻ᵀ,
    goes NaN in float32 after a step that trains θ and Z (n = 256, m = 64,
    d = 3, 20 Adam iterations, no policy jitter): the 1e-10 relative floor
    on V_aa − S_a lies below float32's rounding.  Both packages alike; in
    float64 the port's summary stays finite (ROADMAP §3)."""
    rng = np.random.RandomState(0)
    x = rng.randn(256, 3)
    y = np.sin(x[:, :1]) + 0.1 * rng.randn(256, 1)
    z = x[rng.permutation(256)[:64]]
    from gptorch_tpu import settings as jax_settings
    from gptorch_tpu_torch import settings

    with jax.enable_x64(False), jax_settings.override(jitter_policy="none"):
        jo = JaxOnline(jax_kernels.Rbf(3, ARD=True), z, jitter=1e-6)
        jo.step(x, y, fit_iters=20, learning_rate=0.05)
        assert jo.L_D.dtype == jnp.float32 and not bool(jnp.isfinite(jo.L_D).all())
    finite = {}
    for dtype in (torch.float32, torch.float64):
        torch.set_default_dtype(dtype)
        o = OnlineSGPR(kernels.Rbf(3, ARD=True), z, jitter=1e-6, device="cpu")
        with settings.override(jitter_policy="none"):
            o.step(x, y, fit_iters=20, learning_rate=0.05)
        finite[dtype] = bool(torch.isfinite(o.L_D).all())
    assert finite == {torch.float32: False, torch.float64: True}


def test_online_step_nonfinite_loss_restores_and_raises(monkeypatch):
    """A non-finite loss puts back the values the model had on entry and
    raises FloatingPointError naming the first bad iteration (JAX `step` leaves the
    model untouched)."""
    x, y, _, _ = _data()
    o = _online()
    before = {k: v.detach().clone() for k, v in get_trainable(o).items()}
    monkeypatch.setattr(o, "_loss", lambda x=None, y=None, generator=None: o.loss() * float("nan"))
    with pytest.raises(FloatingPointError, match="iteration 0"):
        o.step(x[:B], y[:B], fit_iters=3)
    for k, v in get_trainable(o).items():
        assert torch.equal(v.detach(), before[k])
