"""The port's HeteroscedasticSVGP (gptorch_tpu_torch.models.heteroscedastic)
against the JAX package, float64 on the CPU, data from numpy seeds
(n = 40, d = 1, m = 6), the JAX model's trainables spread from its start
and loaded into the port by ``convert.load_trainable``; the JAX references
from one compiled call.

* ``_exp_lin`` at t = 29, 30, 31 (its cap): value and gradient 1e-12.
* The start: Z (k-means) and μ₀ equal, q prior-matched (KL = 0).
* The ELBO on the full data and on one explicit batch (scaled by n/b):
  1e-10 relative, the batch's gradient 1e-10 of its largest entry.
* predict_f (diagonal and full), predict_noise, predict_y (diagonal and
  full), predict_log_density (32 Gauss–Hermite nodes): 1e-10.
* Observed draws with the JAX draws held fixed: 1e-10.
* One natural-gradient step over both q groups (γ = 0.3, Adam 1e-2 on the
  rest): 1e-9.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu.models import HeteroscedasticSVGP as JaxHet
from gptorch_tpu.models.heteroscedastic import _exp_lin as jax_exp_lin
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu.training import natgrad as jax_natgrad
from gptorch_tpu_torch import convert, kernels, sampling
from gptorch_tpu_torch.models import HeteroscedasticSVGP
from gptorch_tpu_torch.models.heteroscedastic import _exp_lin
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.training import natgrad

N, M = 40, 6
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data():
    rng = np.random.RandomState(0)
    x = np.sort(rng.uniform(-2, 2, (N, 1)), axis=0)
    y = np.sin(2 * x) + (0.05 + 0.3 / (1 + np.exp(-2 * x))) * rng.randn(N, 1)
    return x, y, rng.uniform(-2, 2, (5, 1)), rng.randn(5, 1)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


@functools.lru_cache(maxsize=None)
def _jax():
    x, y, xs, ys = _data()
    jm = JaxHet(x, y, jax_kernels.Rbf(1), num_inducing_points=M, batch_size=16)
    start = {"Z": np.asarray(jm.Z.value), "noise_mean": np.asarray(jm.noise_mean.value)}
    rng = np.random.RandomState(1)
    values = {k: np.asarray(v) + 0.05 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jm).items()}
    jm = jax_with_trainable(jm, values)
    q, qy, xb, yb = jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(x[::3]), jnp.asarray(y[::3])
    key = jax.random.PRNGKey(3)

    @jax.jit
    def refs(m):
        batch, gb = jax.value_and_grad(lambda mm: mm._loss(xb, yb))(m)
        full = -m.log_likelihood(jnp.asarray(x), jnp.asarray(y))
        return {"batch": batch, "g_batch": jax_get_trainable(gb), "full": full,
                "f": m.predict_f(q), "f_full": m.predict_f(q, diag=False), "noise": m.predict_noise(q),
                "y": m.predict_y(q), "y_full": m.predict_y(q, diag=False),
                "lpd": m.predict_log_density(q, qy), "samples": m._sample(q, 4, key, observed=True)}

    out = jax.tree_util.tree_map(np.asarray, refs(jm))
    kf, kg, ke = jax.random.split(key, 3)
    out["draws"] = [np.asarray(jax.random.normal(k, s, jnp.float64)) for k, s in ((kf, (4, 5, 1)), (kg, (4, 5, 1)),
                                                                                   (ke, (4, 5)))]
    # one natural step of the full-batch twin (the port's step draws no batch)
    jfull = jm.replace(batch_size=None)
    jstep, nat_values, opt_state = jax_natgrad.make_natgrad_step(jfull, nat_lr=0.3)
    nat_values, _, nat_loss = jstep(nat_values, opt_state, jfull, key)
    out["nat"] = ({k: np.asarray(v) for k, v in nat_values.items()}, float(nat_loss))
    return start, values, out


def _port(batch_size=16):
    x, y, _, _ = _data()
    start, values, refs = _jax()
    m = HeteroscedasticSVGP(x, y, kernels.Rbf(1), num_inducing_points=M, batch_size=batch_size, device="cpu")
    return m, start, values, refs


@pytest.mark.parametrize("t", [29.0, 30.0, 31.0])
def test_exp_lin_cap_matches_jax(t):
    want, want_grad = jax.value_and_grad(jax_exp_lin)(jnp.float64(t))
    tt = torch.tensor(t, requires_grad=True)
    got = _exp_lin(tt)
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-12)
    assert float(tt.grad) == pytest.approx(float(want_grad), rel=1e-12)


def test_start_matches_jax():
    m, start, values, _ = _port()
    np.testing.assert_array_equal(m.Z.value.detach().numpy(), start["Z"])
    _close(m.noise_mean.value.detach().numpy(), start["noise_mean"], 1e-14)
    _, _, xs, _ = _data()
    assert abs(float(m._moments(torch.as_tensor(xs))[-1].detach())) < 1e-9  # q starts prior-matched
    assert sorted(get_trainable(m)) == sorted(values)
    assert m.variational_groups == (("qf_mu", "qf_chol"), ("qg_mu", "qg_chol"))


def test_elbo_and_gradient_match_jax():
    x, y, _, _ = _data()
    m, _, values, refs = _port()
    convert.load_trainable(m, values)
    raws = get_trainable(m)
    full = -m.log_likelihood(torch.as_tensor(x), torch.as_tensor(y))
    assert float(full.detach()) == pytest.approx(float(refs["full"]), rel=RTOL)
    loss = m._loss(torch.as_tensor(x[::3]), torch.as_tensor(y[::3]))
    assert float(loss.detach()) == pytest.approx(float(refs["batch"]), rel=RTOL)
    grads = torch.autograd.grad(loss, list(raws.values()))
    for (path, _), g in zip(raws.items(), grads):
        _close(g.numpy(), refs["g_batch"][path])


def test_minibatch_comes_from_the_generator():
    m, _, values, _ = _port()
    convert.load_trainable(m, values)
    a = m.log_likelihood(generator=torch.Generator().manual_seed(5))
    b = m.log_likelihood(generator=torch.Generator().manual_seed(5))
    assert float(a) == float(b)
    idx = torch.randperm(N, generator=torch.Generator().manual_seed(5))[:16]
    assert float(a) == pytest.approx(float(m.log_likelihood(m.X[idx], m.Y[idx])), rel=1e-14)


def test_predictions_match_jax():
    _, _, xs, ys = _data()
    m, _, values, refs = _port()
    convert.load_trainable(m, values)
    for name, got in (("f", m.predict_f(xs)), ("f_full", m.predict_f(xs, diag=False)),
                      ("noise", m.predict_noise(xs)), ("y", m.predict_y(xs)),
                      ("y_full", m.predict_y(xs, diag=False))):
        assert all(isinstance(g, np.ndarray) for g in got)
        for g, w in zip(got, refs[name]):
            _close(g, w)
    _close(m.predict_log_density(xs, ys), refs["lpd"])


def test_observed_draws_with_the_jax_draws(monkeypatch):
    _, _, xs, _ = _data()
    m, _, values, refs = _port()
    convert.load_trainable(m, values)
    draws = iter(refs["draws"])
    monkeypatch.setattr(sampling, "standard_normal", lambda gen, shape, like: torch.tensor(next(draws)))
    got = m.predict_y_samples(xs, 4, generator=torch.Generator())
    _close(got, refs["samples"])


def test_natural_step_over_both_groups_matches_jax():
    m, _, values, refs = _port(batch_size=None)
    want, want_loss = refs["nat"]
    convert.load_trainable(m, values)
    step, _ = natgrad.make_natgrad_step(m, nat_lr=0.3)
    loss = step()
    assert float(loss) == pytest.approx(want_loss, rel=1e-12)
    got = get_trainable(m)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        _close(got[path].detach().numpy(), w, 1e-9)


def test_single_output_only():
    x, y, _, _ = _data()
    with pytest.raises(ValueError, match="single output"):
        HeteroscedasticSVGP(x, np.c_[y, y], kernels.Rbf(1), num_inducing_points=M, device="cpu")
