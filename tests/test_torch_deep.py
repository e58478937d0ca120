"""The port's DeepGP (gptorch_tpu_torch.models.deep) against the JAX
package, float64 on the CPU, data from a numpy seed (n = 30, d = 2, two
layers: widths (3,), so the first mean map pads), the JAX model's
trainables spread from its start and loaded into the port by
``convert.load_trainable``; the JAX references from one compiled call.
The normals are held fixed: the port's one (S, n, w) draw per hidden
layer returns the JAX package's per-sample draws, stacked.

* The start: each layer's Z bit for bit (k-means carried through the mean
  maps), q_sqrt = 1e-5·I, the trainable paths.
* The sampled ELBO (S = 2) and its gradient: 1e-8.
* predict_f over 3 samples (the mixture moments): 1e-8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu.models import DeepGP as JaxDeepGP
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu_torch import convert, sampling
from gptorch_tpu_torch.models import DeepGP
from gptorch_tpu_torch.module import get_trainable

N, D, M, S = 30, 2, 5, 2
RTOL = 1e-8


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data():
    rng = np.random.RandomState(0)
    x = rng.randn(N, D)
    y = np.sin(2 * x[:, :1]) * np.cos(x[:, 1:]) + 0.05 * rng.randn(N, 1)
    return x, y, rng.randn(4, D)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _draws(key, num_samples, n, widths):
    """The JAX package's normals of one stochastic pass per sample (each
    sample's key split once per hidden layer), stacked per layer: (S, n, w)."""
    out = [[] for _ in widths]
    for k in jax.random.split(key, num_samples):
        for l, w in enumerate(widths):
            k, sub = jax.random.split(k)
            out[l].append(np.asarray(jax.random.normal(sub, (n, w), jnp.float64)))
    return [np.stack(o) for o in out]


@functools.lru_cache(maxsize=None)
def _jax():
    x, y, xs = _data()
    jm = JaxDeepGP(x, y, widths=(3,), num_inducing=M, num_samples=S)
    start = {f"layer{l}": np.asarray(getattr(jm, f"layer{l}").Z.value) for l in range(2)}
    rng = np.random.RandomState(1)
    values = {k: np.asarray(v) + 0.05 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jm).items()}
    jm = jax_with_trainable(jm, values)
    kl, kp = jax.random.PRNGKey(4), jax.random.PRNGKey(5)

    @jax.jit
    def refs(m):
        loss, grads = jax.value_and_grad(lambda mm: -mm.log_likelihood(key=kl))(m)
        return {"loss": loss, "grads": jax_get_trainable(grads), "f": m._predict(jnp.asarray(xs), key=kp,
                                                                                  num_samples=3)}

    out = jax.tree_util.tree_map(np.asarray, refs(jm))
    return start, values, out, _draws(kl, S, N, (3,)), _draws(kp, 3, 4, (3,))


def _port():
    x, y, _ = _data()
    return DeepGP(x, y, widths=(3,), num_inducing=M, num_samples=S, device="cpu")


def _held(monkeypatch, draws):
    it = iter(draws)
    monkeypatch.setattr(sampling, "standard_normal", lambda gen, shape, like: torch.tensor(next(it)))


def test_start_matches_jax():
    m = _port()
    start, values, _, _, _ = _jax()
    for name, z in start.items():
        np.testing.assert_array_equal(getattr(m, name).Z.value.detach().numpy(), z)
        layer = getattr(m, name)
        np.testing.assert_allclose(layer.q_sqrt.value.detach().numpy(), 1e-5 * np.eye(M), rtol=1e-15, atol=0)
        assert not layer.mean_W.requires_grad and "mean_W" in dict(layer.named_buffers())
    assert np.array_equal(m.layer0.mean_W.numpy(), np.eye(2, 3)) and m.num_layers == 2
    assert sorted(get_trainable(m)) == sorted(values)
    assert "kernel.length_scales" in values  # the unused base kernel slot, as in the JAX package


def test_sampled_elbo_and_gradient_match_jax(monkeypatch):
    m = _port()
    _, values, refs, draws, _ = _jax()
    convert.load_trainable(m, values)
    _held(monkeypatch, draws)
    loss = m._loss(generator=torch.Generator())
    assert float(loss.detach()) == pytest.approx(float(refs["loss"]), rel=RTOL)
    raws = get_trainable(m)
    grads = torch.autograd.grad(loss, list(raws.values()), allow_unused=True)
    for (path, raw), g in zip(raws.items(), grads):
        _close(torch.zeros_like(raw) if g is None else g, refs["grads"][path])


def test_predict_f_mixture_matches_jax(monkeypatch):
    _, _, xs = _data()
    m = _port()
    _, values, refs, _, draws = _jax()
    convert.load_trainable(m, values)
    _held(monkeypatch, draws)
    mean, var = m._predict(torch.as_tensor(xs), generator=torch.Generator(), num_samples=3)
    _close(mean.detach().numpy(), refs["f"][0])
    _close(var.detach().numpy(), refs["f"][1])


def test_minibatch_elbo_is_rescaled():
    x, y, _ = _data()
    m = _port()
    g = torch.Generator().manual_seed(0)
    one = m.log_likelihood(torch.as_tensor(x[:10]), torch.as_tensor(y[:10]), generator=g)
    kl = sum(layer.kl() for layer in m._layers())
    g = torch.Generator().manual_seed(0)
    mean, var = m._propagate(torch.as_tensor(x[:10]), g, S)
    ell = m.likelihood.propagate_log(mean, var, torch.as_tensor(y[:10]).expand(mean.shape)) / S
    assert float(one.detach()) == pytest.approx(float((N / 10) * ell - kl), rel=1e-12)


def test_full_covariance_raises():
    with pytest.raises(NotImplementedError):
        _port().predict_f(np.zeros((2, D)), diag=False)
