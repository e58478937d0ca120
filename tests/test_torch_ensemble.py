"""The port's fleet of exact GPs (gptorch_tpu_torch.models.GPEnsemble)
against the JAX package's, float64 on the CPU, data from numpy seeds
(B = 3 members, n = 16, d = 2).

* Per-member losses and predictions (diagonal and full, shared and
  per-member queries, ``predict_y``, ``predict_log_density``) at spread
  trainables loaded into both (``convert.load_trainable``), the JAX
  references from one compiled call: 1e-10 relative.
* The fleet gradient: each member's own, 1e-10 of its largest entry.
* The default noise, 0.001·var(y) per member, and the broadcast template.
* ``member_at(i)`` equals a standalone GPR of that member's data and values
  (1e-12); ``best()`` picks the member the JAX losses rank first.
* Three Adam steps (``fit``, eager and ``fit_scan``) give the JAX losses
  (1e-10 relative).
* ``diversify`` leaves member 0 and the original fleet as they were.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu.models import GPEnsemble as JaxGPEnsemble
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu.training import fit as jax_fit
from gptorch_tpu_torch import convert, kernels
from gptorch_tpu_torch.models import GPR, GPEnsemble
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.training import fit

B, N, D = 3, 16, 2
RTOL = 1e-10


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, D)
    y = np.sin(x.sum(-1, keepdims=True)) + 0.1 * rng.randn(B, N, 1)
    return x, y, rng.randn(5, D), rng.randn(B, 4, D), rng.randn(5, 1)


@functools.lru_cache(maxsize=None)
def _jax_fleet(objective):
    """The JAX fleet at spread trainables (member 0 at the template's start),
    and its references from one compiled call."""
    x, y, xs, xb, ys = _data()
    jm = JaxGPEnsemble(x, y, jax_kernels.Rbf(D, ARD=True), objective=objective)
    rng = np.random.RandomState(1)
    values = {}
    for k, v in jax_get_trainable(jm).items():
        eps = 0.3 * rng.randn(*np.shape(v))
        eps[0] = 0.0
        values[k] = np.asarray(v) + eps
    jm = jax_with_trainable(jm, values)

    @jax.jit
    def refs(m):
        losses, grads = jax.vmap(jax.value_and_grad(lambda member: member._loss()))(m.member)
        out = {"losses": losses, "grads": jax_get_trainable(grads)}
        if objective == "nlml":
            out.update(f_shared=m.predict_f(jnp.asarray(xs)), f_each=m.predict_f(jnp.asarray(xb)),
                       f_full=m.predict_f(jnp.asarray(xs), diag=False), y_shared=m.predict_y(jnp.asarray(xs)),
                       lpd=m.predict_log_density(jnp.asarray(xs), jnp.asarray(ys)))
        return out

    return jm, values, jax.tree_util.tree_map(np.asarray, refs(jm))


def _pair(objective="nlml"):
    jm, values, refs = _jax_fleet(objective)
    x, y, *_ = _data()
    tm = GPEnsemble(x, y, kernels.Rbf(D, ARD=True), objective=objective, device="cpu")
    convert.load_trainable(tm, values)
    return jm, tm, refs


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("objective", ["nlml", "loo"])
def test_losses_and_gradient_match_jax(objective):
    _, tm, refs = _pair(objective)
    np.testing.assert_allclose(tm.losses().detach().numpy(), refs["losses"], rtol=RTOL)
    tm._loss().backward()
    for path, raw in get_trainable(tm).items():
        want = refs["grads"][path[len("member."):]]
        for b in range(B):
            _close(raw.grad[b].numpy(), want[b])


def test_predictions_match_jax():
    _, tm, refs = _pair()
    _, _, xs, xb, ys = _data()
    for key, args in (("f_shared", (xs,)), ("f_each", (xb,)), ("f_full", (xs, False))):
        for a, b in zip(refs[key], tm.predict_f(*args)):
            _close(b, a)
    for a, b in zip(refs["y_shared"], tm.predict_y(xs)):
        _close(b, a)
    _close(tm.predict_log_density(xs, ys), refs["lpd"])
    mean, var = tm.predict_f(torch.as_tensor(xs))
    assert isinstance(mean, torch.Tensor) and mean.shape == (B, 5, 1) and var.shape == (B, 5, 1)


def test_default_noise_and_template_broadcast():
    x, y, *_ = _data(3)
    jm = JaxGPEnsemble(x, y, jax_kernels.Rbf(D, ARD=True, length_scales=[0.7, 1.3]))
    tm = GPEnsemble(x, y, kernels.Rbf(D, ARD=True, length_scales=[0.7, 1.3]), device="cpu")
    want = {k: np.asarray(v) for k, v in jax_get_trainable(jm).items()}
    got = {k: v.detach().numpy() for k, v in get_trainable(tm).items()}
    assert set(got) == set(want) == {"member.kernel.variance", "member.kernel.length_scales",
                                     "member.likelihood.variance"}
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    noise = tm.member.likelihood.variance.value.detach().numpy()
    np.testing.assert_allclose(noise, 0.001 * y.var(axis=(1, 2)), rtol=1e-12)
    assert tm.num_members == B and tm.num_data == N and tm.X.shape == (B, N, D)


def test_member_at_is_a_standalone_gpr():
    _, tm, refs = _pair()
    x, y, xs, *_ = _data()
    for i in (0, 2, -1):
        member = tm.member_at(i)
        assert isinstance(member, GPR) and member.X.shape == (N, D)
        alone = GPR(x[i], y[i], kernels.Rbf(D, ARD=True), fast=False, device="cpu")
        shapes = {k: v.shape for k, v in get_trainable(alone).items()}
        convert.load_trainable(alone, {k: v.detach()[i].numpy().reshape(shapes[k])
                                       for k, v in get_trainable(tm.member).items()})
        assert float(member.loss()) == pytest.approx(float(alone.loss()), rel=1e-12)
        assert float(member.loss()) == pytest.approx(float(tm.losses()[i]), rel=1e-12)
        for a, b in zip(member.predict_f(xs), alone.predict_f(xs)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)
    with pytest.raises(IndexError):
        tm.member_at(B)
    best, idx = tm.best()
    assert idx == int(np.argmin(refs["losses"]))
    assert float(best.loss()) == pytest.approx(float(refs["losses"].min()), rel=1e-10)


@functools.lru_cache(maxsize=None)
def _jax_adam_losses():
    jm, _, _ = _jax_fleet("nlml")
    return np.asarray(jax_fit.fit_optax(jm, "Adam", max_iter=3, learning_rate=0.05, verbose=False)[1])


@pytest.mark.parametrize("scan", [False, True])
def test_adam_steps_match_jax(scan):
    _, tm, _ = _pair()
    got = tm.fit("Adam", max_iter=3, learning_rate=0.05, scan=scan)
    np.testing.assert_allclose(got.numpy() if scan else got, _jax_adam_losses(), rtol=RTOL)
    assert not fit.captures(tm, "Adam")  # the CPU runs eagerly
    assert tm._reads_jitter_policy() and tm._capturable()


def test_diversify_keeps_member_zero_and_the_original():
    x, y, *_ = _data()
    tm = GPEnsemble(x, y, kernels.Rbf(D, ARD=True), device="cpu")
    before = {k: v.detach().clone() for k, v in get_trainable(tm).items()}
    out = tm.diversify(torch.Generator().manual_seed(0), scale=0.5)
    after = get_trainable(out)
    for k, v in before.items():
        np.testing.assert_array_equal(get_trainable(tm)[k].detach().numpy(), v.numpy())
        np.testing.assert_array_equal(after[k].detach()[0].numpy(), v[0].numpy())
        assert (after[k].detach()[1:] != v[1:]).all()
    again = tm.diversify(torch.Generator().manual_seed(0), scale=0.5)
    for k in before:
        np.testing.assert_array_equal(get_trainable(again)[k].detach().numpy(), after[k].detach().numpy())


def test_rejects():
    x, y, *_ = _data()
    with pytest.raises(ValueError, match="batched data"):
        GPEnsemble(x[0], y[0], kernels.Rbf(D), device="cpu")
    with pytest.raises(ValueError, match="dense path"):
        GPEnsemble(x, y, kernels.Rbf(D), solver="iterative", device="cpu")
    tm = GPEnsemble(x, y, kernels.Rbf(D), device="cpu")
    with pytest.raises(ValueError, match="constructor data"):
        tm._loss(x=torch.as_tensor(x))
    with pytest.raises(ValueError, match="query points"):
        tm.predict_f(np.zeros((2, 2, D)))
