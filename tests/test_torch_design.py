"""The port's experimental design (gptorch_tpu_torch.design) against the
JAX package, float64 on the CPU, on the cached posterior of one GPR built
in both packages from numpy seeds (n = 40, d = 2, Rbf-ARD; the JAX
package's own checks at n = 60, d = 1).

* variance and entropy scores equal the JAX package's on the same
  candidates (1e-12 relative), ALC's on the same candidates and
  references to 1e-10 (its covariances k(r, x) − A_rᵀA_x cancel to about
  1e-4 of their terms, so their rounding reads ~1e-12 relative), numpy or
  tensor in;
* the greedy batch (variance, entropy, alc; the default reference set and
  an explicit one) picks the same indices, returned as numpy, and its
  conditioned posterior predicts as the JAX package's (1e-10);
* as the JAX package's tests/test_design.py: ALC equals the variance drop
  over the references that condition_on realizes (1e-6); a far candidate
  wins on variance and loses on ALC; greedy picks spread out; an unknown
  strategy raises.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from gptorch_tpu import design as jax_design
from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.models.posterior import GPRPosterior as JaxGPRPosterior
from gptorch_tpu_torch import design, kernels, likelihoods
from gptorch_tpu_torch.models import GPR

REL = 1e-12


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data(d):
    rng = np.random.RandomState(0)
    n = 60 if d == 1 else 40
    x = rng.rand(n, d)
    y = np.sin(6 * x[:, :1]) + 0.1 * rng.randn(n, 1)
    return x, y, rng.rand(25, d), rng.rand(15, d)


@functools.lru_cache(maxsize=None)
def _jax_post(d):
    x, y, _, _ = _data(d)
    ls = [0.2] * d
    model = JaxGPR(x, y, jax_kernels.Rbf(d, ARD=True, length_scales=ls), likelihood=jax_likelihoods.Gaussian(0.01),
                   fast=False)
    return jax.jit(lambda m: m.posterior())(model)


def _post(d):
    x, y, _, _ = _data(d)
    m = GPR(x, y, kernels.Rbf(d, ARD=True, length_scales=[0.2] * d), likelihood=likelihoods.Gaussian(0.01),
            fast=False, device="cpu")
    return m.posterior()


@pytest.fixture
def compiled_jax(monkeypatch):
    """The JAX package's acquisitions and posterior methods under
    ``jax.jit``: the same computations, compiled as one program per shape
    instead of op by op (which costs seconds per new shape on the CPU)."""
    jitted = {name: jax.jit(fn) for name, fn in jax_design.ACQUISITIONS.items()}
    monkeypatch.setattr(jax_design, "ACQUISITIONS", jitted)
    monkeypatch.setattr(jax_design, "alc_acquisition", jitted["alc"])
    monkeypatch.setattr(JaxGPRPosterior, "predict_f", jax.jit(JaxGPRPosterior.predict_f, static_argnames="diag"))
    monkeypatch.setattr(JaxGPRPosterior, "condition_on", jax.jit(JaxGPRPosterior.condition_on))


def _close(got, want, rel=REL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rel, atol=0)


@pytest.mark.parametrize("name", ["variance", "entropy", "alc"])
def test_scores_match_jax(compiled_jax, name, d=2):
    _, _, cand, ref = _data(d)
    args = (cand, ref) if name == "alc" else (cand,)
    got = design.ACQUISITIONS[name](_post(d), *args)
    assert isinstance(got, torch.Tensor) and got.shape == (25,)
    _close(got, jax_design.ACQUISITIONS[name](_jax_post(d), *args), rel=1e-10 if name == "alc" else REL)
    as_tensor = design.ACQUISITIONS[name](_post(d), *(torch.as_tensor(a) for a in args))
    _close(as_tensor, got)


@pytest.mark.parametrize("strategy, explicit_ref", [("variance", False), ("entropy", False), ("alc", False),
                                                    ("alc", True)])
def test_greedy_batch_matches_jax(compiled_jax, strategy, explicit_ref, d=2):
    _, _, cand, ref = _data(d)
    kw = {"x_ref": ref} if explicit_ref else {}
    idx, post = design.suggest_batch(_post(d), cand, q=4, strategy=strategy, **kw)
    jidx, jpost = jax_design.suggest_batch(_jax_post(d), cand, q=4, strategy=strategy, **kw)
    assert isinstance(idx, np.ndarray)
    np.testing.assert_array_equal(idx, np.asarray(jidx))
    xq = np.random.RandomState(3).rand(7, d)
    for got, want in zip(post.predict_f(xq), jpost.predict_f(xq)):
        _close(got, want, rel=1e-10)


def test_alc_matches_brute_force_conditioning():
    post = _post(1)
    rng = np.random.RandomState(1)
    x_ref, x_cand = rng.rand(15, 1), rng.rand(6, 1)
    scores = design.alc_acquisition(post, x_cand, x_ref).numpy()
    _, var0 = post.predict_f(x_ref)
    for j in range(6):
        p2 = post.condition_on(x_cand[j : j + 1], np.zeros((1, 1)))
        realized = float(np.sum(var0[:, 0] - p2.predict_f(x_ref)[1][:, 0]))
        assert realized == pytest.approx(float(scores[j]), rel=1e-6), j


def test_variance_vs_alc_far_candidate():
    post = _post(1)
    rng = np.random.RandomState(2)
    x_cand = np.vstack([rng.rand(10, 1), [[5.0]]])  # the last one far away
    x_ref = rng.rand(20, 1)
    assert int(torch.argmax(design.variance_acquisition(post, x_cand))) == 10
    assert int(torch.argmax(design.alc_acquisition(post, x_cand, x_ref))) != 10
    assert int(torch.argmax(design.entropy_acquisition(post, x_cand))) == 10


def test_greedy_batch_spreads_and_reduces_variance():
    post = _post(1)
    x_cand = np.linspace(0, 1, 50)[:, None]
    idx, p2 = design.suggest_batch(post, x_cand, q=5, strategy="variance")
    assert len(set(idx.tolist())) == 5
    assert np.min(np.diff(np.sort(x_cand[idx, 0]))) > 0.02
    assert p2.predict_f(x_cand)[1].sum() < post.predict_f(x_cand)[1].sum()
    with pytest.raises(ValueError, match="strategy"):
        design.suggest_batch(post, x_cand, q=1, strategy="nope")
