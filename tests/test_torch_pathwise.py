"""The port's pathwise samplers (gptorch_tpu_torch.sampling.
pathwise_svgp_samples and pathwise_gpr_samples) against the JAX package,
float64 on the CPU, data from numpy seeds (n = 40, d = 2, m = 8), the
draws held fixed: the port's standard normals and uniforms return the JAX
package's draws (the features' frequencies and phases, the prior weights,
then ζ or ε) in the order the port draws them.

* SVGP with a constant mean: 1e-10 of the largest sample; a whitened q
  that holds the same distribution draws the same samples (1e-10).
* GPR with the dense solver: 1e-10; with the iterative solver (CG to
  1e-12, both packages): 1e-8.
* The moments of 4000 draws against predict_f (n* = 6): within 5
  standard errors, with the RFF prior's own error (F = 4096) inside.
* numpy in gives numpy out; a tensor in, a tensor out.
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
from gptorch_tpu import sampling as jax_sampling
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.models import SVGP as JaxSVGP
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu_torch import convert, kernels, likelihoods, mean_functions, sampling
from gptorch_tpu_torch.models import GPR, SVGP

N, D, M, S, F = 40, 2, 8, 3, 64
RTOL = 1e-10
ITERATIVE = dict(solver="iterative", probes=4, max_cg_iters=200, precond_rank=8, cg_tol=1e-12)


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data():
    rng = np.random.RandomState(0)
    x = rng.randn(N, D)
    y = np.sin(x[:, :1]) * np.cos(x[:, 1:]) + 0.1 * rng.randn(N, 1)
    return x, y, x[:M].copy(), rng.randn(6, D)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _port(case, values=None):
    """The port's model of ``case``, loaded with ``values`` (default: the JAX
    model's spread trainables)."""
    x, y, z, _ = _data()
    lik = likelihoods.Gaussian(0.1)
    if case == "svgp":
        m = SVGP(x, y, kernels.Rbf(D, ARD=True), inducing_points=z, likelihood=lik,
                 mean_function=mean_functions.Constant(1), device="cpu")
    else:
        m = GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=lik, device="cpu",
                **(ITERATIVE if case == "gpr_iterative" else {}))
    convert.load_trainable(m, values if values is not None else _jax(case)[0])
    return m


@functools.lru_cache(maxsize=None)
def _jax(case):
    """The JAX model's trainables spread from its start, its samples at the
    queries and the draws behind them, in the port's order: normals [ω, W,
    ζ or ε] and uniforms [the phases]."""
    x, y, z, xs = _data()
    lik = jax_likelihoods.Gaussian(0.1)
    if case == "svgp":
        jm = JaxSVGP(x, y, jax_kernels.Rbf(D, ARD=True), inducing_points=z, likelihood=lik,
                     mean_function=jax_means.Constant(1))
    else:
        jm = JaxGPR(x, y, jax_kernels.Rbf(D, ARD=True), likelihood=lik, **(ITERATIVE if case == "gpr_iterative" else {}))
    rng = np.random.RandomState(1)
    values = {k: np.asarray(v) + 0.1 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jm).items()}
    jm = jax_with_trainable(jm, values)
    key = jax.random.PRNGKey(7)
    sampler = jax_sampling.pathwise_svgp_samples if case == "svgp" else jax_sampling.pathwise_gpr_samples
    out = np.asarray(jax.jit(lambda m: sampler(m, jnp.asarray(xs), S, F, key))(jm))
    k_feat, k_w, k_last = jax.random.split(key, 3)
    k1, k2, _ = jax.random.split(k_feat, 3)
    last = (S, M if case == "svgp" else N, 1)
    normals = [jax.random.normal(k1, (D, F), jnp.float64), jax.random.normal(k_w, (S, F, 1), jnp.float64),
               jax.random.normal(k_last, last, jnp.float64)]
    uniforms = [jax.random.uniform(k2, (F,), jnp.float64)]
    return values, out, [np.asarray(a) for a in normals], [np.asarray(a) for a in uniforms]


def _held(monkeypatch, normals, uniforms):
    n, u = iter(normals), iter(uniforms)
    monkeypatch.setattr(sampling, "standard_normal", lambda gen, shape, like: torch.tensor(next(n)))
    monkeypatch.setattr(sampling, "uniform", lambda gen, shape, like: torch.tensor(next(u)))


@pytest.mark.parametrize("case, rtol", [("svgp", RTOL), ("gpr", RTOL), ("gpr_iterative", 1e-8)])
def test_samples_match_jax_with_the_draws_held(monkeypatch, case, rtol):
    _, _, _, xs = _data()
    m = _port(case)
    _, want, normals, uniforms = _jax(case)
    _held(monkeypatch, normals, uniforms)
    sampler = sampling.pathwise_svgp_samples if case == "svgp" else sampling.pathwise_gpr_samples
    got = sampler(m, xs, S, F, generator=torch.Generator())
    assert isinstance(got, np.ndarray) and got.shape == (S, 6, 1)
    _close(got, want, rtol)


@pytest.mark.parametrize("case", ["svgp", "gpr"])
def test_moments_match_predict_f(case):
    _, _, _, xs = _data()
    m = _port(case)
    sampler = sampling.pathwise_svgp_samples if case == "svgp" else sampling.pathwise_gpr_samples
    draws = sampler(m, torch.as_tensor(xs), 4000, 4096, generator=torch.Generator().manual_seed(2))
    assert isinstance(draws, torch.Tensor)
    draws = draws.detach().numpy()
    mean, var = m.predict_f(xs)
    s = draws.shape[0]
    assert np.all(np.abs(draws.mean(0) - mean) <= 5 * np.sqrt(var / s) + 0.02)
    assert np.all(np.abs(draws.var(0) - var) <= 5 * var * np.sqrt(2.0 / (s - 1)) + 0.02)


def test_whitened_q_is_mapped_back():
    x, y, z, xs = _data()
    plain, white = (SVGP(x, y, kernels.Rbf(D, ARD=True), inducing_points=z, likelihood=likelihoods.Gaussian(0.1),
                         whiten=w, device="cpu") for w in (False, True))  # both start from one distribution
    a, b = (sampling.pathwise_svgp_samples(m, xs, S, F, generator=torch.Generator().manual_seed(4))
            for m in (plain, white))
    _close(b, a)


def test_same_generator_seed_same_paths():
    _, _, _, xs = _data()
    m = _port("svgp")
    a = sampling.pathwise_svgp_samples(m, xs, 2, 32, generator=torch.Generator().manual_seed(3))
    b = sampling.pathwise_svgp_samples(m, xs, 2, 32, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a, b)
