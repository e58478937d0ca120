"""The port's exact-GP serving extensions against the JAX package, float64
on the CPU: random Fourier features (``sampling.RandomFourierFeatures``),
``condition_on`` on the exact posterior and its serving twin, the
fixed-capacity ``FantasyGPRChain``, and ``sample_paths`` on both.

Tolerance rel 1e-9 (moments, factors, paths) unless a test says otherwise.
Random draws differ between torch and JAX for the same seed, so the draws
are held fixed: the port draws every normal and uniform through
``sampling.standard_normal`` / ``sampling.uniform``, which the tests replace
by the JAX package's draws for its key (ω, b, W, ε), and the Matérn
χ²_{2ν} variable u, which the port forms as a sum of 2ν squared normals,
is handed over as the normals (√u, 0, ..., 0).  The generator path is held
by its properties and moments.

Deliberate differences from the JAX package, each covered below:
``FantasyGPRChain.observe`` writes into its buffers in place and returns
the chain itself (the JAX chain is an immutable pytree, so an old handle
keeps the old state), and a batch past the capacity always raises
``ValueError`` (under jit the JAX package cannot check and clamps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.sampling import RandomFourierFeatures as JaxRFF
from gptorch_tpu_torch import convert, kernels, likelihoods, sampling
from gptorch_tpu_torch.models import GPR, FantasyGPRChain
from gptorch_tpu_torch.sampling import RandomFourierFeatures

RTOL = 1e-9
N, D = 40, 2
XS = np.random.RandomState(4).randn(6, D)
NU = {"rbf": None, "matern12": 0.5, "matern32": 1.5, "matern52": 2.5}
KERNELS = {
    "rbf": lambda k: k.Rbf(D, ARD=True, length_scales=[0.8, 1.3], variance=1.2),
    "matern12": lambda k: k.Matern12(D, length_scales=0.9),
    "matern32": lambda k: k.Matern32(D, ARD=True, length_scales=[1.1, 0.7]),
    "matern52": lambda k: k.Matern52(D, variance=0.8),
}


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _batches(count=3, nb=2, dy=1, seed=9):
    rng = np.random.RandomState(seed)
    return [(rng.randn(nb, D), rng.randn(nb, dy)) for _ in range(count)]


def _pair(kind="rbf", dy=1, fixed_noise=False):
    rng = np.random.RandomState(0)
    x = rng.randn(N, D)
    y = np.sin(x[:, :1] * np.arange(1, dy + 1)) + 0.1 * rng.randn(N, dy)
    if fixed_noise:
        s = 0.01 + 0.05 * rng.rand(N)
        jl, tl = jax_likelihoods.FixedNoiseGaussian(s, 0.02), likelihoods.FixedNoiseGaussian(s, 0.02)
    else:
        jl, tl = jax_likelihoods.Gaussian(0.05), likelihoods.Gaussian(0.05)
    jm = JaxGPR(x, y, KERNELS[kind](jax_kernels), likelihood=jl)
    tm = GPR(x, y, KERNELS[kind](kernels), likelihood=tl, device="cpu")
    convert.load_trainable(tm, {k: np.asarray(v) for k, v in jax_get_trainable(jm).items()})
    return jm, tm


# the JAX package's posteriors are pytrees: compiled calls keep its side fast
_jpredict = jax.jit(lambda post, x: post._predict(x, diag=True))
_jcondition = jax.jit(lambda post, x, y: post.condition_on(x, y))
_jobserve = jax.jit(lambda chain, x, y: chain.observe(x, y))


def _jpaths(post, S, F, key, grad=False):
    """The JAX posterior's paths at XS, or the gradient of Σ tanh(paths)."""
    def paths(post, key, x):
        return post.sample_paths(S, F, key=key)(x)

    fn = jax.grad(lambda p, k, xx: jnp.sum(jnp.tanh(paths(p, k, xx))), argnums=2) if grad else paths
    return jax.jit(fn)(post, key, jnp.asarray(XS))


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=RTOL, atol=1e-12)


def _rff_draws(key, d, F, nu):
    """The JAX package's draws for RandomFourierFeatures(key), in the
    port's order: ω's normals, the χ² normals (√u, 0, ...), the phase's
    uniforms."""
    k1, k2, k3 = jax.random.split(key, 3)
    draws = [("normal", np.asarray(jax.random.normal(k1, (d, F), jnp.float64)))]
    if nu is not None:
        df = int(2 * nu)
        u = np.asarray(2.0 * jax.random.gamma(k3, df / 2.0, (F,), jnp.float64))
        z = np.zeros((F, df))
        z[:, 0] = np.sqrt(u)
        draws.append(("normal", z))
    draws.append(("uniform", np.asarray(jax.random.uniform(k2, (F,), jnp.float64))))
    return draws


def _path_draws(key, d, F, nu, S, n, dy):
    k_feat, k_w, k_eps = jax.random.split(key, 3)
    return _rff_draws(k_feat, d, F, nu) + [
        ("normal", np.asarray(jax.random.normal(k_w, (S, F, dy), jnp.float64))),
        ("normal", np.asarray(jax.random.normal(k_eps, (S, n, dy), jnp.float64))),
    ]


@pytest.fixture
def fixed_draws(monkeypatch):
    """Replace the port's draws by a queue of given arrays (kind, array)."""
    queue = []

    def take(kind):
        def draw(generator, shape, like):
            got_kind, arr = queue.pop(0)
            assert got_kind == kind and arr.shape == tuple(shape), (kind, shape, got_kind, arr.shape)
            return torch.tensor(arr, dtype=like.dtype)
        return draw

    monkeypatch.setattr(sampling, "standard_normal", take("normal"))
    monkeypatch.setattr(sampling, "uniform", take("uniform"))
    yield queue
    assert not queue, "draws left over"


@pytest.mark.parametrize("kind", list(KERNELS))
def test_rff_matches_jax_on_the_same_draws(fixed_draws, kind):
    F, key = 64, jax.random.PRNGKey(5)
    jk, tk = KERNELS[kind](jax_kernels), KERNELS[kind](kernels)
    convert.load_trainable(tk, {k: np.asarray(v) for k, v in jax_get_trainable(jk).items()})
    fixed_draws.extend(_rff_draws(key, D, F, NU[kind]))
    jphi, tphi = JaxRFF(jk, F, key), RandomFourierFeatures(tk, F, torch.Generator())
    _close((tphi.omega, tphi.phase), (jphi.omega, jphi.phase))
    x = torch.tensor(XS, requires_grad=True)
    out = tphi(x)
    np.testing.assert_allclose(out.detach(), jphi(jnp.asarray(XS)), rtol=RTOL, atol=1e-12)
    want = jax.grad(lambda xx: jnp.sum(jnp.sin(jphi(xx))))(jnp.asarray(XS))
    torch.sum(torch.sin(out)).backward()
    np.testing.assert_allclose(x.grad, want, rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("kind", list(KERNELS))
def test_rff_approximates_the_kernel(kind):
    """E[φ(x)ᵀφ(x')] = k(x, x'): with F = 40000 features drawn from a
    torch.Generator, within 5 standard errors (each feature's product is
    bounded by 2σ²/F, so the error's sd is below 2σ²/√F·0.71)."""
    F = 40000
    tk = KERNELS[kind](kernels)
    phi = RandomFourierFeatures(tk, F, torch.Generator().manual_seed(0))
    x = torch.tensor(XS)
    with torch.no_grad():
        err = float((phi(x) @ phi(x).T - tk.K(x)).abs().max())
        var = float(tk.variance.value)
    assert err <= 5 * 2 * var * 0.71 / np.sqrt(F)


def test_rff_rejects_other_kernels():
    with pytest.raises(TypeError, match="supports Rbf, the Matérn family and SpectralMixture; got Linear"):
        RandomFourierFeatures(kernels.Linear(D), 8, torch.Generator())


def test_rff_draws_come_from_the_generator():
    tk = KERNELS["matern32"](kernels)
    a, b = (RandomFourierFeatures(tk, 16, torch.Generator().manual_seed(s)) for s in (1, 1))
    c = RandomFourierFeatures(tk, 16, torch.Generator().manual_seed(2))
    assert torch.equal(a.omega, b.omega) and torch.equal(a.phase, b.phase)
    assert not torch.equal(a.omega, c.omega)


@pytest.mark.parametrize("serving, dy", [(False, 1), (True, 2)], ids=["GPRPosterior", "ServingGPRPosterior"])
def test_condition_on_chained_matches_jax(serving, dy):
    """Three chained condition_on steps of two points each: the moments at
    XS after every step, and the grown factors."""
    jm, tm = _pair(dy=dy)
    jp, tp = jm.posterior(), tm.posterior()
    if serving:
        jp, tp = jp.for_serving(), tp.for_serving()
    for xb, yb in _batches(dy=dy):
        jp, tp = _jcondition(jp, xb, yb), tp.condition_on(xb, yb)
        _close(tp.predict_f(XS), _jpredict(jp, XS))
    _close((tp.X,), (jp.X,))
    if serving:
        _close((tp.Linv, tp.alpha), (jp.Linv, jp.alpha))
    else:
        _close((tp.L, tp.V), (jp.L, jp.V))
    assert tp.X.shape[0] == N + 6


@pytest.mark.parametrize("serving", [False, True], ids=["GPRPosterior", "ServingGPRPosterior"])
def test_condition_on_with_fixed_noise_matches_jax(serving):
    """A FixedNoiseGaussian model: the fantasy rows carry only the learned
    σ², so the augmented likelihood's known variances end in zeros."""
    jm, tm = _pair(fixed_noise=True)
    jp, tp = jm.posterior(), tm.posterior()
    if serving:
        jp, tp = jp.for_serving(), tp.for_serving()
    for xb, yb in _batches(count=2):
        jp, tp = _jcondition(jp, xb, yb), tp.condition_on(xb, yb)
        _close(tp.predict_f(XS), _jpredict(jp, XS))
    _close(tp.predict_y(XS), jp.predict_y(XS))
    _close((tp.likelihood.fixed,), (jp.likelihood.fixed,))
    assert torch.equal(tp.likelihood.fixed[N:], torch.zeros(4))
    assert tm.likelihood.fixed.shape == (N,)  # the model's own is unchanged


def test_condition_on_agrees_between_posterior_and_serving():
    _, tm = _pair()
    p = tm.posterior()
    s = p.for_serving()
    for xb, yb in _batches():
        p, s = p.condition_on(xb, yb), s.condition_on(xb, yb)
    _close(s.predict_f(XS), p.predict_f(XS))


def test_fantasy_chain_matches_jax():
    """Three observes of two points into a chain of capacity N + 8: the
    chain's moments after every step, then its materialized posterior, its
    buffers (the identity still on the unused diagonal) against the JAX
    chain's and the chain against condition_on."""
    jm, tm = _pair()
    jc, tc = jm.posterior().fantasy_chain(N + 8), tm.posterior().fantasy_chain(N + 8)
    assert isinstance(tc, FantasyGPRChain) and tc.capacity == N + 8 and tc.count == N
    tp = tm.posterior()
    for xb, yb in _batches():
        jc = _jobserve(jc, xb, yb)
        assert tc.observe(xb, yb) is tc  # in place (deliberate difference)
        tp = tp.condition_on(xb, yb)
        _close(tc.predict_f(XS), _jpredict(jc, XS))
        _close(tc.predict_f(XS), tp.predict_f(XS))
    assert tc.count == N + 6 and int(jc.count) == N + 6
    _close((tc.Lbuf, tc.Vbuf, tc.Xbuf), (jc.Lbuf, jc.Vbuf, jc.Xbuf))
    assert torch.equal(tc.Lbuf.diagonal()[N + 6:], torch.ones(2))
    post, jpost = tc.posterior(), jc.posterior()
    _close(post.predict_f(XS), jpost.predict_f(XS))
    _close((post.L, post.V, post.X), (tp.L, tp.V, tp.X))


def test_fantasy_chain_capacity_and_likelihood():
    """Past the capacity observe raises ValueError, every time (deliberate
    difference: under jit the JAX package clamps), and leaves the chain as
    it was; a FixedNoiseGaussian chain is refused, as in the JAX package."""
    _, tm = _pair()
    chain = tm.posterior().fantasy_chain(N + 3)
    (xb, yb), (xc, yc) = _batches(count=2)
    chain.observe(xb, yb)
    before = chain.Lbuf.clone()
    with pytest.raises(ValueError, match="capacity"):
        chain.observe(xc, yc)
    assert chain.count == N + 2 and torch.equal(chain.Lbuf, before)
    chain.observe(xc[:1], yc[:1])
    assert chain.count == N + 3
    with pytest.raises(ValueError, match="capacity"):
        chain.observe(xc[:1], yc[:1])
    with pytest.raises(ValueError, match="capacity"):
        tm.posterior().fantasy_chain(N - 1)
    _, fm = _pair(fixed_noise=True)
    with pytest.raises(NotImplementedError):
        fm.posterior().fantasy_chain(N + 2)


@pytest.mark.parametrize("serving, kind, dy", [(False, "rbf", 1), (True, "matern32", 2)],
                         ids=["GPRPosterior", "ServingGPRPosterior"])
def test_sample_paths_match_jax_on_the_same_draws(fixed_draws, serving, kind, dy):
    """Paths on the JAX package's draws for its key: values at XS and, for
    the first case (both posteriors share the path function), their
    gradient in x."""
    S, F, key = 3, 32, jax.random.PRNGKey(11)
    jm, tm = _pair(kind, dy=dy)
    jp, tp = jm.posterior(), tm.posterior()
    if serving:
        jp, tp = jp.for_serving(), tp.for_serving()
    fixed_draws.extend(_path_draws(key, D, F, NU[kind], S, N, dy))
    tpaths = tp.sample_paths(S, F, generator=torch.Generator())
    np.testing.assert_allclose(tpaths(XS), _jpaths(jp, S, F, key), rtol=RTOL, atol=1e-12)
    if not serving:
        x = torch.tensor(XS, requires_grad=True)
        torch.sum(torch.tanh(tpaths(x))).backward()
        np.testing.assert_allclose(x.grad, _jpaths(jp, S, F, key, grad=True), rtol=RTOL, atol=1e-12)


def test_sample_paths_with_fixed_noise_match_jax(fixed_draws):
    """The Matheron update resamples each training row's own noise."""
    S, F, key = 2, 16, jax.random.PRNGKey(2)
    jm, tm = _pair(fixed_noise=True)
    fixed_draws.extend(_path_draws(key, D, F, None, S, N, 1))
    want = _jpaths(jm.posterior(), S, F, key)
    np.testing.assert_allclose(tm.posterior().sample_paths(S, F, generator=torch.Generator())(XS), want,
                               rtol=RTOL, atol=1e-12)


def test_sample_paths_from_a_generator():
    """The same seed gives the same paths, on both posteriors (their
    algebra agrees); the paths' mean over many draws is the posterior mean
    (the Matheron update makes it unbiased for any features), within 5
    standard errors."""
    _, tm = _pair()
    post = tm.posterior()
    serving = post.for_serving()
    a = post.sample_paths(4, 64, generator=torch.Generator().manual_seed(3))(XS)
    b = post.sample_paths(4, 64, generator=torch.Generator().manual_seed(3))(XS)
    c = serving.sample_paths(4, 64, generator=torch.Generator().manual_seed(3))(XS)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(c, a, rtol=RTOL, atol=1e-12)
    assert not np.allclose(a[0], a[1])
    S = 4000
    draws = post.sample_paths(S, 256, generator=torch.Generator().manual_seed(0))(XS)[..., 0]
    mean, var = post.predict_f(XS)
    assert np.all(np.abs(draws.mean(0) - mean[:, 0]) <= 5 * np.sqrt(var[:, 0] / S))
