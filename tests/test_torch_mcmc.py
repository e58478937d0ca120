"""The port's MCMC (gptorch_tpu_torch.mcmc) against the JAX package,
float64 on the CPU.

Where the two must agree draw for draw, the port's uniforms and normals
return the JAX package's draws, derived from the same keys as the JAX
package derives them, in the order the port draws them (the module
docstring lists it):

* sample_posterior with HMC (2 chains, 10 + 10 transitions of 8 leapfrogs)
  and NUTS (2 chains, 10 + 10) on the JAX tests' GPR with LogNormal priors
  (n = 40): samples, accept probabilities, divergences, tree depths,
  adapted step sizes and inverse masses to 1e-8;
* nuts on an anisotropic Gaussian at max_depth = 4 (one chain, 20 + 20, no
  mass adaptation: most trees reach depth 4): the same to 1e-8;
* elliptical_slice (one chain, n = 12, 2 columns, 20 + 20): draws to 1e-8.

Elsewhere the two packages run on the same inputs: log_posterior_fn with
and without the Jacobian (value and gradient, 1e-10), predict_mixture and
predict_latent_mixture on the same draws (1e-10), R-hat and ESS on the same
arrays (1e-12), and the validation errors.  The port alone: two chains
batched equal each chain run alone (HMC and NUTS, the draws held), the
bit helpers against Python for every leaf index below 2^15, the unravel
round trip, and the JAX tests' statistical assertions at sizes that take
seconds here (the full sizes run on the card, tests/test_torch_cuda.py).
Each JAX reference is compiled once per module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu import mcmc as jax_mcmc
from gptorch_tpu import priors as jax_priors
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.models import LaplaceGP as JaxLaplaceGP
from gptorch_tpu.param import positive_param as jax_positive_param
from gptorch_tpu_torch import kernels, likelihoods, mcmc, priors, sampling
from gptorch_tpu_torch.models import GPR, LaplaceGP
from gptorch_tpu_torch.module import Module, get_trainable
from gptorch_tpu_torch.param import positive_param

DRAW = 1e-8
EXACT = 1e-10
F64 = jnp.float64


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture
def fed(monkeypatch):
    """Replace the port's draws by ``source(kind, shape) -> array``, called
    in the order the port draws."""

    def install(source):
        def take(kind):
            def draw(generator, shape, like):
                arr = np.asarray(source(kind, tuple(shape)), dtype=np.float64)
                assert arr.shape == tuple(shape), (kind, tuple(shape), arr.shape)
                return torch.tensor(arr, dtype=like.dtype, device=like.device)

            return draw

        monkeypatch.setattr(sampling, "standard_normal", take("normal"))
        monkeypatch.setattr(sampling, "uniform", take("uniform"))

    return install


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# -- the JAX package's draws, in the port's order ---------------------------------------


def _phase_keys(key, num_warmup, num_samples, adapt_mass=True):
    """Each transition's key of one chain, as hmc / nuts split them."""
    key_a, key_b, key_s = jax.random.split(key, 3)
    na = num_warmup // 2 if adapt_mass else num_warmup
    phases = [(key_a, na)] + ([(key_b, num_warmup - na)] if adapt_mass else []) + [(key_s, num_samples)]
    return [k for phase_key, n in phases for k in np.asarray(jax.random.split(phase_key, n))]


@functools.partial(jax.jit, static_argnums=1)
def _hmc_transition_draws(key, dim):
    key_mom, key_acc, key_jit = jax.random.split(key, 3)
    return (jax.random.uniform(key_jit, dtype=F64), jax.random.normal(key_mom, (dim,), F64),
            jax.random.uniform(key_acc, dtype=F64))


_split2, _split4 = jax.jit(jax.random.split), jax.jit(lambda k: jax.random.split(k, 4))
_uniform = jax.jit(lambda k: jax.random.uniform(k, dtype=F64))
_bernoulli = jax.jit(jax.random.bernoulli)
_normal = jax.jit(lambda k, shape: jax.random.normal(k, shape, F64), static_argnums=1)


@functools.partial(jax.jit, static_argnums=1)
def _chained_uniforms(key, count):
    """``count`` uniforms of ``key, sub = split(key)`` in turn: the subtree's
    leaves and the slice's shrinks; returns (key, uniforms)."""

    def body(k, _):
        k, sub = jax.random.split(k)
        return k, jax.random.uniform(sub, dtype=F64)

    return lax.scan(body, key, None, length=count)


class _Queue:
    """A fixed sequence of (kind, array) draws."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, kind, shape):
        got, arr = self.draws.pop(0)
        assert got == kind, (got, kind, shape)
        return arr


def _hmc_draws(chain_keys, num_warmup, num_samples, dim, offsets=None):
    """Per transition the jitter, momentum and accept draws of every chain
    (stacked on the chain axis), after the chains' start offsets."""
    per_chain = [[_hmc_transition_draws(k, dim) for k in _phase_keys(key, num_warmup, num_samples)]
                 for key in chain_keys]
    draws = [] if offsets is None else [("normal", offsets)]
    for t in range(len(per_chain[0])):
        jit_u, mom, acc_u = (np.stack([np.asarray(chain[t][j]) for chain in per_chain]) for j in range(3))
        draws += [("uniform", jit_u), ("normal", mom), ("uniform", acc_u)]
    return _Queue(draws)


#: The leaf uniforms drawn at a time for a doubling (depths up to 6 here).
MAX_LEAVES = 64


class _NutsChain:
    """One chain's NUTS draws, as _nuts_transition and _nuts_subtree split
    the keys: the momentum per transition; per doubling the direction (a
    uniform below 0.5 for right), the biased-progressive uniform and the
    leaf uniforms."""

    def __init__(self, keys, dim):
        self.keys, self.dim = iter(keys), dim

    def momentum(self):
        key_mom, self.loop = _split2(next(self.keys))
        return np.asarray(_normal(key_mom, (self.dim,)))

    def direction(self):
        self.loop, kd, self.ks, self.kb = _split4(self.loop)
        return 0.25 if bool(_bernoulli(kd)) else 0.75

    def bias(self):
        return float(_uniform(self.kb))

    def leaves(self, count):
        assert count <= MAX_LEAVES
        return np.asarray(_chained_uniforms(self.ks, MAX_LEAVES)[1])[:count]  # one compile for every depth


class _NutsDraws:
    def __init__(self, chains):
        self.chains, self.stage = chains, None

    def __call__(self, kind, shape):
        if kind == "normal":
            self.stage = "direction"
            return np.stack([c.momentum() for c in self.chains])
        if self.stage == "direction":
            self.stage = "bias"
            return np.array([c.direction() for c in self.chains])
        if self.stage == "bias":
            self.stage = "leaves"
            return np.array([c.bias() for c in self.chains])
        self.stage = "direction"
        return np.stack([c.leaves(shape[0]) for c in self.chains], axis=1)


class _SliceDraws:
    """elliptical_slice's draws: per transition ξ, the slice and first-angle
    uniforms, then the shrinks' uniforms a chunk at a time."""

    def __init__(self, key, transitions, shape):
        self.keys, self.shape, self.stage = iter(np.asarray(jax.random.split(key, transitions))), shape, None

    def __call__(self, kind, shape):
        if kind == "normal":
            k_nu, self.k_u, self.k_th, self.k_loop = _split4(next(self.keys))
            self.stage = "u"
            return np.asarray(_normal(k_nu, self.shape))
        if self.stage == "u":
            self.stage = "theta"
            return float(_uniform(self.k_u))
        if self.stage == "theta":
            self.stage = "shrinks"
            return float(_uniform(self.k_th))
        self.k_loop, u = _chained_uniforms(self.k_loop, shape[0])
        return np.asarray(u)


# -- the models ----------------------------------------------------------------------


def _gpr_data():
    rng = np.random.RandomState(0)
    x = rng.randn(40, 1)
    return x, np.sin(2 * x) + 0.2 * rng.randn(40, 1)


@functools.lru_cache(maxsize=None)
def _jax_gpr():
    x, y = _gpr_data()
    k = jax_kernels.Rbf(1, variance=1.0, length_scales=0.5)
    k.variance = jax_positive_param(1.0, prior=jax_priors.LogNormal(0.0, 1.0))
    k.length_scales = jax_positive_param(0.5, prior=jax_priors.LogNormal(-1.0, 1.0))
    return JaxGPR(x, y, k, likelihood=jax_likelihoods.Gaussian(variance=0.05))


def _gpr(**kw):
    x, y = _gpr_data()
    k = kernels.Rbf(1, variance=1.0, length_scales=0.5)
    k.variance = positive_param(1.0, prior=priors.LogNormal(0.0, 1.0))
    k.length_scales = positive_param(0.5, prior=priors.LogNormal(-1.0, 1.0))
    return GPR(x, y, k, likelihood=likelihoods.Gaussian(variance=0.05), device="cpu", **kw)


CHAINS, WARM, KEEP, LEAPFROG = 2, 10, 10, 8


@functools.lru_cache(maxsize=None)
def _jax_posterior(sampler):
    samples, res = jax_mcmc.sample_posterior(_jax_gpr(), jax.random.PRNGKey(1), num_samples=KEEP, num_warmup=WARM,
                                             num_chains=CHAINS, num_leapfrog=LEAPFROG, sampler=sampler)
    return {k: np.asarray(v) for k, v in samples.items()}, jax.tree_util.tree_map(np.asarray, res)


def _posterior_draws(sampler, dim):
    keys = jax.random.split(jax.random.PRNGKey(1), CHAINS + 1)
    offsets = np.asarray(jax.random.normal(keys[0], (CHAINS, dim), F64))
    if sampler == "hmc":
        return _hmc_draws(keys[1:], WARM, KEEP, dim, offsets)
    chains = _NutsDraws([_NutsChain(_phase_keys(k, WARM, KEEP), dim) for k in keys[1:]])
    first = [True]

    def source(kind, shape):
        if first[0]:
            first[0] = False
            return offsets
        return chains(kind, shape)

    return source


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_sample_posterior_matches_jax_on_its_draws(fed, sampler):
    want_samples, want = _jax_posterior(sampler)
    model = _gpr()
    fed(_posterior_draws(sampler, 3))
    samples, got = mcmc.sample_posterior(model, torch.Generator(), num_samples=KEEP, num_warmup=WARM,
                                         num_chains=CHAINS, num_leapfrog=LEAPFROG, sampler=sampler)
    assert set(samples) == set(want_samples)
    for name, s in samples.items():
        assert s.shape == want_samples[name].shape
        _close(s, want_samples[name], DRAW)
    for field in ("samples", "accept_prob", "step_size", "inv_mass"):
        _close(getattr(got, field), getattr(want, field), DRAW)
    np.testing.assert_array_equal(got.divergent.numpy(), want.divergent)
    if sampler == "nuts":
        np.testing.assert_array_equal(got.tree_depth.numpy(), want.tree_depth)
    else:
        assert got.tree_depth is None


SCALES = np.array([1.0, 30.0])


@functools.lru_cache(maxsize=None)
def _jax_nuts_anisotropic():
    scales = jnp.asarray(SCALES)
    res, _ = jax_mcmc.nuts(lambda x: -0.5 * jnp.sum((x / scales) ** 2), jnp.zeros(2), jax.random.PRNGKey(4),
                           num_samples=20, num_warmup=20, max_depth=4, adapt_mass=False)
    return jax.tree_util.tree_map(np.asarray, res)


def test_nuts_at_max_depth_4_matches_jax_on_its_draws(fed):
    want = _jax_nuts_anisotropic()
    assert (want.tree_depth == 4).sum() > 10  # the trees are truncated: every doubling runs
    fed(_NutsDraws([_NutsChain(_phase_keys(jax.random.PRNGKey(4), 20, 20, adapt_mass=False), 2)]))
    scales = torch.as_tensor(SCALES)
    got, unravel = mcmc.nuts(lambda x: -0.5 * torch.sum((x / scales) ** 2), torch.zeros(2), torch.Generator(),
                             num_samples=20, num_warmup=20, max_depth=4, adapt_mass=False, device="cpu")
    for field in ("samples", "accept_prob", "step_size", "inv_mass"):
        _close(getattr(got, field), getattr(want, field), DRAW)
    np.testing.assert_array_equal(got.tree_depth.numpy(), want.tree_depth)
    np.testing.assert_array_equal(got.divergent.numpy(), want.divergent)
    assert unravel(got.samples[0]).shape == (2,)


def _slice_target():
    rng = np.random.RandomState(3)
    x = np.linspace(-2, 2, 12)[:, None]
    K = np.exp(-0.5 * (x - x.T) ** 2) + 1e-6 * np.eye(12)
    return np.linalg.cholesky(K), (rng.rand(12, 2) > 0.5).astype(float)


@functools.lru_cache(maxsize=None)
def _jax_slice():
    L, y = _slice_target()
    s = 2.0 * jnp.asarray(y) - 1.0
    draws = jax_mcmc.elliptical_slice(lambda f: jnp.sum(jax.nn.log_sigmoid(s * f)), jnp.asarray(L),
                                      jnp.zeros((12, 2)), jax.random.PRNGKey(5), num_samples=20, num_burn=20, thin=1)
    return np.asarray(draws)


def test_elliptical_slice_matches_jax_on_its_draws(fed):
    want = _jax_slice()
    L, y = _slice_target()
    s = torch.as_tensor(2.0 * y - 1.0)
    fed(_SliceDraws(jax.random.PRNGKey(5), 40, (12, 2)))
    got = mcmc.elliptical_slice(lambda f: torch.sum(torch.nn.functional.logsigmoid(s * f)), torch.as_tensor(L),
                                torch.zeros((12, 2)), torch.Generator(), num_samples=20, num_burn=20, device="cpu")
    shrinks = mcmc.elliptical_slice.last_run.shrinks
    assert got.shape == (20, 12, 2) and shrinks.shape == (40,)
    assert int(shrinks.max()) > mcmc.ESS_CHUNK  # a transition ran more than one chunk
    _close(got, want, DRAW)


# -- two chains batched, each alone ----------------------------------------------------------


class _Recorder:
    """Draws from a seeded generator, keeping each; then replays chain
    ``c``'s rows of the recorded draws for that chain run alone (NUTS: a
    transition's doublings past the lone chain's last are skipped)."""

    def __init__(self):
        self.draws, self.gen = [], torch.Generator().manual_seed(11)

    def __call__(self, kind, shape):
        arr = (torch.randn if kind == "normal" else torch.rand)(shape, generator=self.gen, dtype=torch.float64)
        self.draws.append((kind, arr.numpy()))
        return arr.numpy()

    def chain(self, c):
        # the chain axis: the last of NUTS's leaf uniforms (2^d, chains), else the first
        draws = [(kind, np.take(arr, [c], axis=1 if kind == "uniform" and arr.ndim == 2 else 0))
                 for kind, arr in self.draws]
        position = [0]

        def source(kind, shape):
            while True:
                got, arr = draws[position[0]]
                position[0] += 1
                if got == kind and arr.shape == shape:
                    return arr

        return source


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_batched_chains_equal_each_chain_alone(fed, sampler):
    """Two chains as one (chains, dim) state end as each chain run alone on
    its rows of the same draws (frozen NUTS chains wait, unchanged)."""
    rng = np.random.RandomState(0)
    w = torch.tensor([1.0, 0.1, 4.0])  # elementwise, so that a batched evaluation rounds as a lone one
    value_and_grad = mcmc._batched_value_and_grad(lambda x: -0.5 * torch.sum(w * x * x))
    q0 = torch.as_tensor(rng.randn(2, 3))
    recorder = _Recorder()

    def run(q, source):
        fed(source)
        with mcmc._Runner("cpu", torch.Generator(), False) as runner:
            chains = mcmc._Chains(value_and_grad, q, runner, 0.8, max_depth=5)
            return mcmc._run(chains, sampler, 15, 16, 6, 0.3, True)

    both = run(q0, recorder)
    for c in range(2):
        alone = run(q0[c : c + 1], recorder.chain(c))
        for got, want in zip(alone, both):
            if want is not None:
                assert torch.equal(got[0], want[c])


def test_bit_helpers_match_python_below_2_15():
    n = torch.arange(2**15)
    want_pop = [bin(i).count("1") for i in range(2**15)]
    want_trail = [len(bin(i)) - len(bin(i).rstrip("1")) for i in range(2**15)]
    assert mcmc._popcount(n).tolist() == want_pop
    assert mcmc._trailing_ones(n).tolist() == want_trail
    assert int(mcmc._popcount(torch.tensor(7))) == 3 and mcmc._popcount(torch.tensor(7)).shape == ()


# -- the JAX package on the same inputs -----------------------------------------------------


class _PriorOnly(Module):
    """log_likelihood = 0; the posterior IS the prior."""

    def __init__(self, prior):
        super().__init__()
        self.rate = positive_param(1.0, prior=prior)

    def _loss(self):
        return -self.log_prior()




@pytest.mark.parametrize("jacobian", [True, False])
@pytest.mark.parametrize("case", ["gpr", "prior_only"])
def test_log_posterior_fn_matches_jax(case, jacobian):
    rng = np.random.RandomState(7)
    if case == "gpr":
        jmodel, model = _jax_gpr(), _gpr()
    else:
        from gptorch_tpu.module import Module as JaxModule

        class JaxPriorOnly(JaxModule):
            def __init__(self, prior):
                self.rate = jax_positive_param(1.0, prior=prior)

            def _loss(self):
                return -self.log_prior()

        jmodel, model = JaxPriorOnly(jax_priors.LogNormal(-0.5, 0.7)), _PriorOnly(priors.LogNormal(-0.5, 0.7))
    values = {k: np.asarray(v) + 0.3 * rng.randn(*np.shape(v)) for k, v in get_trainable(model).items()
              for v in [v.detach().numpy()]}
    want, want_grad = jax.jit(jax.value_and_grad(jax_mcmc.log_posterior_fn(jmodel, jacobian=jacobian)))(
        {k: jnp.asarray(v) for k, v in values.items()})
    raws = {k: torch.tensor(v, requires_grad=True) for k, v in values.items()}
    got = mcmc.log_posterior_fn(model, jacobian=jacobian)(raws)
    grads = torch.autograd.grad(got, list(raws.values()))
    _close(got.detach(), want, EXACT)
    for k, g in zip(raws, grads):
        _close(g, want_grad[k], EXACT)


def test_predict_mixture_matches_jax(monkeypatch):
    samples, _ = _jax_posterior("hmc")
    xs = np.linspace(-2, 2, 7)[:, None]
    want = jax.jit(lambda s, x: jax_mcmc.predict_mixture(_jax_gpr(), s, x))(samples, xs)
    model = _gpr()
    for chunk in (None, 3):  # one vmap over the 20 draws, or chunks of 3
        if chunk:
            monkeypatch.setattr(mcmc, "_mixture_chunk", lambda model, draws: chunk)
        got = mcmc.predict_mixture(model, {k: torch.tensor(v) for k, v in samples.items()}, xs)
        for g, w in zip(got, want):
            assert g.shape == (7, 1)
            _close(g, w, EXACT)
    got_f = mcmc.predict_mixture(model, samples, xs, y=False)
    want_f = jax.jit(lambda s, x: jax_mcmc.predict_mixture(_jax_gpr(), s, x, y=False))(samples, xs)
    for g, w in zip(got_f, want_f):
        _close(g, w, EXACT)


def _classifier_data():
    x = np.linspace(-2, 2, 30)[:, None]
    return x, (np.sin(2 * x) > 0).astype(float)


def test_latent_prior_chol_and_predict_latent_mixture_match_jax():
    x, y = _classifier_data()
    # a short length scale keeps K's condition number near 1e4: the triangular
    # solves of the two packages then agree to 1e-10
    jmodel = JaxLaplaceGP(x, y, jax_kernels.Rbf(1, length_scales=0.2), jax_likelihoods.Bernoulli())
    model = LaplaceGP(x, y, kernels.Rbf(1, length_scales=0.2), likelihoods.Bernoulli(), device="cpu")
    draws = np.random.RandomState(2).randn(9, 30, 1)
    xs = np.linspace(-1.8, 1.8, 5)[:, None]
    want_L = jax.jit(jax_mcmc.latent_prior_chol)(jmodel)
    L = mcmc.latent_prior_chol(model)
    _close(L, want_L, EXACT)
    want = jax.jit(lambda m, d, x: jax_mcmc.predict_latent_mixture(m, d, x))(jmodel, draws, xs)
    for chol in (None, L):
        got = mcmc.predict_latent_mixture(model, torch.as_tensor(draws), xs, chol=chol)
        for g, w in zip(got, want):
            assert g.shape == (5, 1)
            _close(g, w, EXACT)


def _diagnostic_arrays():
    rng = np.random.RandomState(0)
    good = rng.randn(4, 200)
    iid = np.random.RandomState(1).randn(2, 400)
    walk = np.cumsum(np.random.RandomState(1).randn(2, 400), axis=1) * 0.1 + iid * 0.05
    return {"good": good, "bad": good + np.arange(4)[:, None] * 5.0, "iid": iid, "walk": walk,
            "vector": rng.randn(3, 50, 2), "odd": rng.randn(2, 51)}


@pytest.mark.parametrize("name", sorted(_diagnostic_arrays()))
def test_diagnostics_match_jax(name):
    x = _diagnostic_arrays()[name]
    _close(mcmc.potential_scale_reduction(torch.as_tensor(x)), jax_mcmc.potential_scale_reduction(x), 1e-12)
    _close(mcmc.effective_sample_size(x), jax_mcmc.effective_sample_size(x), 1e-12)


def test_rhat_and_ess_flag_what_jax_flags():
    arrays = _diagnostic_arrays()
    assert float(mcmc.potential_scale_reduction(arrays["good"])) < 1.05
    assert float(mcmc.potential_scale_reduction(arrays["bad"])) > 2.0
    assert float(mcmc.effective_sample_size(arrays["iid"])) > 300.0
    assert float(mcmc.effective_sample_size(torch.as_tensor(arrays["walk"]))) < 100.0


# -- validation, shapes and small statistical checks -----------------------------------


def test_validation_errors():
    logd = lambda t: -0.5 * torch.sum(t**2)  # noqa: E731
    for fn in (mcmc.hmc, mcmc.nuts):
        with pytest.raises(ValueError, match="empty"):
            fn(lambda t: torch.zeros(()), {}, torch.Generator(), device="cpu")
    for depth in (0, 16):
        with pytest.raises(ValueError, match="max_depth"):
            mcmc.nuts(logd, torch.zeros(2), torch.Generator(), max_depth=depth, device="cpu")
    model = _gpr()
    with pytest.raises(ValueError, match="sampler"):
        mcmc.sample_posterior(model, torch.Generator(), sampler="gibbs")
    with pytest.raises(ValueError, match="max_depth"):
        mcmc.sample_posterior(model, torch.Generator(), sampler="nuts", max_depth=0)
    with pytest.raises(ValueError, match="lives on"):
        mcmc.sample_posterior(model, torch.Generator(), device="meta")
    assert sorted(mcmc.__all__) == sorted(jax_mcmc.__all__)
    if not torch.cuda.is_available():  # the entry points run on the card unless told otherwise
        for fn in (mcmc.hmc, mcmc.nuts):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn(logd, torch.zeros(2), torch.Generator())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mcmc.elliptical_slice(logd, torch.eye(2), torch.zeros(2), torch.Generator())


def test_unravel_roundtrip_and_standard_normal_moments():
    init = {"b": torch.ones(3), "a": torch.tensor(0.3)}
    res, unravel = mcmc.hmc(lambda t: -0.5 * (t["a"] ** 2 + torch.sum(t["b"] ** 2)), init,
                            torch.Generator().manual_seed(0), num_samples=300, num_warmup=150, num_leapfrog=10,
                            device="cpu")
    tree = unravel(res.samples[-1])
    assert tree["a"].shape == () and tree["b"].shape == (3,)
    qs = res.samples.numpy()
    assert qs.shape == (300, 4) and res.inv_mass.shape == (4,) and res.step_size.shape == ()
    assert int(res.divergent.sum()) == 0
    assert 0.6 < float(res.accept_prob.mean()) <= 1.0
    assert np.abs(qs.mean(0)).max() < 0.25 and np.allclose(qs.std(0), 1.0, atol=0.25)


def test_elliptical_slice_reproducible_multicolumn_and_stays_put():
    L = torch.eye(4)
    loglik = lambda f: -0.5 * torch.sum(torch.square(f - 1.0))  # noqa: E731
    d1, d2 = (mcmc.elliptical_slice(loglik, L, torch.zeros((4, 2)), torch.Generator().manual_seed(0), num_samples=50,
                                    num_burn=10, device="cpu") for _ in range(2))
    assert d1.shape == (50, 4, 2)
    assert torch.equal(d1, d2)
    # N(0, I) prior x N(1, I) likelihood -> posterior N(0.5, I/2)
    d3 = mcmc.elliptical_slice(loglik, L, torch.zeros((4, 2)), torch.Generator().manual_seed(1), num_samples=600,
                               num_burn=100, device="cpu")
    assert float(d3.mean()) == pytest.approx(0.5, abs=0.1)
    assert float(d3.var()) == pytest.approx(0.5, abs=0.1)
    # no acceptable angle within max_shrink: the state stays exactly where it was
    f0 = torch.full((4, 2), 0.25)
    stuck = mcmc.elliptical_slice(lambda f: torch.where(torch.all(f == f0), 0.0, -torch.inf), L, f0,
                                  torch.Generator(), num_samples=3, num_burn=0, max_shrink=5, device="cpu")
    assert torch.equal(stuck, f0.expand(3, 4, 2))


def test_sample_latent_shapes_include_the_mean():
    x, y = _classifier_data()
    model = LaplaceGP(x, y, kernels.Rbf(1), likelihoods.Bernoulli(), device="cpu")
    draws = mcmc.sample_latent(model, torch.Generator().manual_seed(3), num_samples=30, num_burn=20, thin=2)
    assert draws.shape == (30, 30, 1) and torch.isfinite(draws).all()
    mean, var = mcmc.predict_latent_mixture(model, draws, x[:4])
    assert mean.shape == var.shape == (4, 1) and bool(torch.all(var > 0))
