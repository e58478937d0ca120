"""The port's state-space GP (gptorch_tpu_torch.ops.ssm,
models.StateSpaceGPR) against the JAX package, float64 on the CPU, data
made from numpy seeds.

* The port's ``associative_scan`` follows ``lax.associative_scan``'s
  recursion: on a sum of floats (whose rounding depends only on the order
  of the additions) the two give the same bits, forward and reverse, for
  every length tried.
* The discretization (A, Q, H) for 2ν ∈ {1, 3, 5} and a Sum: 1e-13
  relative to each array's largest entry.
* The chunked filter (three-phase scan, a chunk that does not divide n)
  against the monolithic one: 1e-12 relative.
* NLML: 1e-10 relative for Matern12/32/52 and Matern32 + Matern52 (s = 5,
  the batched-inverse branch); its gradient (Sum kernel, constant mean) to
  1e-10 of the gradient's largest entry.
* predict_f, predict_y (queries interleaved as masked steps),
  filter_moments and ssm_posterior with masked steps: 1e-10 relative to
  each output's largest entry.
* The port's state-space GP against the port's dense GPR: NLML 1e-9
  relative (the JAX test's limit), predictions 1e-8 absolute.
* Joint samples: the moments of 4000 draws against predict_f within five
  standard errors; a generator seed repeats its draws.

The JAX references are compiled once (module-scoped caches), at n = 24:
tracing and compiling a value-and-grad of the scan costs seconds, and
grows with the scan's depth, log₂n.  The port-only cases run at n = 100.
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
from gptorch_tpu.models import StateSpaceGPR as JaxStateSpaceGPR
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu.ops import ssm as jax_ssm
from gptorch_tpu_torch import convert, kernels, likelihoods, mean_functions
from gptorch_tpu_torch.models import GPR, StateSpaceGPR
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.ops import ssm

N, N_REF, RTOL = 100, 24, 1e-10
KERNELS = ["Matern12", "Matern32", "Matern52", "Matern32+Matern52"]


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 10.0, n)[:, None]  # unsorted on purpose
    return x, np.sin(x) + 0.1 * rng.standard_normal((n, 1))


def _kernel(lib, name):
    make = {
        "Matern12": lambda: lib.Matern12(1, variance=1.3, length_scales=0.7),
        "Matern32": lambda: lib.Matern32(1, variance=0.8, length_scales=1.1),
        "Matern52": lambda: lib.Matern52(1, variance=1.5, length_scales=0.9),
        "Matern32+Matern52": lambda: lib.Matern32(1) + lib.Matern52(1, length_scales=2.5),
    }
    return make[name]()


def _models(name, mean="zero", n=N_REF):
    x, y = _data(n)
    jm = JaxStateSpaceGPR(x, y, _kernel(jax_kernels, name), likelihood=jax_likelihoods.Gaussian(0.04),
                          mean_function=None if mean == "zero" else jax_means.Constant(1, np.array([0.2])))
    tm = StateSpaceGPR(x, y, _kernel(kernels, name), likelihood=likelihoods.Gaussian(0.04),
                       mean_function=None if mean == "zero" else mean_functions.Constant(1, np.array([0.2])),
                       device="cpu")
    return jm, tm


def _queries():
    return np.linspace(-1.0, 11.0, 9)[:, None]


def _masked_inputs():
    """Sorted inputs with every third step masked (a prediction site whose
    y, set to 123, must be ignored)."""
    x, y = _data(N_REF)
    mask = np.arange(N_REF) % 3 != 0
    return np.sort(x[:, 0]), np.where(mask[:, None], y, 123.0), mask


@functools.lru_cache(maxsize=None)
def _references():
    """In one compiled call: the JAX models' losses for every kernel; for
    Matern52, predict_f, predict_y and the filter moments; ssm_posterior
    with masked steps (Matern32)."""
    models = {name: _models(name)[0] for name in KERNELS}
    xq = jnp.asarray(_queries())
    xs, ym, mask = map(jnp.asarray, _masked_inputs())
    kern = _kernel(jax_kernels, "Matern32")

    def compute():
        m52 = models["Matern52"]
        return ({name: m._loss() for name, m in models.items()}, m52.predict_f(xq), m52.predict_y(xq),
                m52.filter_moments(), jax_ssm.ssm_posterior(kern, 0.04, xs, ym, mask))

    return jax.tree_util.tree_map(np.asarray, jax.jit(compute)())


@functools.lru_cache(maxsize=None)
def _value_and_grad(name, mean):
    """The JAX model's loss and gradient at perturbed trainables."""
    jm, _ = _models(name, mean)
    rng = np.random.RandomState(3)
    values = {k: np.asarray(v) + 0.05 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jm).items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda v: jax_with_trainable(jm, v)._loss()))(
        {k: jnp.asarray(v) for k, v in values.items()})
    return values, float(loss), {k: np.asarray(g) for k, g in grads.items()}


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 33, 100])
@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_follows_lax(n, reverse):
    x = np.random.RandomState(n).randn(3, n)
    want = np.asarray(jax.jit(lambda a: jax.lax.associative_scan(jnp.add, a, reverse=reverse, axis=1))(x))
    (got,) = ssm.associative_scan(lambda a, b: (a[0] + b[0],), (torch.as_tensor(x),), dim=1, reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", KERNELS)
def test_discretization_matches_jax(name):
    x, _ = _data(64)
    xs = np.sort(x[:, 0])
    kern = _kernel(jax_kernels, name)
    A_j, Q_j, H_j, blocks_j = jax.jit(lambda: jax_ssm.assemble_sde(kern, jnp.asarray(xs)))()
    A_t, Q_t, H_t, blocks_t = ssm.assemble_sde(_kernel(kernels, name), torch.as_tensor(xs))
    for got, want in ((A_t, A_j), (Q_t, Q_j), (H_t, H_j)):
        _close(got, want, 1e-13)
    assert [F.shape for F, _, _ in blocks_t] == [F.shape for F, _, _ in blocks_j]
    assert not _np(A_t[0]).any()
    for (F_t, P_t, _), (F_j, P_j, _) in zip(blocks_t, blocks_j):
        _close(F_t, F_j, 1e-14)
        _close(P_t, P_j, 1e-14)


@pytest.mark.parametrize("name", ["Matern52", "Matern32+Matern52"])
@pytest.mark.parametrize("chunk", [16, 33])
def test_chunked_filter_matches_monolithic(name, chunk):
    x, y = _data()
    order = np.argsort(x[:, 0], kind="stable")
    xs, ys = torch.as_tensor(x[order, 0]), torch.as_tensor(y[order])
    A, Q, H, _ = ssm.assemble_sde(_kernel(kernels, name), xs)
    R = torch.tensor(0.04)
    mono = ssm.parallel_filter(A, Q, H, R, ys)
    chunked = ssm.parallel_filter(A, Q, H, R, ys, chunk=chunk)
    for got, want in zip(chunked, mono):
        _close(got, want, 1e-12)
    value = _np(ssm.ssm_nlml(_kernel(kernels, name), R, xs, ys, chunk=chunk))
    assert value == pytest.approx(_np(ssm.ssm_nlml(_kernel(kernels, name), R, xs, ys)), rel=1e-12)


@pytest.mark.parametrize("name", KERNELS)
def test_nlml_matches_jax(name):
    _, tm = _models(name)
    assert float(tm.loss().detach()) == pytest.approx(float(_references()[0][name]), rel=RTOL)


def test_nlml_gradient_matches_jax():
    """The Sum kernel (s = 5: the batched-inverse combine) with a trainable
    constant mean, at perturbed trainables."""
    values, want, want_grads = _value_and_grad("Matern32+Matern52", "constant")
    _, tm = _models("Matern32+Matern52", "constant")
    convert.load_trainable(tm, values)
    loss = tm._loss()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(want, rel=RTOL)
    scale = max(np.abs(g).max() for g in want_grads.values())
    raws = get_trainable(tm)
    assert sorted(raws) == sorted(want_grads)
    for path, raw in raws.items():
        np.testing.assert_allclose(raw.grad.numpy(), want_grads[path], rtol=0, atol=RTOL * scale, err_msg=path)


def test_predictions_and_filter_moments_match_jax():
    _, (f_mean, f_var), (y_mean, y_var), (m_filt, v_filt), _ = _references()
    _, tm = _models("Matern52")
    xq = _queries()
    for got, want in zip(tm.predict_f(xq) + tm.predict_y(xq), (f_mean, f_var, y_mean, y_var)):
        _close(got, want)
    for got, want in zip(tm.filter_moments(), (m_filt, v_filt)):
        _close(got, want)


def test_masked_steps_match_jax():
    """ssm_posterior with every third step masked, against the JAX function."""
    xs, ym, mask = _masked_inputs()
    got = ssm.ssm_posterior(_kernel(kernels, "Matern32"), torch.tensor(0.04), torch.as_tensor(xs),
                            torch.as_tensor(ym), torch.as_tensor(mask))
    for g, w in zip(got, _references()[4]):
        _close(g, w)


def test_constructor_and_call_errors_match_jax():
    x, y = _data(20)
    cases = [
        (lambda lib, lik: lib.Matern32(2), np.hstack([x, x]), "1-D inputs"),
        (lambda lib, lik: lib.Matern32(1), x, "Gaussian likelihood"),
        (lambda lib, lik: lib.Rbf(1), x, "no exact state-space form"),
    ]
    for make, xin, match in cases:
        for lib, liks, kw in ((jax_kernels, jax_likelihoods, {}), (kernels, likelihoods, {"device": "cpu"})):
            lik = liks.Bernoulli() if match == "Gaussian likelihood" else liks.Gaussian(0.1)
            model = JaxStateSpaceGPR if lib is jax_kernels else StateSpaceGPR
            with pytest.raises(ValueError, match=match):
                model(xin, y, make(lib, lik), likelihood=lik, **kw)
    tm = StateSpaceGPR(x, y, kernels.Matern32(1), device="cpu")
    with pytest.raises(ValueError, match="minibatch"):
        tm.loss(x=torch.as_tensor(x[:5]), y=torch.as_tensor(y[:5]))
    with pytest.raises(NotImplementedError, match="diag"):
        tm.predict_f(x, diag=False)


def test_sorted_storage_and_chunk_rule(monkeypatch):
    x, y = _data(50)
    tm = StateSpaceGPR(x, y, kernels.Matern32(1), device="cpu")
    order = np.argsort(x[:, 0], kind="stable")
    np.testing.assert_array_equal(tm.X.numpy(), x[order])
    np.testing.assert_array_equal(tm.Y.numpy(), y[order])
    assert tm._scan_chunk is None
    monkeypatch.setenv("GPTORCH_TPU_SSM_CHUNK", "8")
    assert tm._scan_chunk == 8
    chunked = float(tm.loss().detach())
    monkeypatch.setenv("GPTORCH_TPU_SSM_CHUNK", "0")
    assert tm._scan_chunk is None
    assert chunked == pytest.approx(float(tm.loss().detach()), rel=1e-12)


@pytest.mark.parametrize("name", KERNELS)
def test_matches_dense_gpr(name):
    """The port's state-space GP against the port's dense GPR on the same
    data: NLML (1e-9), its gradient and the posterior moments."""
    x, y = _data()
    ssgp = StateSpaceGPR(x, y, _kernel(kernels, name), likelihood=likelihoods.Gaussian(0.04), device="cpu")
    dense = GPR(x, y, _kernel(kernels, name), likelihood=likelihoods.Gaussian(0.04), fast=False, device="cpu")
    ls, ld = ssgp.loss(), dense.loss()
    ls.backward()
    ld.backward()
    assert float(ls.detach()) == pytest.approx(float(ld.detach()), rel=1e-9)
    gd = {k: v.grad.numpy() for k, v in get_trainable(dense).items()}
    for k, v in get_trainable(ssgp).items():
        np.testing.assert_allclose(v.grad.numpy(), gd[k], rtol=1e-6, atol=1e-8, err_msg=k)
    xq = _queries()
    for got, want in zip(ssgp.predict_f(xq), dense.predict_f(xq)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8)


@pytest.mark.parametrize("name", ["Matern12", "Matern32+Matern52"])
def test_sample_moments_and_generators(name):
    x, y = _data(60)
    tm = StateSpaceGPR(x, y, _kernel(kernels, name), likelihood=likelihoods.Gaussian(0.04), device="cpu")
    xq = _queries()
    mean, var = tm.predict_f(xq)
    s = 4000
    draws = tm.predict_f_samples(xq, s, generator=torch.Generator().manual_seed(0))
    assert draws.shape == (s, xq.shape[0], 1)
    assert np.all(np.abs(draws.mean(0) - mean) <= 5.0 * np.sqrt(var / s))
    assert np.all(np.abs(draws.var(0) - var) <= 5.0 * var * np.sqrt(2.0 / s))
    again = tm.predict_f_samples(xq, s, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again, draws)
    other = tm.predict_f_samples(xq, s, generator=torch.Generator().manual_seed(1))
    assert not np.array_equal(other, draws)
    observed = tm.predict_y_samples(xq, s, generator=torch.Generator().manual_seed(0))
    y_var = tm.predict_y(xq)[1]
    assert np.all(np.abs(observed.var(0) - y_var) <= 5.0 * y_var * np.sqrt(2.0 / s))
