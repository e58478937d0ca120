"""The port's ψ-statistics kernels and uncertain-input prediction
(gptorch_tpu_torch.ekernels, GPR.predict_uncertain) against the JAX
package, float64 on the CPU, inputs made from numpy seeds.

Tolerances: the ψ-statistics within 1e-10 of their largest entry (the port
sums ψ₂ over row chunks where the JAX package scans one datum at a time, so
only the order of the sums differs); their gradients within 1e-10 of the
largest entry; uncertain-input moments within 1e-9 relative (their
(m, m) solves carry cond(Kuu) into the roundoff).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import ekernels as jax_ekernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu import mean_functions as jax_means
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu_torch import ekernels, kernels, likelihoods, mean_functions
from gptorch_tpu_torch.models import GPR

RTOL = 1e-10
N, M, Q = 9, 6, 3
ELL, VAR = np.array([0.7, 1.3, 2.0]), 1.7


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _inputs(seed=0, n=N, m=M, q=Q):
    """Z (m, q), μ (n, q), diagonal s (n, q) and full S (n, q, q)."""
    rng = np.random.RandomState(seed)
    a = 0.4 * rng.randn(n, q, q)
    return (rng.randn(m, q), rng.randn(n, q), 0.3 * np.exp(rng.randn(n, q)),
            a @ a.transpose(0, 2, 1) + 0.05 * np.eye(q))


def _kernels(kind):
    if kind == "rbf":
        return jax_ekernels.Rbf(Q, ARD=True, length_scales=ELL, variance=VAR), ekernels.Rbf(
            Q, ARD=True, length_scales=ELL, variance=VAR)
    if kind == "rbf_iso":
        return jax_ekernels.Rbf(Q, length_scales=1.1, variance=VAR), ekernels.Rbf(Q, length_scales=1.1, variance=VAR)
    v = np.array([0.5, 1.0, 2.0])
    return jax_ekernels.Linear(Q, variance=v), ekernels.Linear(Q, variance=v)


def _close(got, want, rtol=RTOL):
    got, want = (a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in (got, want))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


def _stat(kernel, stat, Z, mu, cov):
    if stat == "psi0":
        return kernel.eKxx(mu, cov) if isinstance(kernel, (jax_ekernels.Linear, ekernels.Linear)) else kernel.eKxx(mu)
    if stat == "psi1":
        return kernel.eKxz(Z, mu, cov)
    return kernel.eKzxKxz(Z, mu, cov, sum=stat == "psi2_sum")


@pytest.mark.parametrize("stat", ["psi0", "psi1", "psi2_sum", "psi2_each"])
@pytest.mark.parametrize("cov", ["diag", "full"])
@pytest.mark.parametrize("kind", ["rbf", "rbf_iso", "linear"])
def test_psi_statistics_match_jax(kind, cov, stat):
    Z, mu, s, S = _inputs()
    c = s if cov == "diag" else S
    jk, tk = _kernels(kind)
    want = _stat(jk, stat, Z, mu, c)
    got = _stat(tk, stat, *(torch.as_tensor(a) for a in (Z, mu, c)))
    _close(got, want)


@pytest.mark.parametrize("cov", ["diag", "full"])
@pytest.mark.parametrize("kind", ["rbf", "linear"])
def test_psi_gradients_match_jax(kind, cov):
    """d/d(hyperparameters, Z, μ, S) of a weighted sum of ψ₁ and ψ₂."""
    Z, mu, s, S = _inputs(seed=1)
    c = s if cov == "diag" else S
    rng = np.random.RandomState(2)
    w1, w2 = rng.randn(N, M), rng.randn(M, M)
    jk, tk = _kernels(kind)

    def objective(k, Z, mu, c, lib):
        return lib.sum(k.eKxz(Z, mu, c) * lib.asarray(w1)) + lib.sum(k.eKzxKxz(Z, mu, c) * lib.asarray(w2))

    def jax_obj(raws, Z, mu, c):
        k = jk
        for name, raw in raws.items():
            k = k.replace(**{name: getattr(k, name).with_raw(raw)})
        return objective(k, Z, mu, c, jnp)

    raws = {name: getattr(jk, name).raw for name in ("variance",) + (("length_scales",) if kind == "rbf" else ())}
    want = jax.grad(jax_obj, argnums=(0, 1, 2, 3))(raws, Z, mu, c)
    tZ, tmu, tc = (torch.tensor(a, requires_grad=True) for a in (Z, mu, c))
    objective(tk, tZ, tmu, tc, torch).backward()
    for name in raws:
        _close(getattr(tk, name).raw.grad, want[0][name])
    for got, w in zip((tZ, tmu, tc), want[1:]):
        _close(got.grad, w)


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_psi2_row_chunks_match_one_chunk(cov, monkeypatch):
    """Chunks of two rows (five chunks here) give ψ₂ summed and per datum
    as one chunk does, and uncertain_conditional, which takes the same row
    chunks, its moments."""
    Z, mu, s, S = _inputs(seed=3)
    c = torch.as_tensor(s if cov == "diag" else S)
    tk = _kernels("rbf")[1]
    w, G = (torch.as_tensor(a) for a in _wG())
    args = (torch.as_tensor(Z), torch.as_tensor(mu), c)
    whole = [tk.eKzxKxz(*args, sum=True), tk.eKzxKxz(*args, sum=False),
             *ekernels.uncertain_conditional(tk, args[0], w, G, args[1], c)]
    monkeypatch.setattr(ekernels, "_CHUNK_ELEMENTS", 2 * M * M)
    assert len(ekernels._row_chunks(N, M)) == 5
    chunked = [tk.eKzxKxz(*args, sum=True), tk.eKzxKxz(*args, sum=False),
               *ekernels.uncertain_conditional(tk, args[0], w, G, args[1], c)]
    for got, want in zip(chunked, whole):
        _close(got, want, 1e-14)


def _wG(seed=4, p=2):
    rng = np.random.RandomState(seed)
    a = rng.randn(M, M)
    return 0.5 * rng.randn(M, p), 0.1 * (a @ a.T) / M


@pytest.mark.parametrize("cov", ["diag", "full"])
@pytest.mark.parametrize("kind", ["rbf", "linear"])
def test_uncertain_conditional_matches_jax(kind, cov):
    Z, mu, s, S = _inputs(seed=5)
    c = s if cov == "diag" else S
    w, G = _wG()
    jk, tk = _kernels(kind)
    want = jax_ekernels.uncertain_conditional(jk, Z, w, G, mu, c)
    got = ekernels.uncertain_conditional(tk, *(torch.as_tensor(a) for a in (Z, w, G)), mu, c)
    for g, wt in zip(got, want):
        _close(g, wt)


def test_uncertain_predict_means_and_kernels():
    Z, mu, s, _ = _inputs(seed=6)
    w, G = _wG()
    tZ, tw, tG = (torch.as_tensor(a) for a in (Z, w, G))
    jk, tk = _kernels("rbf")
    want = jax_ekernels.uncertain_predict(jk, jax_means.Constant(2, np.array([3.0, -1.0])), Z, w, G, mu, s)
    got = ekernels.uncertain_predict(tk, mean_functions.Constant(2, np.array([3.0, -1.0])), tZ, tw, tG, mu, s)
    for g, wt in zip(got, want):
        _close(g, wt)
    zero = ekernels.uncertain_predict(tk, mean_functions.Zero(2), tZ, tw, tG, mu, s)
    _close(got[0] - zero[0], np.broadcast_to([3.0, -1.0], (N, 2)), 1e-14)
    with pytest.raises(NotImplementedError, match="Zero/Constant"):
        ekernels.uncertain_predict(tk, mean_functions.LinearMean(Q, 2), tZ, tw, tG, mu, s)
    with pytest.raises(TypeError, match="ψ-statistics"):
        ekernels.uncertain_conditional(kernels.Rbf(Q), tZ, tw, tG, mu, s)


def _gpr_pair(mean):
    rng = np.random.RandomState(7)
    x = rng.randn(20, Q)
    y = np.sin(x[:, :2]) + 0.1 * rng.randn(20, 2)
    jm = JaxGPR(x, y, jax_ekernels.Rbf(Q, ARD=True, length_scales=ELL), likelihood=jax_likelihoods.Gaussian(0.1),
                mean_function=None if mean == "zero" else jax_means.Constant(2, np.array([0.2, -0.4])))
    tm = GPR(x, y, ekernels.Rbf(Q, ARD=True, length_scales=ELL), likelihood=likelihoods.Gaussian(0.1),
             mean_function=None if mean == "zero" else mean_functions.Constant(2, np.array([0.2, -0.4])),
             device="cpu")
    return jm, tm, rng.randn(5, Q)


@pytest.mark.parametrize("cov", ["diag", "full"])
@pytest.mark.parametrize("mean", ["zero", "constant"])
def test_gpr_predict_uncertain_matches_jax(mean, cov):
    jm, tm, xq = _gpr_pair(mean)
    _, _, s, S = _inputs(seed=8, n=5)
    xv = s if cov == "diag" else S
    want = jm.predict_uncertain(xq, xv)
    got = tm.predict_uncertain(xq, xv)
    assert isinstance(got[0], np.ndarray)
    for g, w in zip(got, want):
        _close(g, w, 1e-9)
    # at zero input variance the moments are predict_f's
    mu_f, var_f = tm.predict_f(xq)
    mu_u, var_u = tm.predict_uncertain(xq, np.zeros_like(xq))
    np.testing.assert_allclose(mu_u, mu_f, rtol=0, atol=1e-10)
    np.testing.assert_allclose(var_u, var_f, rtol=0, atol=1e-10)


def test_gpr_predict_uncertain_needs_the_dense_solver():
    jm, tm, xq = _gpr_pair("zero")
    it = GPR(tm.X.numpy(), tm.Y.numpy(), kernels.Rbf(Q, ARD=True), solver="iterative", device="cpu")
    with pytest.raises(NotImplementedError, match="dense solver"):
        it.predict_uncertain(xq, np.zeros_like(xq))
