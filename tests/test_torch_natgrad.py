"""Training of the port's sparse models against the JAX package, float64 on
the CPU: one natural-gradient step (gptorch_tpu_torch.training.natgrad)
from the same values, and 5 full-batch Adam steps of fit_scan.

Tolerances: the natural step inverts S⁻¹ through triangular factors, so
its output carries the factors' roundoff times cond(S) (~1e3 here): the
new q and the hyperparameters at rel 1e-8.  fit_scan's losses rel 1e-9,
its trainables rel 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu import mean_functions as jax_means
from gptorch_tpu.models import SVGP as JaxSVGP
from gptorch_tpu.models import VFE as JaxVFE
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.training import fit as jax_fit
from gptorch_tpu.training import natgrad as jax_natgrad
from gptorch_tpu_torch import convert, kernels, likelihoods, mean_functions
from gptorch_tpu_torch.models import GPR, SVGP, VFE
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.training import natgrad

N, D, M = 40, 2, 8
RTOL = 1e-8


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data(dy=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, D)
    return x, np.sin(x[:, :dy]) + 0.1 * rng.randn(N, dy), x[:M].copy()


def _models(jax_cls, cls, dy=2, mean=False, **kw):
    """The same model in both packages, the port loaded with the JAX
    model's trainables."""
    x, y, z = _data(dy)
    jm = jax_cls(x, y, jax_kernels.Rbf(D, ARD=True), inducing_points=z, likelihood=jax_likelihoods.Gaussian(0.1),
                 mean_function=jax_means.Constant(dy) if mean else None, **kw)
    m = cls(x, y, kernels.Rbf(D, ARD=True), inducing_points=z, likelihood=likelihoods.Gaussian(0.1),
            mean_function=mean_functions.Constant(dy) if mean else None, device="cpu", **kw)
    convert.load_trainable(m, {k: np.asarray(v) for k, v in jax_get_trainable(jm).items()})
    return jm, m


def _assert_values(m, want, rtol=RTOL):
    got = get_trainable(m)
    assert sorted(got) == sorted(want)
    for path, raw in got.items():
        w = np.asarray(want[path])
        np.testing.assert_allclose(raw.detach().numpy(), w, rtol=rtol, atol=rtol * np.abs(w).max(), err_msg=path)


@pytest.mark.parametrize("whiten, dy", [(False, 2), (True, 1)])
def test_one_natgrad_step_matches_jax(whiten, dy):
    """One combined step (natural step γ = 0.3 on q, optax-rule Adam 1e-2 on
    the hyperparameters) from the same values, full batch."""
    jm, m = _models(JaxSVGP, SVGP, dy, mean=True, whiten=whiten)
    jstep, values, opt_state = jax_natgrad.make_natgrad_step(jm, nat_lr=0.3)
    values, _, jax_loss = jstep(values, opt_state, jm, jax.random.PRNGKey(0))
    step, opt = natgrad.make_natgrad_step(m, nat_lr=0.3)
    loss = step()
    assert float(loss) == pytest.approx(float(jax_loss), rel=1e-12)
    _assert_values(m, values)
    assert isinstance(opt, torch.optim.Adam)


def test_nat_update_matches_jax():
    rng = np.random.RandomState(1)
    Lq = np.tril(0.3 * rng.randn(M, M)) + 2.0 * np.eye(M)
    M_, g_M = rng.randn(M, 2), rng.randn(M, 2)
    g_S = 0.1 * rng.randn(M, M)
    S = Lq @ Lq.T
    want = jax_natgrad._nat_update(*(jnp.asarray(a) for a in (M_, S, Lq, g_M, g_S)), 0.5)
    got = natgrad._nat_update(*(torch.as_tensor(a) for a in (M_, S, Lq, g_M, g_S)), 0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=RTOL * np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("whiten", [False, True])
def test_one_unit_step_reaches_the_vfe_bound(whiten):
    """With a Gaussian likelihood and the full batch, one γ = 1 step lands on
    the optimal q(u): the ELBO equals the collapsed bound (hyperparameters
    frozen by a zero-rate SGD)."""
    x, y, z = _data()
    svgp = SVGP(x, y, kernels.Rbf(D, ARD=True), inducing_points=z, likelihood=likelihoods.Gaussian(0.1),
                whiten=whiten, device="cpu")
    vfe = VFE(x, y, kernels.Rbf(D, ARD=True), inducing_points=z, likelihood=likelihoods.Gaussian(0.1), device="cpu")
    step, _ = natgrad.make_natgrad_step(svgp, nat_lr=1.0, optimizer=lambda p: torch.optim.SGD(p, lr=0.0))
    step()
    assert -float(svgp.loss()) == pytest.approx(float(vfe.log_likelihood()), rel=1e-9, abs=1e-8)


def test_fit_svgp_natgrad_trains_and_backs_off():
    """The loop lowers the loss; from a step size that breaks q(u) it rolls
    back and halves γ until the loss stays finite."""
    x, y, _ = _data(seed=3)
    m = SVGP(x, y, kernels.Rbf(D), num_inducing_points=M, batch_size=16, device="cpu")
    l0 = float(m.loss(x=m.X, y=m.Y))
    _, losses = natgrad.fit_svgp_natgrad(m, n_steps=20, nat_lr=0.5, generator=torch.Generator().manual_seed(1))
    assert np.all(np.isfinite(losses)) and float(m.loss(x=m.X, y=m.Y)) < l0

    # plain steps at γ = 1e4 break q(u): the third loss is not finite;
    # the loop rolls such steps back and halves γ, so its losses stay finite
    m = SVGP(x, y, kernels.Rbf(D), num_inducing_points=M, device="cpu")
    step, _ = natgrad.make_natgrad_step(m, nat_lr=1e4)
    assert not np.isfinite([float(step()) for _ in range(3)]).all()
    m = SVGP(x, y, kernels.Rbf(D), num_inducing_points=M, device="cpu")
    _, losses = natgrad.fit_svgp_natgrad(m, n_steps=5, nat_lr=1e4)
    assert np.all(np.isfinite(losses))


def test_q_groups_are_validated():
    x, y, z = _data()
    with pytest.raises(ValueError, match="variational"):
        natgrad.make_natgrad_step(GPR(x, y, kernels.Rbf(D), device="cpu"))
    m = SVGP(x, y, kernels.Rbf(D), inducing_points=z, device="cpu")
    with pytest.raises(ValueError, match="not trainable"):
        natgrad.make_natgrad_step(m, q_groups=[("induced_output_mean", "nope")])


@pytest.mark.parametrize("jax_cls, cls, whiten", [(JaxVFE, VFE, None), (JaxSVGP, SVGP, True)])
def test_fit_scan_adam_matches_jax(jax_cls, cls, whiten):
    """5 full-batch Adam steps of fit_scan, port against JAX, step by step."""
    jm, m = _models(jax_cls, cls, 2, mean=True, **({} if whiten is None else {"whiten": whiten}))
    trained, want = jax_fit.fit_scan(jm, "Adam", max_iter=5, learning_rate=0.02)
    losses = m.fit_scan("Adam", max_iter=5, learning_rate=0.02)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want), rtol=1e-9)
    _assert_values(m, jax_get_trainable(trained))
