"""The port's L-BFGS (optax's rule and zoom line search) and training-loop
plumbing against the JAX package, float64 on the CPU.

Tolerances: the first iterates' losses rel 1e-9 and parameters 1e-7 (the
two packages' Cholesky factors and dot products round differently, and
the line search's interpolations carry that through each iteration);
after 60 iterations the final loss within 1e-6, since the runs may take
different but equally converged last steps.
"""

import functools
import types

import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.training import fit as jax_fit
from gptorch_tpu_torch import kernels, likelihoods, settings
from gptorch_tpu_torch.models import GPR, SVGP
from gptorch_tpu_torch.models import sparse_gpr
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.training import fit
from gptorch_tpu_torch.training.lbfgs import LBFGS

LOSS_RTOL, PARAM_ATOL, FINAL_RTOL = 1e-9, 1e-7, 1e-6
N, D = 64, 2


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data():
    rng = np.random.RandomState(0)
    x = rng.randn(N, D)
    return x, np.sin(x[:, :1]) + 0.1 * rng.randn(N, 1)


def _port_gpr():
    x, y = _data()
    return GPR(x, y, kernels.Rbf(D, ARD=True), likelihood=likelihoods.Gaussian(0.1), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_run(max_iter, learning_rate=None):
    """The JAX package's ``fit_scan(method="LBFGS")`` (optax's ``lbfgs``) on
    the same GPR: (losses, trained raw values), numpy."""
    x, y = _data()
    model = JaxGPR(x, y, jax_kernels.Rbf(D, ARD=True), likelihood=jax_likelihoods.Gaussian(0.1))
    trained, losses = jax_fit.fit_scan(model, "LBFGS", max_iter=max_iter, learning_rate=learning_rate)
    return np.asarray(losses), {k: np.asarray(v) for k, v in jax_get_trainable(trained).items()}


def _values(model):
    return {k: v.detach().numpy() for k, v in get_trainable(model).items()}


def _assert_params_close(model, want):
    got = _values(model)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("learning_rate", [None, 0.5])
def test_first_iterates_match_optax(learning_rate):
    want_losses, want_values = _jax_run(5, learning_rate)
    model = _port_gpr()
    losses = model.fit_scan("LBFGS", max_iter=5, learning_rate=learning_rate)
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=LOSS_RTOL)
    _assert_params_close(model, want_values)


def test_learning_rate_scales_the_line_search_direction():
    """A given rate scales the direction before the search, so the runs
    part after the first step (which both take at the search's unit step)."""
    none, half = _jax_run(5)[0], _jax_run(5, 0.5)[0]
    model_none, model_half = _port_gpr(), _port_gpr()
    got_none = model_none.fit_scan("LBFGS", max_iter=5).numpy()
    got_half = model_half.fit_scan("LBFGS", max_iter=5, learning_rate=0.5).numpy()
    np.testing.assert_allclose(got_none, none, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_half, half, rtol=LOSS_RTOL)
    assert got_none[1] == pytest.approx(got_half[1], rel=1e-12)
    assert abs(got_none[2] - got_half[2]) > 1.0


def test_fit_scan_sixty_iterations_matches_jax():
    want_losses, _ = _jax_run(60)
    model = _port_gpr()
    losses = model.fit_scan("LBFGS", max_iter=60).numpy()
    assert losses[-1] == pytest.approx(want_losses[-1], rel=FINAL_RTOL)
    np.testing.assert_allclose(losses[:5], want_losses[:5], rtol=LOSS_RTOL)
    run = fit.fit_scan.last_run
    assert (run["captured"], run["steps"], run["launches_per_step"]) == (False, 60, None)
    assert len(run["evaluations"]) == 60 and run["evaluations"][0] >= 2 and min(run["evaluations"]) >= 1


def test_optimize_lbfgs_matches_jax():
    """``optimize("LBFGS")`` runs ``fit_torch`` (``fit_optax``'s counterpart),
    which evaluates afresh at each step: on a deterministic objective the
    same iterates as ``fit_scan``'s, which starts each step from the line
    search's last evaluation."""
    want_losses, want_values = _jax_run(5)
    model = _port_gpr()
    losses, _ = model.optimize("LBFGS", max_iter=5, verbose=False)
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    _assert_params_close(model, want_values)


def test_lbfgs_reuses_the_line_search_evaluation():
    """fit_scan's optimizer calls the closure once before the first step
    and then only in the line search; fit_torch's once more per step."""
    counts = {}
    for reuse in (True, False):
        model = _port_gpr()
        opt = LBFGS(list(model.parameters()), reuse_evaluations=reuse)
        closure = fit._fixed_objective(model, opt, torch.Generator().manual_seed(0))
        for _ in range(4):
            opt.step(closure)
        counts[reuse] = opt.evaluations
    assert counts[True][0] == counts[False][0]
    assert [a + 1 for a in counts[True][1:]] == counts[False][1:]


def test_make_optimizer_lbfgs():
    p = torch.zeros(3, requires_grad=True)
    assert isinstance(fit.make_optimizer("LBFGS", [p]), LBFGS)
    assert fit.make_optimizer("LBFGS", [p]).param_groups[0]["lr"] is None
    assert fit.make_optimizer("LBFGS", [p], 0.3).param_groups[0]["lr"] == 0.3


def _svgp():
    x, y = _data()
    return SVGP(x, y, kernels.Rbf(D, ARD=True), num_inducing_points=8, batch_size=16, device="cpu")


def _record_batches(monkeypatch):
    seen = []

    def record(generator, n, batch_size, device):
        idx = torch.randperm(n, generator=generator, device=device)[:batch_size]
        seen.append(idx.clone())
        return idx

    monkeypatch.setattr(sparse_gpr, "minibatch_indices", record)
    return seen


def test_minibatched_svgp_lbfgs_sees_one_batch_per_run(monkeypatch):
    seen = _record_batches(monkeypatch)
    gen = torch.Generator().manual_seed(3)
    model = _svgp()
    losses = model.fit_scan("LBFGS", max_iter=3, generator=gen)
    assert bool(torch.isfinite(losses).all()) and float(losses[-1]) < float(losses[0])
    assert len(seen) > 3
    assert all(torch.equal(seen[0], s) for s in seen)


def test_minibatched_svgp_fit_torch_lbfgs_holds_one_batch_per_step(monkeypatch):
    seen = _record_batches(monkeypatch)
    model = _svgp()
    opt = fit.make_optimizer("LBFGS", list(model.parameters()))
    opt.reuse_evaluations = False
    gen = torch.Generator().manual_seed(3)
    per_step = []
    for _ in range(2):
        start = len(seen)
        opt.step(fit._fixed_objective(model, opt, gen))
        per_step.append(seen[start:])
    for batches in per_step:
        assert len(batches) >= 2 and all(torch.equal(batches[0], b) for b in batches)
    assert not torch.equal(per_step[0][0], per_step[1][0])


def test_lbfgs_restores_the_model_on_a_nonfinite_loss():
    """A run whose losses are not finite raises and leaves the model as it
    started (the line search itself retreats to a zero step when every
    trial is non-finite, so only a non-finite start gives such losses)."""
    model = _port_gpr()
    with torch.no_grad():
        model.likelihood.variance.raw.fill_(float("nan"))
    start = _values(model)
    with pytest.raises(FloatingPointError):
        model.fit_scan("LBFGS", max_iter=2)
    after = _values(model)
    for k in start:
        np.testing.assert_array_equal(after[k], start[k])


def _fake_model(device, reads_policy, capturable=True):
    return types.SimpleNamespace(
        device=torch.device(device), _reads_jitter_policy=lambda: reads_policy, _capturable=lambda: capturable
    )


@pytest.mark.parametrize(
    "device, method, policy, reads, expected",
    [
        ("cpu", "Adam", "fixed", True, False),
        ("cuda", "Adam", "fixed", True, True),
        ("cuda", "LBFGS", "fixed", False, False),
        ("cuda", "Adam", "adaptive", True, False),
        ("cuda", "SGD", "adaptive", False, True),
        ("cuda", "RMSprop", "none", True, True),
    ],
)
def test_capture_rule(device, method, policy, reads, expected):
    with settings.override(jitter_policy=policy):
        assert fit.captures(_fake_model(device, reads), method) is expected


@pytest.mark.parametrize("method", ["Adam", "SGD"])
def test_capture_rule_sends_a_step_with_its_own_host_read_eagerly(method):
    with settings.override(jitter_policy="fixed"):
        assert not fit.captures(_fake_model("cuda", False, capturable=False), method)
    x, y = _data()
    assert GPR(x, y, kernels.Rbf(D), device="cpu")._capturable()
    assert not GPR(x, y, kernels.Rbf(D, ARD=True), solver="iterative", device="cpu")._capturable()


def test_gpr_reads_the_jitter_policy_only_off_the_fused_paths():
    x, y = _data()
    assert not GPR(x, y, kernels.Rbf(D), fast=True, device="cpu")._reads_jitter_policy()
    assert not GPR(x, y, kernels.Rbf(D) + kernels.Linear(D), fast=True, device="cpu")._reads_jitter_policy()
    assert GPR(x, y, kernels.Rbf(D), fast=False, device="cpu")._reads_jitter_policy()
    assert GPR(x, y, kernels.Rbf(D), fast=True, objective="loo", device="cpu")._reads_jitter_policy()
    assert _svgp()._reads_jitter_policy()


@pytest.mark.parametrize("method", ["SGD", "Adam", "Adadelta", "Adagrad", "Adamax", "RMSprop"])
def test_optimizer_state_reset_replays_the_first_steps(method):
    """What a captured run relies on: the optimizer's state tensors are
    updated in place (their storage does not move between steps), and
    after ``_reset_optimizer_state`` the same steps follow as from a fresh
    optimizer."""
    def run(opt, p, steps=3):
        out = []
        for k in range(steps):
            opt.zero_grad()
            torch.sum((p - torch.arange(3.0)) ** 2 * (1.0 + k)).backward()
            opt.step()
            out.append(p.detach().clone())
        return out

    p = torch.tensor([0.5, -1.0, 2.0], requires_grad=True)
    opt = fit.make_optimizer(method, [p], 0.1)
    first = run(opt, p)
    storage = {k: t.data_ptr() for k, t in opt.state[p].items() if isinstance(t, torch.Tensor)}
    run(opt, p)
    assert storage == {k: t.data_ptr() for k, t in opt.state[p].items() if isinstance(t, torch.Tensor)}
    with torch.no_grad():
        p.copy_(torch.tensor([0.5, -1.0, 2.0]))
    fit._reset_optimizer_state(opt)
    again = run(opt, p)
    for a, b in zip(first, again):
        torch.testing.assert_close(a, b, rtol=1e-15, atol=1e-15)
