"""Training loops.

Counterpart of ``gptorch_tpu/training/fit.py``:

* :func:`make_optimizer` builds the first-order optimizer zoo with the JAX
  package's per-method settings and **optax's update rules**.
  ``torch.optim`` where its rule is optax's: SGD (heavy-ball momentum, no
  dampening), Adam (ε outside the root of the bias-corrected second
  moment), Adamax (ε added to |g| inside the max, no bias correction of
  the infinity norm) and Adadelta (the weight decay added to the gradient
  first, as optax's ``add_decayed_weights`` does).  A small optimizer of
  our own where it is not: RMSprop and Adagrad, where optax adds ε inside
  the square root and ``torch.optim`` outside it, and Adagrad's
  accumulator starts at optax's 0.1 (``torch.optim``: 0).
* :func:`fit_torch`, the counterpart of ``fit_optax``: an eager loop with one
  host read of the loss per step.
* :func:`fit_scan`: the same loop with no host read per step; the losses
  stay on the device and are checked once at the end.
* :func:`fit_scipy`: the float64 bridge to ``scipy.optimize.minimize``, with
  non-finite gradient entries replaced by zeros.

Models train in place: their raw ``nn.Parameter``s are the optimizer's
state, so the trained model is the model passed in.  A loop that raises
``FloatingPointError`` on a non-finite loss first puts back the values the
model had on entry, as the JAX package's loops leave the model untouched.  A minibatched model
(SVGP with ``batch_size``) draws each step's batch from the loop's
``generator``, whose state advances from step to step: the counterpart of
the JAX package's ``fold_in(key, idx)``.  L-BFGS (optax's
zoom line search, ``fit_scan``'s compiled quasi-Newton run) is not ported.
"""

from __future__ import annotations

import time as _time
from typing import Callable, Optional

import numpy as np
import torch

from ..module import get_trainable, pack_vector, set_trainable, trainable_parameters, unpack_vector

#: Per-method default learning rates (the JAX package's table).
DEFAULT_LEARNING_RATES = {
    "SGD": 0.01,
    "Adam": 0.01,
    "LBFGS": 1.0,
    "Adadelta": 1.0,
    "Adagrad": 0.01,
    "Adamax": 0.002,
    "RMSprop": 0.01,
}

SCIPY_METHODS = (
    "CG",
    "BFGS",
    "Newton-CG",
    "Nelder-Mead",
    "Powell",
    "L-BFGS-B",
    "TNC",
    "COBYLA",
    "SLSQP",
    "dogleg",
    "trust-ncg",
)


class OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop(lr, decay, eps, momentum): ν ← decay·ν + (1−decay)·g²,
    u = −lr·g/√(ν + ε), t ← u + momentum·t, θ ← θ + t (ε inside the root)."""

    def __init__(self, params, lr, decay=0.99, eps=1e-8, momentum=0.01):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    state["trace"] = torch.zeros_like(p)
                nu = (1.0 - group["decay"]) * g * g + group["decay"] * state["nu"]
                update = -group["lr"] * (g * torch.rsqrt(nu + group["eps"]))
                trace = update + group["momentum"] * state["trace"]
                state["nu"], state["trace"] = nu, trace
                p.add_(trace)


class OptaxAdagrad(torch.optim.Optimizer):
    """optax.adagrad(lr, initial_accumulator_value, eps): s ← g² + s,
    θ ← θ − lr·g/√(s + ε) (0 where s = 0; ε inside the root)."""

    def __init__(self, params, lr, initial_accumulator_value=0.1, eps=1e-7):
        super().__init__(params, dict(lr=lr, initial=initial_accumulator_value, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(p, group["initial"])
                s = g * g + state["sum"]
                scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros_like(s))
                state["sum"] = s
                p.add_(-group["lr"] * (scale * g))


def make_optimizer(method: str, params, learning_rate: Optional[float] = None):
    """The optimizer of ``method`` over ``params``, with the JAX package's
    settings (its ``make_optimizer``) and optax's update rules."""
    lr = learning_rate if learning_rate is not None else DEFAULT_LEARNING_RATES.get(method, 0.01)
    if method == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=0.9)
    if method == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if method == "Adadelta":
        return torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6, weight_decay=1e-5)
    if method == "Adagrad":
        return OptaxAdagrad(params, lr=lr)
    if method == "Adamax":
        return torch.optim.Adamax(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if method == "RMSprop":
        return OptaxRMSprop(params, lr=lr, decay=0.99, eps=1e-8, momentum=0.01)
    if method == "LBFGS":
        raise NotImplementedError("LBFGS (optax's zoom line search) is not ported; use a scipy method")
    raise ValueError(
        f"Optimizer {method!r} not supported. First-order: "
        f"{sorted(DEFAULT_LEARNING_RATES)}; scipy: {list(SCIPY_METHODS)}"
    )


def _default_generator(model) -> torch.Generator:
    """The loops' generator when the caller gives none: seeded 0 on the
    model's device, as the JAX package's loops default to PRNGKey(0)."""
    return torch.Generator(device=model.device).manual_seed(0)


def _snapshot(params):
    """Detached copies of ``params``, for :func:`_restore`."""
    return [p.detach().clone() for p in params]


@torch.no_grad()
def _restore(params, snapshot):
    for p, v in zip(params, snapshot):
        p.copy_(v)


def _step(model, opt, generator):
    opt.zero_grad(set_to_none=True)
    lval = model._loss(generator=generator)
    lval.backward()
    opt.step()
    return lval.detach()


def fit_torch(
    model,
    method: str = "Adam",
    max_iter: int = 2000,
    learning_rate: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    verbose: bool = True,
    callback: Optional[Callable[[int, float], None]] = None,
):
    """Eager training loop, the counterpart of the JAX package's
    ``fit_optax``: one step per iteration and one host read of the loss per
    step (the loss before that step's update).  Minibatches come from
    ``generator`` (default: seeded 0 on the model's device).

    Returns (model trained in place, losses ndarray, wall seconds).
    """
    params = trainable_parameters(model)
    start = _snapshot(params)
    opt = make_optimizer(method, params, learning_rate)
    generator = generator if generator is not None else _default_generator(model)
    losses = np.zeros(max_iter)
    tic = _time.time()
    for idx in range(max_iter):
        losses[idx] = float(_step(model, opt, generator))
        if not np.isfinite(losses[idx]):
            _restore(params, start)
            raise _nonfinite_loss_error(idx)
        if callback is not None:
            callback(idx, losses[idx])
        if verbose and idx % 20 == 0:
            print(f"Iter: {idx}\tLoss: {losses[idx]}")
    return model, losses, _time.time() - tic


def fit_scan(
    model,
    method: str = "Adam",
    max_iter: int = 2000,
    learning_rate: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
):
    """Training loop with no host read per step: each step's loss is written
    into a device tensor, which is checked for non-finite values once, at
    the end.  Minibatches come from ``generator`` (default: seeded 0 on the
    model's device).  Returns (model trained in place, losses tensor
    (max_iter,) on the model's device).

    The JAX package compiles this loop into one program (``lax.scan``); here
    it runs eagerly.
    """
    params = trainable_parameters(model)
    start = _snapshot(params)
    opt = make_optimizer(method, params, learning_rate)
    generator = generator if generator is not None else _default_generator(model)
    losses = torch.empty((max_iter,), dtype=model.X.dtype, device=model.device)
    for idx in range(max_iter):
        losses[idx] = _step(model, opt, generator)
    bad = torch.nonzero(~torch.isfinite(losses)).flatten()
    if bad.numel():
        _restore(params, start)
        raise _nonfinite_loss_error(int(bad[0]))
    return model, losses


def _nonfinite_loss_error(idx=None) -> FloatingPointError:
    """Actionable diagnosis instead of a silent NaN training run."""
    where = f"became non-finite at iteration {idx}" if idx is not None else "is non-finite"
    return FloatingPointError(
        f"Loss {where}. On the float32 fused "
        "exact-GPR path this usually means the Gaussian noise variance is "
        "below the f32 factorization floor (~0.05 at n=32k: trailing "
        "blocked-Cholesky rounding makes K numerically indefinite). "
        "Remedies: raise likelihood.variance, construct the model with "
        "fast_jitter>0 (e.g. 1e-3) or a larger fast_rel_jitter, or run in "
        "float64 (torch.set_default_dtype(torch.float64) before building the model)."
    )


def fit_scipy(
    model,
    method: str = "L-BFGS-B",
    max_iter: int = 1000,
    tol: Optional[float] = None,
    callback=None,
    disp: bool = True,
):
    """Bridge to ``scipy.optimize.minimize``: each evaluation loads the
    float64 vector into the model, returns the loss and the packed gradient
    as float64, and replaces non-finite gradient entries with zeros.  A
    minibatched model sees one fixed batch, drawn by a generator seeded 0 at
    every evaluation (the JAX package holds its dummy key fixed), so the
    objective is deterministic.

    Returns (model trained in place, scipy OptimizeResult).
    """
    from scipy.optimize import minimize

    values0 = {k: v.detach().clone() for k, v in get_trainable(model).items()}
    keys = sorted(values0)

    def fun(vector):
        set_trainable(model, unpack_vector(np.asarray(vector), values0))
        raws = get_trainable(model)
        lval = model._loss(generator=_default_generator(model))
        grads = torch.autograd.grad(lval, [raws[k] for k in keys], allow_unused=True)
        grads = {k: torch.zeros_like(raws[k]) if gk is None else gk for k, gk in zip(keys, grads)}
        g = pack_vector(grads)
        finite = np.isfinite(g)
        if not finite.all():
            print("Warning: inf or nan in gradient: replacing with zeros")
            g = np.where(finite, g, 0.0)
        return float(lval.detach()), g.astype(np.float64)

    result = minimize(
        fun=fun,
        x0=pack_vector(values0),
        method=method,
        jac=True,
        tol=tol,
        callback=callback,
        options=dict(disp=disp, maxiter=max_iter),
    )
    set_trainable(model, unpack_vector(result.x, values0))
    return model, result
