"""Training loops.

Counterpart of ``gptorch_tpu/training/fit.py``:

* :func:`make_optimizer` builds the optimizer zoo with the JAX package's
  per-method settings and **optax's update rules**.  ``torch.optim`` where
  its rule is optax's: SGD (heavy-ball momentum, no dampening), Adam (ε
  outside the root of the bias-corrected second moment), Adamax (ε added
  to |g| inside the max, no bias correction of the infinity norm) and
  Adadelta (the weight decay added to the gradient first, as optax's
  ``add_decayed_weights`` does).  A small optimizer of our own where it is
  not: RMSprop and Adagrad, where optax adds ε inside the square root and
  ``torch.optim`` outside it, and Adagrad's accumulator starts at optax's
  0.1 (``torch.optim``: 0); and L-BFGS, optax's ``lbfgs`` with its zoom
  line search (:class:`~gptorch_tpu_torch.training.lbfgs.LBFGS`).
* :func:`fit_torch`, the counterpart of ``fit_optax``: an eager loop with one
  host read of the loss per step.
* :func:`fit_scan`: the whole run with no host read per step, the
  counterpart of the JAX package's ``lax.scan`` under ``jit``.  On the card
  a first-order method captures one step as a CUDA graph and replays it
  (:func:`captures` states the rule); the losses stay on the device and are
  checked once at the end.
* :func:`fit_scipy`: the float64 bridge to ``scipy.optimize.minimize``, with
  non-finite gradient entries replaced by zeros.

Models train in place: their raw ``nn.Parameter``s are the optimizer's
state, so the trained model is the model passed in.  A loop that raises
``FloatingPointError`` on a non-finite loss first puts back the values the
model had on entry, as the JAX package's loops leave the model untouched.  A minibatched model
(SVGP with ``batch_size``) draws each step's batch from the loop's
``generator``, whose state advances from step to step: the counterpart of
the JAX package's ``fold_in(key, idx)``.  L-BFGS holds its objective fixed
while it searches: every evaluation of one ``fit_torch`` step, and of a
whole ``fit_scan`` run, draws from the same generator state.
"""

from __future__ import annotations

import time as _time
import weakref
from typing import Callable, Optional

import numpy as np
import torch

from .. import ops, settings
from ..module import get_trainable, pack_vector, set_trainable, trainable_parameters, unpack_vector
from .lbfgs import LBFGS

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
    u = −lr·g/√(ν + ε), t ← u + momentum·t, θ ← θ + t (ε inside the root).
    The state is updated in place, so a captured step replays it."""

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
                state["nu"].copy_((1.0 - group["decay"]) * g * g + group["decay"] * state["nu"])
                update = -group["lr"] * (g * torch.rsqrt(state["nu"] + group["eps"]))
                state["trace"].copy_(update + group["momentum"] * state["trace"])
                p.add_(state["trace"])


class OptaxAdagrad(torch.optim.Optimizer):
    """optax.adagrad(lr, initial_accumulator_value, eps): s ← g² + s,
    θ ← θ − lr·g/√(s + ε) (0 where s = 0; ε inside the root).  The state
    is updated in place, so a captured step replays it."""

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
                s = state["sum"]
                s.copy_(g * g + s)
                scale = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros_like(s))
                p.add_(-group["lr"] * (scale * g))


def make_optimizer(method: str, params, learning_rate: Optional[float] = None, capturable: bool = False):
    """The optimizer of ``method`` over ``params``, with the JAX package's
    settings (its ``make_optimizer``) and optax's update rules.

    ``"LBFGS"`` gives :class:`~gptorch_tpu_torch.training.lbfgs.LBFGS`,
    which takes a closure; ``learning_rate=None`` there means the line
    search's step, unscaled (``optax.lbfgs(learning_rate=None)``).
    ``capturable`` asks ``torch.optim`` for its CUDA-graph-safe variant
    (step counts held as device tensors); the port's own optimizers are
    graph-safe as they are."""
    lr = learning_rate if learning_rate is not None else DEFAULT_LEARNING_RATES.get(method, 0.01)
    if method == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=0.9)
    if method == "Adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=capturable)
    if method == "Adadelta":
        return torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6, weight_decay=1e-5, capturable=capturable)
    if method == "Adagrad":
        return OptaxAdagrad(params, lr=lr)
    if method == "Adamax":
        return torch.optim.Adamax(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=capturable)
    if method == "RMSprop":
        return OptaxRMSprop(params, lr=lr, decay=0.99, eps=1e-8, momentum=0.01)
    if method == "LBFGS":
        return LBFGS(params, lr=learning_rate)
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


def _fixed_objective(model, opt, generator):
    """The closure of an L-BFGS step: every call restores ``generator`` to
    its state at this call's creation before the loss draws from it, so
    all evaluations see one minibatch."""
    state = generator.get_state()

    def closure():
        generator.set_state(state)
        opt.zero_grad(set_to_none=True)
        lval = model._loss(generator=generator)
        lval.backward()
        return lval

    return closure


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

    ``method="LBFGS"`` evaluates afresh at the start of each step, and every
    evaluation of one step sees the same batch (``fit_optax`` holds one key
    per step).

    Returns (model trained in place, losses ndarray, wall seconds).
    """
    params = trainable_parameters(model)
    start = _snapshot(params)
    opt = make_optimizer(method, params, learning_rate)
    if method == "LBFGS":
        opt.reuse_evaluations = False
    generator = generator if generator is not None else _default_generator(model)
    losses = np.zeros(max_iter)
    tic = _time.time()
    for idx in range(max_iter):
        if method == "LBFGS":
            losses[idx] = opt.step(_fixed_objective(model, opt, generator))
        else:
            losses[idx] = float(_step(model, opt, generator))
        if not np.isfinite(losses[idx]):
            _restore(params, start)
            raise _nonfinite_loss_error(idx)
        if callback is not None:
            callback(idx, losses[idx])
        if verbose and idx % 20 == 0:
            print(f"Iter: {idx}\tLoss: {losses[idx]}")
    return model, losses, _time.time() - tic


def captures(model, method: str) -> bool:
    """Whether :func:`fit_scan` runs ``method`` on ``model`` as a captured
    CUDA graph.  The fixed rule: yes on the card, except for

    * ``LBFGS``, whose line search branches on the data (host reads per
      evaluation);
    * the ``adaptive`` jitter policy when the model's loss factors through
      :func:`~gptorch_tpu_torch.functions.cholesky`
      (``model._reads_jitter_policy()``): its probe is a host loop;
    * a model whose step holds a host read of its own
      (``model._capturable()`` is False): ``GPR(solver="iterative")``, whose
      SLQ's batched ``torch.linalg.eigh`` checks its status on the host.  A
      step there is seconds of matrix-free products on the card (about 130
      K3 launches at n = 100000), so the host's few thousand launches per
      step cost under 1 % of it eagerly.

    Those, and every run on the CPU, go eagerly."""
    if model.device.type != "cuda" or method == "LBFGS" or not model._capturable():
        return False
    return not (settings.config.jitter_policy == "adaptive" and model._reads_jitter_policy())


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
    model's device), which advances as the eager loop would advance it.
    Returns (model trained in place, losses tensor (max_iter,) on the
    model's device).

    Where :func:`captures` says so (a first-order method on the card), one
    step -- zero grad, the loss on the step's minibatch, backward, the
    optimizer step and the loss written into the losses tensor -- is
    captured as a CUDA graph and replayed ``max_iter`` times: the
    counterpart of the JAX package's ``lax.scan`` under ``jit``.  The graph
    is cached on the model, keyed by the method, the learning rate,
    ``settings.trace_key()``, ``max_iter``, the trainables' and buffers'
    shapes, dtypes and storage and the modules' settings; a capture error
    raises (a loss tensor still alive from an earlier ``backward()`` of the
    model holds its parameters' gradient accumulators on the default
    stream, which a capture cannot join: drop it first).  Otherwise the
    loop runs eagerly.  ``method="LBFGS"`` runs eagerly with host reads per
    evaluation, as optax's run would in a loop: the objective is held fixed
    across the run (one generator state for every evaluation) and the line
    search's last value and gradient start the next iteration.
    ``fit_scan.last_run`` describes the last call (captured or not, the
    kernel launches recorded per captured step, L-BFGS's evaluations).
    """
    return _fit_scan(model, method, max_iter, learning_rate, generator, captures(model, method))


def _fit_scan(model, method, max_iter, learning_rate, generator, capture: bool):
    """:func:`fit_scan` with the capture decided by the caller (the eager
    loop on the card is what a captured run is held against)."""
    params = trainable_parameters(model)
    start = _snapshot(params)
    generator = generator if generator is not None else _default_generator(model)
    launches = evaluations = None
    if method == "LBFGS":
        opt = make_optimizer(method, params, learning_rate)
        closure = _fixed_objective(model, opt, generator)
        values = [opt.step(closure) for _ in range(max_iter)]
        losses = torch.tensor(values, dtype=model.X.dtype, device=model.device)
        evaluations = opt.evaluations
    elif capture:
        steps = _captured_steps(model, params, method, learning_rate, max_iter)
        losses = steps.run(generator)
        launches = dict(steps.launches_per_step)
    else:
        opt = make_optimizer(method, params, learning_rate)
        losses = torch.empty((max_iter,), dtype=model.X.dtype, device=model.device)
        for idx in range(max_iter):
            losses[idx] = _step(model, opt, generator)
    fit_scan.last_run = {"captured": capture and method != "LBFGS", "steps": max_iter,
                         "launches_per_step": launches, "evaluations": evaluations}
    bad = torch.nonzero(~torch.isfinite(losses)).flatten()
    if bad.numel():
        _restore(params, start)
        raise _nonfinite_loss_error(int(bad[0]))
    return model, losses


#: What the last :func:`fit_scan` call ran: {"captured": bool, "steps": int,
#: "launches_per_step": {kernel: launches recorded in the captured step} or
#: None, "evaluations": L-BFGS's closure calls per iteration or None}.
fit_scan.last_run = None

#: The captured steps of each model, by cache key (a model's entries go with it).
_GRAPHS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _static_config(model):
    """The modules' plain settings (fast_jitter, batch_size, whiten, ...),
    which the captured step bakes in."""
    return tuple(
        (name, type(m).__name__,
         tuple(sorted((k, v) for k, v in vars(m).items() if isinstance(v, (bool, int, float, str, type(None))))))
        for name, m in model.named_modules()
    )


def _cache_key(model, params, method, learning_rate, max_iter):
    tensors = tuple((tuple(t.shape), t.dtype, str(t.device), t.data_ptr()) for t in (*params, *model.buffers()))
    return (method, learning_rate, settings.trace_key(), int(max_iter), tensors, _static_config(model))


def _captured_steps(model, params, method, learning_rate, max_iter):
    steps_by_key = _GRAPHS.setdefault(model, {})
    key = _cache_key(model, params, method, learning_rate, max_iter)
    steps = steps_by_key.get(key)
    if steps is None:
        steps = steps_by_key[key] = _CapturedSteps(model, params, method, learning_rate, max_iter)
    return steps


def release_graphs(model) -> None:
    """Drop the CUDA graphs :func:`fit_scan` captured for ``model`` (and
    the device memory their pools hold)."""
    _GRAPHS.pop(model, None)


def _reset_optimizer_state(opt):
    """An optimizer's state as at its creation, in place: zeros (step
    counts, moments, momentum buffers -- a zero buffer gives SGD's first
    step exactly), and Adagrad's initial accumulator."""
    for group in opt.param_groups:
        for p in group["params"]:
            for name, t in opt.state[p].items():
                if isinstance(opt, OptaxAdagrad) and name == "sum":
                    t.fill_(group["initial"])
                elif isinstance(t, torch.Tensor):
                    t.zero_()


class _CapturedSteps:
    """One training step of ``model`` captured as a CUDA graph.

    Made once per cache key: one eager step on a side stream builds the
    kernels, the library handles and the optimizer's state, the parameters
    are put back, and the step is captured.  Its generator is a private
    one registered with the graph; each :meth:`run` copies the caller's
    generator state into it and back, so the batches are the eager loop's.
    The entry holds no reference to the model."""

    def __init__(self, model, params, method, learning_rate, max_iter):
        device = model.device
        self.max_iter = int(max_iter)
        self.opt = make_optimizer(method, params, learning_rate, capturable=True)
        self.generator = torch.Generator(device=device)
        self.losses = torch.zeros((self.max_iter,), dtype=model.X.dtype, device=device)
        self.index = torch.zeros((1,), dtype=torch.long, device=device)
        opt, gen, losses, index = self.opt, self.generator, self.losses, self.index

        def step():
            opt.zero_grad(set_to_none=True)
            lval = model._loss(generator=gen)
            lval.backward()
            opt.step()
            losses.index_copy_(0, index, lval.detach().reshape(1).to(losses.dtype))
            index.add_(1)

        start = _snapshot(params)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(device).wait_stream(side)
        _restore(params, start)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(gen)
        before = ops.launch_counts()
        with torch.cuda.graph(self.graph):
            step()
        after = ops.launch_counts()
        self.launches_per_step = {k: after[k] - before[k] for k in after}

    def run(self, generator) -> torch.Tensor:
        """``max_iter`` replays from a fresh optimizer state and
        ``generator``'s state; returns the losses and advances
        ``generator`` past the draws."""
        _reset_optimizer_state(self.opt)
        self.index.zero_()
        self.generator.set_state(generator.get_state())
        for _ in range(self.max_iter):
            self.graph.replay()
        generator.set_state(self.generator.get_state())
        # the gradients live in the graph's pool; a later eager backward
        # allocates its own
        self.opt.zero_grad(set_to_none=True)
        return self.losses.clone()


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
