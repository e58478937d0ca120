"""Natural-gradient training for SVGP's variational distribution.

Counterpart of ``gptorch_tpu/training/natgrad.py`` (Salimbeni, Eleftheriadis
& Hensman 2018): natural-gradient steps on q(u) = Π_i N(m_i, S) in its
exponential-family coordinates, ordinary optimizer steps (optax's Adam
rule by default) on everything else.

With natural parameters θ₁ = S⁻¹M, θ₂ = −½S⁻¹ and expectation parameters
η₁ = M, η₂ = dy·S + MMᵀ, the loss gradients in expectation coordinates
follow from the ordinary ones (g_M, g_S) through S = (η₂ − η₁η₁ᵀ)/dy:

    dL/dη₁ = g_M − (2/dy)·g_S M,   dL/dη₂ = g_S / dy
    θ₁ ← θ₁ − γ·dL/dη₁,            S ← (S⁻¹ + 2γ·g_S/dy)⁻¹,   M ← S θ₁

With a Gaussian likelihood and full batches, one step at γ = 1 lands on
the optimal q(u): the SVGP ELBO then equals the collapsed VFE bound.  A
stacked q (LMC's ``q_mu`` (m, L) with ``q_chol`` (L, m, m)) takes one such
update per latent, each a dy = 1 distribution.

The port works in place: each step computes the loss with M and S as leaf
tensors (the model's q parameters replaced for that evaluation through
``torch.func.functional_call``), differentiates it with
``torch.autograd.grad`` and writes the new q and the optimizer's step into
the model's parameters.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np
import torch

from ..functions import cholesky, trtrs
from ..module import call_with_parameters, get_trainable
from .fit import _default_generator, make_optimizer

_Q_MEAN = "induced_output_mean"
_Q_CHOL = "induced_output_chol_cov"


def _default_q_groups(model, values):
    """(mean_name, chol_name) pairs of the model's Gaussian variational
    distributions: its ``variational_groups`` attribute, else the SVGP
    ``induced_output_*`` trainables."""
    declared = getattr(model, "variational_groups", None)
    if declared:
        groups = [tuple(g) for g in declared]
        missing = [n for g in groups for n in g if n not in values]
        if missing:
            raise ValueError(f"variational_groups names {missing} are not trainable parameters of the model")
        return groups
    if _Q_MEAN in values and _Q_CHOL in values:
        return [(_Q_MEAN, _Q_CHOL)]
    raise ValueError(
        "make_natgrad_step expects a model declaring its Gaussian variational distributions via a "
        "`variational_groups` attribute of (mean_name, chol_name) pairs (or the SVGP induced_output_* "
        "trainables)"
    )


def _split_values(values, groups):
    """(q values, hyperparameter values) of a trainable dictionary."""
    qnames = {name for g in groups for name in g}
    q = {k: values[k] for k in qnames}
    hyper = {k: v for k, v in values.items() if k not in qnames}
    return q, hyper


def _nat_update(M, S, Lq, g_M, g_S, gamma):
    """One natural-gradient step for q = Π_i N(M[:, i], S) (S shared over
    M's columns), from triangular factors only: q covariances are often
    conditioned at 1e6 and beyond, too badly to square in float32."""
    dy = M.shape[1]
    g_S = 0.5 * (g_S + g_S.T)
    eye = torch.eye(M.shape[0], dtype=M.dtype, device=M.device)
    Linv_q = trtrs(eye, Lq)
    Sinv = Linv_q.T @ Linv_q
    theta1 = Linv_q.T @ (Linv_q @ M)
    theta1_new = theta1 - gamma * (g_M - (2.0 / dy) * (g_S @ M))
    Sinv_new = Sinv + 2.0 * gamma * g_S / dy
    Sinv_new = 0.5 * (Sinv_new + Sinv_new.T)
    # S_new = Sinv_new⁻¹ = AᵀA with A = L_si⁻¹; M_new = S_new θ₁ by two products
    A = trtrs(eye, cholesky(Sinv_new, blocked=False))
    return A.T @ (A @ theta1_new), A.T @ A


def make_natgrad_step(
    model,
    nat_lr: float = 0.1,
    optimizer: Optional[Callable] = None,
    q_groups=None,
):
    """A combined step: the natural gradient on every Gaussian variational
    distribution of ``model`` and an ordinary optimizer step on every other
    trainable, both in place.

    :param optimizer: a factory ``params -> torch.optim.Optimizer`` for the
        hyperparameters (the counterpart of an optax transform); default
        :func:`~gptorch_tpu_torch.training.fit.make_optimizer`'s Adam at
        1e-2 (optax's rule).
    :param q_groups: (mean_name, chol_name) pairs; default the model's
        ``variational_groups``.

    Returns ``(step, opt)``: ``step(generator=None, lr=None)`` updates
    the model and returns the loss before the update (a 0-d tensor on the
    model's device); ``opt`` is the hyperparameters' optimizer.  A step
    size too large under minibatch noise can push S⁻¹ + 2γ·g_S/dy off the
    positive-definite cone (see :func:`fit_svgp_natgrad`).
    """
    params = dict(model.named_params())
    values0 = get_trainable(model)
    if q_groups is not None:
        groups = [tuple(g) for g in q_groups]
        bad = [n for g in groups for n in g if n not in values0]
        if bad:
            raise ValueError(
                f"q_groups names {bad} are not trainable parameters of the model (trainables: {sorted(values0)})"
            )
    else:
        groups = _default_q_groups(model, values0)
    _, hyper = _split_values(values0, groups)
    hyper_params = list({id(p): p for p in hyper.values()}.values())
    opt = (optimizer or (lambda p: make_optimizer("Adam", p, 1e-2)))(hyper_params)

    def step(generator=None, lr=None):
        gamma = nat_lr if lr is None else lr
        Ms, Ss, Lqs, swap = [], [], [], {}
        for mn, cn in groups:
            with torch.no_grad():
                Lq = params[cn].value
                M = params[mn].value.clone().requires_grad_()
                S = (Lq @ Lq.mT).requires_grad_()
            # the loss as a function of the distribution's parameters
            swap[f"{mn}.raw"] = params[mn].bijector.inverse(M)
            swap[f"{cn}.raw"] = params[cn].bijector.inverse(cholesky(S, blocked=False))
            Ms.append(M), Ss.append(S), Lqs.append(Lq)
        loss = call_with_parameters(model, swap, "_loss", generator=generator)
        grads = torch.autograd.grad(loss, Ms + Ss + hyper_params, allow_unused=True)
        k = len(groups)
        g_Ms, g_Ss, g_hyper = grads[:k], grads[k : 2 * k], grads[2 * k :]
        with torch.no_grad():
            for (mn, cn), M, S, Lq, g_M, g_S in zip(groups, Ms, Ss, Lqs, g_Ms, g_Ss):
                if Lq.ndim == 3:
                    # stacked per-latent q (LMC): M (m, L), chol (L, m, m);
                    # each latent an independent dy = 1 distribution
                    new = [_nat_update(M[:, l : l + 1], S[l], Lq[l], g_M[:, l : l + 1], g_S[l], gamma)
                           for l in range(Lq.shape[0])]
                    M_new = torch.cat([m for m, _ in new], dim=1)
                    S_new = torch.stack([s for _, s in new])
                else:
                    M_new, S_new = _nat_update(M, S, Lq, g_M, g_S, gamma)
                params[mn].set_raw(params[mn].bijector.inverse(M_new))
                params[cn].set_raw(params[cn].bijector.inverse(cholesky(S_new, blocked=False)))
        for p, g in zip(hyper_params, g_hyper):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    return step, opt


def fit_svgp_natgrad(
    model,
    n_steps: int = 200,
    nat_lr: float = 0.1,
    optimizer: Optional[Callable] = None,
    generator: Optional[torch.Generator] = None,
):
    """Natural-gradient training loop with step-size backoff, in place;
    returns (model, losses ndarray).

    A non-finite loss means the previous step left q(u) off the
    positive-definite cone: that step is rolled back (parameters and
    optimizer state) and γ halved.  When γ falls below 1e-5 the model and
    the optimizer are put back to their state on entry and
    ``FloatingPointError`` is raised.  Minibatches come from ``generator``
    (default: seeded 0 on the model's device).
    """
    step, opt = make_natgrad_step(model, nat_lr, optimizer)
    generator = generator if generator is not None else _default_generator(model)
    trainables = get_trainable(model)

    def snapshot():
        return {k: v.detach().clone() for k, v in trainables.items()}, copy.deepcopy(opt.state_dict())

    def restore(state):
        values, opt_state = state
        with torch.no_grad():
            for k, v in values.items():
                trainables[k].copy_(v)
        opt.load_state_dict(opt_state)

    gamma = float(nat_lr)
    prev = start = snapshot()
    losses = np.zeros(n_steps)
    i = 0
    while i < n_steps:
        before = snapshot()
        lval = float(step(generator, gamma))
        if not np.isfinite(lval):
            # the values before this step were already broken by the
            # previous accept: roll back one step and halve the step size
            gamma *= 0.5
            if gamma < 1e-5:
                restore(start)
                raise FloatingPointError(
                    "natural-gradient step size collapsed below 1e-5 without recovering a finite loss; "
                    "check the model/likelihood scales"
                )
            restore(prev)
            continue
        losses[i] = lval
        prev = before
        i += 1
    return model, losses
