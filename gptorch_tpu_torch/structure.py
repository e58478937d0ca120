"""Compositional kernel structure discovery ("automatic statistician" lite).

Counterpart of ``gptorch_tpu/structure.py``: a greedy search over the
kernel grammar  K ::= B | K + B | K * B  (Duvenaud et al. 2013), scored by
BIC over the exact GP marginal likelihood.  Every candidate trains with
``fit_scan(method="LBFGS")`` by default (eager on the port, with host
reads per evaluation), and a child warm-starts from its trained parent's
kernel and likelihood.  Candidates that go non-finite score +inf and are
skipped.

Models here train in place, where the JAX package's are immutable: every
candidate and every restart trains its own ``copy.deepcopy`` of the kernel
and likelihood it starts from, so training a child moves neither its
parent nor the incumbent.

>>> result = kernel_search(x, y, bases=("Rbf", "Linear", "Cosine"), device="cpu")
>>> result.expression        # e.g. "(Linear + Cosine)"
>>> result.model.predict_y(x_new)
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from . import kernels as _kernels
from . import sampling, settings
from .models.gpr import GPR
from .module import get_trainable, pack_vector, set_trainable
from .training import fit as _fit

__all__ = ["bic", "aic", "kernel_search", "SearchResult", "SearchStep"]


def _num_params(model) -> int:
    """Number of trainable scalar parameters (BIC's k)."""
    return int(pack_vector(get_trainable(model)).size)


def _nlml(model) -> float:
    with torch.no_grad():
        return float(model.loss())


def bic(model) -> float:
    """Bayesian information criterion: 2·NLML + k·log(#observations).

    Lower is better.  ``model.loss()`` is the negative log marginal
    likelihood (minus the log prior, zero unless priors are set), the
    training objective."""
    return 2.0 * _nlml(model) + _num_params(model) * math.log(int(model.Y.numel()))


def aic(model) -> float:
    """Akaike information criterion: 2·NLML + 2k.  Lower is better."""
    return 2.0 * _nlml(model) + 2.0 * _num_params(model)


_CRITERIA = {"bic": bic, "aic": aic, "nlml": _nlml}


@dataclasses.dataclass
class SearchStep:
    """One scored candidate."""

    expression: str
    score: float
    nlml: float
    depth: int


@dataclasses.dataclass
class SearchResult:
    """The winning model and the full search trace."""

    model: GPR
    expression: str
    score: float
    history: list  # list[SearchStep], every candidate ever scored


def _base_kernel(spec: Union[str, Callable], input_dim: int):
    """A base kernel from a class name of :mod:`gptorch_tpu_torch.kernels`
    or a factory callable."""
    if callable(spec):
        return spec(input_dim)
    cls = getattr(_kernels, spec, None)
    if cls is None:
        raise ValueError(
            f"Unknown base kernel {spec!r}; pass a gptorch_tpu_torch.kernels class name (e.g. 'Rbf') or a "
            "callable input_dim -> Kernel"
        )
    return cls(input_dim)


def _spec_name(spec: Union[str, Callable]) -> str:
    return spec if isinstance(spec, str) else getattr(spec, "__name__", "custom")


def _train(x, y, kern, likelihood, *, method, max_iter, learning_rate, restarts, generator, jitter_scale, device):
    """Train one candidate; return (model, nlml) or (None, inf) on failure.

    Each restart trains a GPR on its own copies of ``kern`` and
    ``likelihood``.  Restart 0 keeps their values; later restarts move each
    unconstrained trainable by ``jitter_scale``·N(0, 1), drawn from
    ``generator`` in the order of the sorted trainable paths."""
    best_model, best_nlml = None, float("inf")
    for r in range(max(1, restarts)):
        model = GPR(x, y, copy.deepcopy(kern), likelihood=copy.deepcopy(likelihood), device=device)
        if r > 0:
            values = get_trainable(model)
            set_trainable(model, {
                k: values[k].detach() + jitter_scale * sampling.standard_normal(generator, values[k].shape, values[k])
                for k in sorted(values)
            })
        try:
            _fit.fit_scan(model, method=method, max_iter=max_iter, learning_rate=learning_rate)
            nlml = _nlml(model)
        except FloatingPointError:
            continue
        if math.isfinite(nlml) and nlml < best_nlml:
            best_model, best_nlml = model, nlml
    return best_model, best_nlml


def kernel_search(
    x,
    y,
    bases: Sequence[Union[str, Callable]] = ("Rbf", "Linear", "Cosine"),
    max_depth: int = 3,
    criterion: str = "bic",
    method: str = "LBFGS",
    max_iter: int = 150,
    learning_rate: Optional[float] = None,
    likelihood=None,
    restarts: int = 1,
    max_candidates: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    verbose: bool = False,
    device=None,
) -> SearchResult:
    """Greedy compositional kernel search over  K ::= B | K + B | K * B.

    Round 1 scores every base kernel; each later round expands the current
    best expression with ``+ B`` and ``* B`` for every base, warm-starting
    the shared subtree from (a copy of) the trained parent.  Stops when no
    child improves the criterion, after ``max_depth`` rounds, or once
    ``max_candidates`` candidates have trained (the incumbent so far is
    returned).  A full search trains ``|bases| + 2·|bases|·(max_depth−1)``
    candidates (15 by default).

    Parameters mirror :func:`~gptorch_tpu_torch.training.fit.fit_scan`;
    ``criterion`` is ``"bic"`` (default), ``"aic"`` or ``"nlml"``.  The
    restarts' perturbations draw from ``generator`` (default: seeded 0 on
    ``device``); the models live on ``device`` (the card unless
    ``device="cpu"``).
    """
    if criterion not in _CRITERIA:
        raise ValueError(f"criterion must be one of {sorted(_CRITERIA)}")
    score_fn = _CRITERIA[criterion]
    device = settings.resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    x = np.asarray(x)
    input_dim = int(x.shape[1]) if x.ndim > 1 else 1
    history: list = []

    class _Budget(Exception):
        pass

    def consider(kern, expr, depth, lik):
        if max_candidates is not None and len(history) >= max_candidates:
            raise _Budget()
        model, nlml = _train(
            x, y, kern, lik, method=method, max_iter=max_iter, learning_rate=learning_rate, restarts=restarts,
            generator=generator, jitter_scale=0.5, device=device,
        )
        score = score_fn(model) if model is not None else float("inf")
        history.append(SearchStep(expr, score, nlml, depth))
        if verbose:
            print(f"[depth {depth}] {expr}: {criterion}={score:.3f} nlml={nlml:.3f}")
        return model, score

    # depth 1: every base on its own
    best_model, best_expr, best_score = None, None, float("inf")
    try:
        for spec in bases:
            model, score = consider(_base_kernel(spec, input_dim), _spec_name(spec), 1, likelihood)
            if score < best_score:
                best_model, best_expr, best_score = model, _spec_name(spec), score
        if best_model is not None:
            # depths 2..max_depth: expand the incumbent
            for depth in range(2, max_depth + 1):
                parent_model, parent_expr = best_model, best_expr
                improved = False
                for spec in bases:
                    for op, sym in ((lambda a, b: a + b, "+"), (lambda a, b: a * b, "*")):
                        # warm start: _train copies the trained parent subtree
                        kern = op(parent_model.kernel, _base_kernel(spec, input_dim))
                        expr = f"({parent_expr} {sym} {_spec_name(spec)})"
                        model, score = consider(kern, expr, depth, parent_model.likelihood)
                        if score < best_score:
                            best_model, best_expr, best_score = model, expr, score
                            improved = True
                if not improved:
                    break
    except _Budget:
        pass  # candidate budget exhausted: return the incumbent so far
    if best_model is None:
        raise FloatingPointError(
            "kernel_search: every base kernel failed to train (or max_candidates exhausted before one trained); "
            "check the data scaling or pass an explicit likelihood noise"
        )
    return SearchResult(best_model, best_expr, best_score, history)
