"""Bayesian optimisation on top of the GP models.

Counterpart of ``gptorch_tpu/bayesopt.py``: closed-form acquisition
functions over a model's cached posterior, batched candidate scoring, the
gradient refinement of a candidate through the posterior, Thompson and
Monte-Carlo q-EI batch proposals through posterior function samples, and a
suggest-evaluate-refit loop (:class:`BayesOpt`).

Minimisation throughout: the incumbent is ``best = min(y)`` and the
improvement is ``best − f``.

Where the JAX package takes a PRNG ``key``, the port takes a
``torch.Generator`` on the posterior's device (``generator=None`` takes
:func:`~gptorch_tpu_torch.settings.next_default_generator`), and every
draw goes through :func:`~gptorch_tpu_torch.sampling.uniform` or
``standard_normal``.  The refinements (a ``lax.scan`` in the JAX package)
are Python loops of ``torch.autograd.grad`` through the posterior's
``predict_f`` or the sampled paths; each keeps its iterate on the device,
and "keep the refinement only if it helped" is a ``torch.where``, so the
loops read nothing back to the host.  On the card an Rbf posterior's
cross Grams K(X, x) -- the candidates' and each refinement step's, with
its backward in x -- are launches of the Gram kernel
(:mod:`~gptorch_tpu_torch.ops.gram`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

from . import sampling, settings

_SQRT2 = math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _norm_pdf(z):
    return _INV_SQRT_2PI * torch.exp(-0.5 * z * z)


def _norm_cdf(z):
    return 0.5 * (1.0 + torch.erf(z / _SQRT2))


def _max(x, c):
    """``jnp.maximum(x, c)`` for a number ``c``, ties splitting the gradient
    as JAX's do."""
    return torch.maximum(x, torch.full_like(x, c))


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)`` for numbers ``lo`` and ``hi``."""
    return torch.minimum(_max(x, lo), torch.full_like(x, hi))


def _safe_sd(var, fill):
    """√var with NaN-free gradients at var <= 0.

    The naive ``sqrt(clamp(var, 0))`` has an infinite sqrt-VJP at the
    clamp, and a downstream ``where`` cannot mask it (0·inf = NaN).  Double
    ``where``: the dead branch differentiates sqrt at 1.0 (finite), and the
    outer ``where`` zeroes its cotangent.

    :return: (positive-mask, sd) where sd = √var when var > 0 else fill.
    """
    pos = var > 0.0
    sd = torch.sqrt(torch.where(pos, var, torch.ones_like(var)))
    return pos, torch.where(pos, sd, torch.full_like(sd, fill))


def _as_moments(mean, var, best):
    """(mean, var, best) as tensors of mean's dtype and device."""
    mean = torch.as_tensor(mean)
    var = torch.as_tensor(var, dtype=mean.dtype, device=mean.device)
    if not isinstance(best, torch.Tensor):
        best = torch.as_tensor(np.asarray(best, dtype=float), dtype=mean.dtype, device=mean.device)
    return mean, var, best


def expected_improvement(mean, var, best, xi=0.0):
    """EI(x) = E[max(best − ξ − f(x), 0)] (minimisation), closed form:

        EI = (best − ξ − μ)·Φ(z) + σ·φ(z),  z = (best − ξ − μ)/σ.

    Degenerate σ → 0 returns max(best − ξ − μ, 0) exactly, with finite
    gradients (posterior variances round slightly negative near the
    training points, exactly where the EI optimum sits late in a run).
    """
    mean, var, best = _as_moments(mean, var, best)
    imp = best - xi - mean
    tiny = torch.finfo(mean.dtype).tiny
    pos, sd = _safe_sd(var, 1.0)  # dead-branch sd = 1: z stays finite
    z = _clip(imp / _max(sd, tiny), -1e6, 1e6)
    ei = imp * _norm_cdf(z) + sd * _norm_pdf(z)
    return torch.where(pos, ei, _max(imp, 0.0))


def log_expected_improvement(mean, var, best, xi=0.0):
    """log EI, stable far from the incumbent (where EI underflows): with
    EI = σ·h(z), h(z) = zΦ(z) + φ(z), log h is taken directly where h is
    representable and by its Mills-ratio asymptote φ(z)/z² below that."""
    mean, var, best = _as_moments(mean, var, best)
    tiny = torch.finfo(mean.dtype).tiny
    _, sd = _safe_sd(var, tiny)
    sd = _max(sd, tiny)
    imp = best - xi - mean
    # the clip keeps z·Φ(z) and z² out of inf (inf·0 = NaN) in float32
    z = _clip(imp / sd, -1e6, 1e6)
    log_phi = -0.5 * z * z - 0.5 * math.log(2.0 * math.pi)
    h = z * _norm_cdf(z) + _norm_pdf(z)
    safe = h > tiny**0.5
    log_h = torch.where(safe, torch.log(_max(h, tiny)), log_phi - 2.0 * torch.log(_max(-z, 1.0)))
    return torch.log(sd) + log_h


def probability_of_improvement(mean, var, best, xi=0.0):
    """PI(x) = P(f(x) < best − ξ)."""
    mean, var, best = _as_moments(mean, var, best)
    tiny = torch.finfo(mean.dtype).tiny
    _, sd = _safe_sd(var, tiny)
    z = _clip((best - xi - mean) / _max(sd, tiny), -1e6, 1e6)
    return _norm_cdf(z)


def upper_confidence_bound(mean, var, best=None, beta=2.0):
    """LCB for minimisation (named UCB by convention): −(μ − √β·σ), larger
    is better like the other acquisitions."""
    mean, var, _ = _as_moments(mean, var, 0.0)
    _, sd = _safe_sd(var, 0.0)
    return -(mean - math.sqrt(beta) * sd)


ACQUISITIONS = {
    "ei": expected_improvement,
    "logei": log_expected_improvement,
    "pi": probability_of_improvement,
    "ucb": upper_confidence_bound,
}


def _acquisition(acquisition):
    return ACQUISITIONS[acquisition] if isinstance(acquisition, str) else acquisition


def score_candidates(posterior, X_cand, best, acquisition="ei", **kwargs):
    """Acquisition values over a candidate batch, (n_cand,), from one
    batched ``posterior.predict_f(X_cand, diag=True)`` (a cached posterior,
    ``model.posterior()``, or anything with that method)."""
    mean, var = posterior.predict_f(X_cand, diag=True)
    mean = torch.as_tensor(mean)[:, 0]
    var = torch.as_tensor(var)
    var = var[:, 0] if var.ndim > 1 else var
    return _acquisition(acquisition)(mean, var, best, **kwargs)


def _posterior(model):
    return model.posterior() if hasattr(model, "posterior") else model


def _reference(post) -> torch.Tensor:
    """A tensor whose dtype and device the candidates take: the posterior's
    inputs (the library default float on the CPU for an object without)."""
    ref = getattr(post, "_input_reference", None)
    return ref() if ref is not None else torch.zeros((), dtype=settings.default_float())


def _box(bounds, ref):
    """(d, lo, hi) of a (d, 2) box, lo and hi as tensors like ``ref``."""
    bounds = np.asarray(bounds, dtype=float)
    if bounds.ndim == 1:
        bounds = bounds[None, :]
    lo, hi = (torch.as_tensor(bounds[:, i], dtype=ref.dtype, device=ref.device) for i in (0, 1))
    return bounds.shape[0], lo, hi


def _candidates(generator, n, lo, hi):
    """``n`` uniform points in the box [lo, hi]."""
    u = sampling.uniform(generator, (n, lo.shape[0]), lo)
    return lo[None] + u * (hi - lo)[None]


def _row_normalized(g):
    """Each row of ``g`` over its largest absolute entry (sign-free steps)."""
    return g / torch.clamp(torch.amax(torch.abs(g), dim=-1, keepdim=True), min=1e-30)


def _gradient(fn, x):
    """∂ fn(x) / ∂x for a scalar ``fn``, detached."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        return torch.autograd.grad(fn(x), x)[0]


def suggest(
    model,
    bounds,
    acquisition: str = "ei",
    n_candidates: int = 4096,
    refine_steps: int = 25,
    refine_lr: float = 0.05,
    generator: Optional[torch.Generator] = None,
    **acq_kwargs,
):
    """Propose the next evaluation point.

    1. score ``n_candidates`` uniform random points in ``bounds`` with one
       batched posterior call;
    2. ascend the acquisition from the best candidate for ``refine_steps``
       normalised gradient steps through the posterior's ``predict_f``,
       projected back into the box, and keep the result only if its
       acquisition is at least the best candidate's.

    :param model: a fitted model with ``posterior()`` and training targets
        ``Y`` (the incumbent is ``min(model.Y)``).
    :param bounds: (d, 2) array of [low, high] per input dimension.
    :return: (d,) numpy array, the suggested point.
    """
    post = _posterior(model)
    ref = _reference(post)
    if generator is None:
        generator = settings.next_default_generator(ref.device)
    _, lo, hi = _box(bounds, ref)
    best = torch.min(torch.as_tensor(model.Y, dtype=ref.dtype, device=ref.device))
    acq = _acquisition(acquisition)

    X_cand = _candidates(generator, n_candidates, lo, hi)
    with torch.no_grad():
        scores = score_candidates(post, X_cand, best, acq, **acq_kwargs)
    x_best = X_cand[torch.argmax(scores)]
    x = x_best
    if refine_steps > 0:

        def neg_acq(x):
            mean, var = post.predict_f(x[None, :], diag=True)
            v = var[:, 0] if var.ndim > 1 else var
            return -acq(mean[0, 0], v[0], best, **acq_kwargs)

        step_scale = (hi - lo) * refine_lr
        for _ in range(refine_steps):
            x = torch.clamp(x - step_scale * _row_normalized(_gradient(neg_acq, x)), lo, hi)
        with torch.no_grad():
            x = torch.where(-neg_acq(x) >= torch.max(scores), x, x_best)
    return x.cpu().numpy()


def suggest_thompson(
    model,
    bounds,
    q: int = 1,
    n_candidates: int = 4096,
    num_features: int = 1024,
    refine_steps: int = 25,
    refine_lr: float = 0.05,
    generator: Optional[torch.Generator] = None,
):
    """Thompson-sampling proposals: draw ``q`` independent posterior function
    samples (``sample_paths``: random Fourier features and Matheron's rule)
    and minimise each over the box -- the argmin over a shared random
    candidate set, then projected gradient descent through the sampled path
    (Hernández-Lobato et al. 2017).  Each path's gradient at its own point
    is one ``grad`` of the sum of the diagonal of ``paths(x)`` over the q
    points.

    The draws: the paths' (features, weights, training noise), then the
    candidates.

    :param model: fitted model (or cached posterior) whose kernel has a
        spectral form (Rbf, the Matérn family, SpectralMixture).
    :return: (q, d) numpy array (or (d,) when q == 1).
    """
    post = _posterior(model)
    ref = _reference(post)
    if generator is None:
        generator = settings.next_default_generator(ref.device)
    _, lo, hi = _box(bounds, ref)
    paths = post.sample_paths(n_samples=q, num_features=num_features, generator=generator)
    X_cand = _candidates(generator, n_candidates, lo, hi)

    def own_values(x):
        """Path s at x_s for every s: (q,)."""
        return torch.diagonal(paths(x)[:, :, 0])

    with torch.no_grad():
        vals = paths(X_cand)[:, :, 0]  # (q, n_cand)
    best0, idx = torch.min(vals, dim=1)
    x0 = X_cand[idx]  # (q, d)
    if refine_steps > 0:
        step_scale = (hi - lo) * refine_lr
        x1 = x0
        for _ in range(refine_steps):
            g = _gradient(lambda x: torch.sum(own_values(x)), x1)
            x1 = torch.clamp(x1 - step_scale[None] * _row_normalized(g), lo, hi)
        with torch.no_grad():
            x0 = torch.where((own_values(x1) <= best0)[:, None], x1, x0)
    out = x0.cpu().numpy()
    return out[0] if q == 1 else out


def qei_mc(paths, X_batch, best):
    """Monte-Carlo q-EI of a joint batch (minimisation):

        qEI(X) = E_s[ max(0, best − min_j f_s(x_j)) ]

    over posterior function samples ``paths`` (``sample_paths``); exact as
    S → ∞ and differentiable in the batch (the same paths at every
    evaluation: common random numbers)."""
    vals = paths(X_batch)[:, :, 0]  # (S, q)
    return torch.mean(_max(best - torch.amin(vals, dim=1), 0.0))


def suggest_qei(
    model,
    bounds,
    q: int = 2,
    best=None,
    n_samples: int = 128,
    n_candidates: int = 2048,
    num_features: int = 1024,
    refine_steps: int = 60,
    refine_lr: float = 0.05,
    generator: Optional[torch.Generator] = None,
):
    """Jointly optimal q-point batch by Monte-Carlo q-EI (Ginsbourger et al.
    2008): start from the argmins of q distinct sampled paths over a random
    candidate set, then ascend the joint MC objective by projected,
    row-normalised gradient steps, keeping the result only if it scores at
    least the start.

    The draws: the paths', then the candidates.

    :param best: incumbent (min observed y, standardised like the model's
        targets); default ``min(model.Y)``.
    :return: (q, d) numpy array.
    """
    post = _posterior(model)
    ref = _reference(post)
    if generator is None:
        generator = settings.next_default_generator(ref.device)
    _, lo, hi = _box(bounds, ref)
    if best is None:
        best = float(torch.as_tensor(model.Y).min())
    n_samples = max(int(n_samples), int(q))  # the start takes the argmins of q distinct paths
    paths = post.sample_paths(n_samples=n_samples, num_features=num_features, generator=generator)
    X_cand = _candidates(generator, n_candidates, lo, hi)
    with torch.no_grad():
        vals = paths(X_cand)[:, :, 0]  # (S, n_cand)
    x0 = X_cand[torch.argmin(vals[:q], dim=1)]  # (q, d)

    def objective(x):
        return qei_mc(paths, x, best)

    if refine_steps > 0:
        step_scale = (hi - lo) * refine_lr
        x1 = x0
        for _ in range(refine_steps):
            x1 = torch.clamp(x1 + step_scale[None] * _row_normalized(_gradient(objective, x1)), lo, hi)
        with torch.no_grad():
            x0 = torch.where(objective(x1) >= objective(x0), x1, x0)
    return x0.cpu().numpy()


class BayesOpt:
    """Suggest/observe loop: fit a GPR, propose, evaluate, repeat.

    >>> bo = BayesOpt(bounds=[[0, 1]], kernel=None)  # Matern52 default
    >>> for _ in range(20):
    ...     x = bo.suggest()
    ...     bo.observe(x, f(x))
    >>> bo.best_x, bo.best_y

    Observations are standardised before fitting (the GP sees zero-mean,
    unit-variance targets); suggestions and incumbents are in original
    units.  ``seed`` seeds one ``torch.Generator`` on ``device`` (the card
    unless ``device="cpu"``), from which every suggestion draws in turn.
    """

    def __init__(
        self,
        bounds,
        kernel: Optional[Callable] = None,
        acquisition: str = "ei",
        input_warp: bool = False,
        noise: float = 1e-4,
        fit_iters: int = 200,
        n_candidates: int = 4096,
        seed: int = 0,
        refit_every: int = 1,
        device=None,
    ):
        self.bounds = np.asarray(bounds, dtype=float)
        if self.bounds.ndim == 1:
            self.bounds = self.bounds[None, :]
        self.d = self.bounds.shape[0]
        self._kernel_factory = kernel
        #: wrap the surrogate kernel in a trainable Kumaraswamy input warp
        #: over the bounds box (Snoek et al. 2014)
        self.input_warp = bool(input_warp)
        if self.input_warp and acquisition == "ts":
            raise ValueError(
                "input_warp is incompatible with acquisition='ts': Thompson sampling draws pathwise RFF "
                "samples, which need a stationary kernel's spectral density (the warped kernel is "
                "non-stationary). Use 'ei'/'logei'/'pi'/'ucb', or suggest_batch(strategy='believer')."
            )
        self.acquisition = acquisition
        self.noise = noise
        self.fit_iters = fit_iters
        self.n_candidates = n_candidates
        #: refit the hyperparameters every k-th observation; in between the
        #: cached posterior is conditioned on the new point (condition_on,
        #: O(n²) instead of a refit).  1 (default) refits on every observe.
        self.refit_every = int(refit_every)
        self.device = settings.resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(int(seed))
        self.X: list = []
        self.Y: list = []
        self._model = None
        self._post = None
        self._n_fit = 0

    @property
    def best_idx(self):
        return int(np.argmin(np.asarray(self.Y)))

    @property
    def best_x(self):
        return np.asarray(self.X)[self.best_idx]

    @property
    def best_y(self):
        return float(np.asarray(self.Y)[self.best_idx])

    def observe(self, x, y):
        self.X.append(np.asarray(x, dtype=float).reshape(self.d))
        self.Y.append(float(y))
        if self._post is not None and len(self.Y) - self._n_fit < self.refit_every:
            # cheap path: condition the cached posterior on the new point in
            # the cached standardisation (hyperparameters unchanged)
            mu, sd = self._y_shift
            self._post = self._post.condition_on(
                np.asarray(x, dtype=float).reshape(1, self.d), np.asarray([[(float(y) - mu) / sd]])
            )
        else:
            self._model = None  # stale: full refit on the next suggest
            self._post = None

    def _fit(self):
        from . import kernels, likelihoods
        from .models import GPR

        X = np.asarray(self.X)
        Y = np.asarray(self.Y)[:, None]
        mu, sd = Y.mean(), max(Y.std(), 1e-12)
        Yn = (Y - mu) / sd
        span = self.bounds[:, 1] - self.bounds[:, 0]
        if self._kernel_factory is not None:
            kern = self._kernel_factory()
        elif self.input_warp:
            # the warped kernel lives in unit-box coordinates
            kern = kernels.InputWarp(
                kernels.Matern52(self.d, ARD=True, length_scales=0.2), lo=self.bounds[:, 0], hi=self.bounds[:, 1]
            )
        else:
            kern = kernels.Matern52(self.d, ARD=True, length_scales=0.2 * span)
        m = GPR(X, Yn, kern, likelihood=likelihoods.Gaussian(self.noise), fast=False, device=self.device)
        if self.fit_iters > 0 and len(self.Y) >= 3:
            m.fit_scan(method="Adam", max_iter=self.fit_iters, learning_rate=0.05)
        self._model = m
        self._y_shift = (mu, sd)
        self._post = m.posterior()
        self._n_fit = len(self.Y)
        return m

    def _uniform_points(self, shape):
        """Uniform points of ``shape`` (..., d) in the box, as numpy."""
        u = sampling.uniform(self.generator, shape, torch.zeros((), dtype=settings.default_float(),
                                                                device=self.device))
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return lo + u.cpu().numpy() * (hi - lo)

    def _standardized_y(self):
        mu, sd = self._y_shift
        return (np.asarray(self.Y)[:, None] - mu) / sd

    def suggest(self):
        """Next point to evaluate (uniform random until 2 observations exist,
        then acquisition-optimal; ``acquisition="ts"`` draws a posterior
        path and minimises it instead)."""
        if len(self.Y) < 2:
            return self._uniform_points((self.d,))
        if self._post is None:
            self._fit()
        if self.acquisition == "ts":
            return suggest_thompson(self._post, self.bounds, q=1, n_candidates=self.n_candidates,
                                    generator=self.generator)
        return suggest(_CachedPosterior(self._post, self._standardized_y()), self.bounds,
                       acquisition=self.acquisition, n_candidates=self.n_candidates, generator=self.generator)

    def suggest_batch(self, q: int, strategy: str = "ts"):
        """Propose ``q`` points to evaluate in parallel.

        * ``"ts"`` -- parallel Thompson sampling: q independent posterior
          path draws, each minimised (:func:`suggest_thompson`).
        * ``"believer"`` -- Kriging Believer (Ginsbourger et al. 2010):
          greedy sequential acquisition, each accepted point conditioned
          into the posterior at its predicted mean (``condition_on``), so
          later picks avoid earlier ones.
        * ``"qei"`` -- joint Monte-Carlo q-EI (:func:`suggest_qei`).

        :return: (q, d) numpy array.
        """
        if len(self.Y) < 2:
            return self._uniform_points((q, self.d))
        if self._post is None:
            self._fit()
        if strategy == "ts":
            out = suggest_thompson(self._post, self.bounds, q=q, n_candidates=self.n_candidates,
                                   generator=self.generator)
            return out[None] if q == 1 else out
        if strategy == "qei":
            if self.input_warp:
                raise ValueError(
                    "strategy='qei' draws pathwise RFF samples, which need a stationary kernel (input_warp is "
                    "non-stationary); use strategy='believer'"
                )
            mu, sd = self._y_shift
            return suggest_qei(self._post, self.bounds, q=q, best=float((min(self.Y) - mu) / sd),
                               n_candidates=self.n_candidates, generator=self.generator)
        if strategy != "believer":
            raise ValueError(f"unknown batch strategy {strategy!r}")
        yn = self._standardized_y()
        post = self._post  # a local fantasy chain; self._post stays real
        acq = self.acquisition if self.acquisition != "ts" else "ei"
        picks = []
        for _ in range(q):
            x = suggest(_CachedPosterior(post, yn), self.bounds, acquisition=acq, n_candidates=self.n_candidates,
                        generator=self.generator)
            picks.append(x)
            y_lie, _ = post.predict_f(x[None, :])
            post = post.condition_on(x[None, :], y_lie)
            yn = np.concatenate([yn, y_lie], axis=0)
        return np.stack(picks, axis=0)


class _CachedPosterior:
    """Adapter handing a (possibly fantasy-conditioned) cached posterior and
    the standardised incumbents to :func:`suggest` (which expects a
    model-shaped object with ``posterior()`` and ``Y``)."""

    def __init__(self, post, Y):
        self._post = post
        self.Y = Y

    def posterior(self):
        return self._post
