"""Warped Gaussian-process regression (Snelson, Rasmussen & Ghahramani 2004).

Counterpart of ``gptorch_tpu/models/warped.py``.  Observations pass through
a learned monotone warp

    z = g(y) = y + Σ_t a_t · tanh(b_t (y + c_t)),     a_t, b_t > 0,

and a GP models the warped targets:

    log p(Y) = log N(g(Y) | 0, K_yy) + Σ_i log g'(y_i).

Predictions map the latent Gaussian back through g⁻¹ (a fixed 60 steps of
bisection, no host read): median and quantiles exactly, the predictive mean
by Gauss–Hermite quadrature over the latent Gaussian.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

from .. import kernels as _k
from ..functions import add_diag, cholesky, lt_log_determinant, trtrs
from ..module import Module
from ..param import Param, positive_param
from ..quadrature import gauss_hermite
from ..util import as_array
from .base import GPModel, _coerce_io


class TanhWarp(Module):
    """g(y) = y + Σ_t a_t tanh(b_t (y + c_t)); strictly increasing, since
    a_t, b_t > 0 keeps g' = 1 + Σ a_t b_t sech² > 0."""

    def __init__(self, n_terms: int = 3, seed: int = 0):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.a = positive_param(as_array(0.1 * np.ones(n_terms)))
        self.b = positive_param(as_array(np.ones(n_terms)))
        self.c = Param(as_array(rng.randn(n_terms) * 0.5))

    def forward(self, y):
        a, b, c = self.a.value, self.b.value, self.c.value
        return y + torch.sum(a * torch.tanh(b * (y[..., None] + c)), dim=-1)

    def log_dydz_jacobian(self, y):
        """Σ log g'(y) over all elements."""
        a, b, c = self.a.value, self.b.value, self.c.value
        sech2 = 1.0 - torch.square(torch.tanh(b * (y[..., None] + c)))
        return torch.sum(torch.log(1.0 + torch.sum(a * b * sech2, dim=-1)))

    def inverse(self, z, iters: int = 60):
        """g⁻¹ by bisection in a fixed number of steps (g is strictly
        increasing and |g(y) − y| ≤ Σ a_t, so [z − Σa − 1, z + Σa + 1]
        brackets the root)."""
        slack = torch.sum(self.a.value) + 1.0
        lo, hi = z - slack, z + slack
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            too_big = self(mid) > z
            lo = torch.where(too_big, lo, mid)
            hi = torch.where(too_big, mid, hi)
        return 0.5 * (lo + hi)


class WarpedGPR(GPModel):
    """GPR on monotonically warped observations.

    :param device: see :class:`~gptorch_tpu_torch.models.base.GPModel`.
    """

    def __init__(self, x, y, kernel, warp: TanhWarp | None = None, n_warp_terms: int = 3, likelihood=None,
                 name: str = "warped_gpr", device=None):
        super().__init__(x, y, kernel, likelihood, None, name, device=device)
        self.warp = (warp if warp is not None else TanhWarp(n_warp_terms)).to(self.device)

    def _kyy(self, x):
        """K(x, x) + σ²I; an Rbf's noise rides in its Gram's diagonal."""
        noise = self.likelihood.variance.value.reshape(()).to(x.dtype)
        if type(self.kernel) is _k.Rbf:
            return self.kernel.K(x, diag=noise)
        return add_diag(self.kernel.K(x), noise)

    def log_likelihood(self, x=None, y=None, generator=None):
        x = x if x is not None else self.X
        y = y if y is not None else self.Y
        n, dy = y.shape
        L = cholesky(self._kyy(x))
        alpha = trtrs(self.warp(y), L)
        gauss = (-0.5 * torch.sum(torch.square(alpha)) - dy * lt_log_determinant(L)
                 - 0.5 * dy * n * math.log(2.0 * math.pi))
        return gauss + self.warp.log_dydz_jacobian(y)

    def _latent_predict(self, x_new, diag=True):
        """Gaussian posterior over the warped (latent) observation space,
        observation noise included (diagonal whatever ``diag`` says, as in
        the JAX package)."""
        L = cholesky(self._kyy(self.X))
        A = trtrs(self.kernel.K(self.X, x_new), L)
        mean = A.T @ trtrs(self.warp(self.Y), L)
        var = (self.kernel.Kdiag(x_new) - torch.sum(A * A, dim=0) + self.likelihood.variance.value.reshape(()))
        return mean, var[:, None].expand(mean.shape)

    def _predict(self, x_new, diag=True):
        # latent moments (what predict_f gives, for the common API)
        return self._latent_predict(x_new, diag=diag)

    @_coerce_io
    def predict_quantiles(self, x_new, quantiles=(0.025, 0.5, 0.975)):
        """Observation-space quantiles g⁻¹(μ + Φ⁻¹(q)·σ): one (n, dy) array
        per requested quantile."""
        mean, var = self._latent_predict(x_new)
        std = torch.sqrt(var)
        return tuple(self.warp.inverse(mean + NormalDist().inv_cdf(q) * std) for q in quantiles)

    @_coerce_io
    def predict_mean(self, x_new, order: int = 30):
        """Observation-space predictive mean E[y*] = <g⁻¹(z)> by
        Gauss–Hermite quadrature over the latent Gaussian."""
        mean, var = self._latent_predict(x_new)
        return gauss_hermite(self.warp.inverse, mean, var, order=order)
