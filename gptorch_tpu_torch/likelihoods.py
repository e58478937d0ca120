"""Likelihoods.

Counterpart of ``gptorch_tpu/likelihoods.py`` (the Gaussian family,
``Bernoulli`` and ``Poisson``): where the reference gptorch passes
distributions, (mean, variance) tensors are passed.  A non-conjugate
likelihood needs only :meth:`Likelihood.logp` (and, for predictive moments,
:meth:`~Likelihood.conditional_mean` / :meth:`~Likelihood.conditional_variance`):
the variational expectation and the predictive moments and density fall
back to Gauss-Hermite quadrature (:mod:`gptorch_tpu_torch.quadrature`).
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch
import torch.nn.functional as F_

from . import quadrature, settings
from .module import Module
from .param import positive_param
from .util import as_array


class Likelihood(Module):
    """Factorizing observation model p(y | f)."""

    quadrature_order: int = 20

    def logp(self, F, Y):
        """Pointwise log p(y | f)."""
        raise NotImplementedError

    def latent_init(self, Y):
        """Observations mapped to the latent function's scale, used to seed
        variational posteriors (SVGP's q(u) init); the identity here."""
        return Y

    def conditional_mean(self, F):
        """E[y | f]."""
        raise NotImplementedError

    def conditional_variance(self, F):
        """Var[y | f]."""
        raise NotImplementedError

    def predict_mean_variance(self, mean_f, var_f):
        """Moments of p(y) = ∫ p(y|f) N(f; mean_f, var_f) df by quadrature:
        E[y] = <E[y|f]>, Var[y] = <Var[y|f]> + Var[E[y|f]]."""
        order = self.quadrature_order
        ey = quadrature.gauss_hermite(self.conditional_mean, mean_f, var_f, order)
        ey2 = quadrature.gauss_hermite(
            lambda f: self.conditional_variance(f) + torch.square(self.conditional_mean(f)),
            mean_f, var_f, order,
        )
        return ey, ey2 - torch.square(ey)

    def predict_mean_covariance(self, mean_f, cov_f):
        raise NotImplementedError

    def propagate_log(self, mean_f, var_f, targets):
        """<log p(y|f)>_{q(f) = N(mean_f, var_f)} summed over elements, by
        quadrature; conjugate likelihoods override it in closed form."""
        vals = quadrature.gauss_hermite(
            lambda f: self.logp(f, targets[None, ...]), mean_f, var_f, self.quadrature_order
        )
        return torch.sum(vals)

    def predict_log_density(self, mean_f, var_f, targets):
        """Pointwise log ∫ p(y*|f) N(f; mean_f, var_f) df, shaped like
        ``targets``, by log-domain quadrature; conjugate likelihoods
        override it in closed form."""
        return quadrature.gauss_hermite_log(
            lambda f: self.logp(f, targets[None, ...]), mean_f, var_f, self.quadrature_order
        )


class Gaussian(Likelihood):
    """Spherical Gaussian likelihood with variance σ²."""

    def __init__(self, variance: float = 1.0):
        super().__init__()
        self.variance = positive_param(as_array(variance))

    def _s(self):
        return self.variance.value.reshape(())

    def logp(self, F, Y):
        """Pointwise N(Y; F, σ²) log-density."""
        s = self._s()
        return -0.5 * (math.log(2.0 * math.pi) + torch.log(s) + torch.square(Y - F) / s)

    def predict_mean_variance(self, mean_f, var_f):
        return mean_f, var_f + self._s()

    def predict_mean_covariance(self, mean_f, cov_f):
        n = cov_f.shape[-1]
        eye = torch.eye(n, dtype=cov_f.dtype, device=cov_f.device)
        return mean_f, cov_f + self._s() * eye

    def conditional_mean(self, F):
        return F

    def conditional_variance(self, F):
        return self._s().expand(F.shape)

    def propagate_log(self, mean_f, var_f, targets):
        """Closed form: −½ [n (log 2π + log σ²) + (Σ(y − μ)² + Σs) / σ²]."""
        s = self._s()
        n = targets.numel()
        return -0.5 * (
            n * (math.log(2.0 * math.pi) + torch.log(s))
            + (torch.sum(torch.square(targets - mean_f)) + torch.sum(var_f)) / s
        )

    def predict_log_density(self, mean_f, var_f, targets):
        """Closed form: p(y*) = N(y*; mean_f, var_f + σ²)."""
        v = var_f + self._s()
        return -0.5 * (math.log(2.0 * math.pi) + torch.log(v) + torch.square(targets - mean_f) / v)


class FixedNoiseGaussian(Gaussian):
    """Gaussian likelihood with known per-observation noise variances s and
    an optional learned homoscedastic part σ²: y_i | f_i ~ N(f_i, s_i + σ²).

    Only the exact GPR takes it (the other models refuse it when built);
    predictions at new inputs add only σ², the process's own noise.
    """

    def __init__(self, noise_variances, extra_variance: float = 1e-6, learn_extra: bool = True):
        Likelihood.__init__(self)
        nv = np.asarray(noise_variances, dtype=float).reshape(-1)
        if nv.size < 1 or (nv < 0).any():
            raise ValueError("noise_variances must be non-negative")
        self.register_buffer("fixed", as_array(nv))
        self.variance = positive_param(as_array(float(extra_variance)), trainable=bool(learn_extra))

    def extended(self, count: int) -> "FixedNoiseGaussian":
        """A copy whose known variances are followed by ``count`` zeros:
        rows observed with no known measurement noise, only the learned σ²
        (what a fantasy update appends)."""
        out = copy.deepcopy(self)
        out.fixed = torch.cat([self.fixed, self.fixed.new_zeros((int(count),))])
        return out

    def noise_diag(self, n: int):
        """The (n,) noise diagonal of the training rows."""
        if n != self.fixed.shape[0]:
            raise ValueError(
                f"FixedNoiseGaussian holds {self.fixed.shape[0]} per-observation variances but got n={n} rows"
            )
        return self.fixed + self._s()

    def logp(self, F, Y):
        """Pointwise log-density, defined on the full, ordered training set
        only (rows of Y aligned with ``noise_variances``)."""
        n = Y.shape[0] if Y.ndim == 1 else Y.shape[-2]
        s = self.noise_diag(n)
        if Y.ndim > 1:
            s = s[:, None]
        return -0.5 * (math.log(2.0 * math.pi) + torch.log(s) + torch.square(Y - F) / s)


class Bernoulli(Likelihood):
    """Bernoulli likelihood with a probit or logit link (GP classification
    through SVGP)."""

    def __init__(self, link: str = "probit"):
        super().__init__()
        if link not in ("probit", "logit"):
            raise ValueError("link must be 'probit' or 'logit'")
        self.link = link

    def invlink(self, F):
        if self.link == "probit":
            return 0.5 * (1.0 + torch.special.erf(F / math.sqrt(2.0)))
        return torch.sigmoid(F)

    @staticmethod
    def _sign(Y, dtype):
        """±1 for Y in {0, 1} or {−1, +1}: above 0.5 is the positive class."""
        return torch.where(Y > 0.5, 1.0, -1.0).to(dtype)

    def logp(self, F, Y):
        """Stable log Φ(±f) / log σ(±f): a naive log(1 − p) saturates and
        gives NaN gradients once |f| ≳ 9."""
        yf = self._sign(Y, F.dtype) * F
        if self.link == "probit":
            return torch.special.log_ndtr(yf)
        return F_.logsigmoid(yf)

    def conditional_mean(self, F):
        return self.invlink(F)

    def conditional_variance(self, F):
        p = self.invlink(F)
        return p * (1.0 - p)

    def latent_init(self, Y):
        # modest ± latent values for the two classes
        return self._sign(Y, settings.default_float())

    def predict_mean_variance(self, mean_f, var_f):
        if self.link == "probit":
            # closed form: <Φ(f)> = Φ(μ / √(1 + s))
            p = 0.5 * (1.0 + torch.special.erf(mean_f / torch.sqrt(2.0 * (1.0 + var_f))))
            return p, p * (1.0 - p)
        return super().predict_mean_variance(mean_f, var_f)

    def predict_log_density(self, mean_f, var_f, targets):
        if self.link == "probit":
            # closed form: p(y* = ±1) = Φ(±μ / √(1 + s))
            return torch.special.log_ndtr(self._sign(targets, mean_f.dtype) * mean_f / torch.sqrt(1.0 + var_f))
        return super().predict_log_density(mean_f, var_f, targets)


class Poisson(Likelihood):
    """Poisson likelihood with the exp link (counts regression)."""

    def logp(self, F, Y):
        return Y * F - torch.exp(F) - torch.special.gammaln(Y + 1.0)

    def conditional_mean(self, F):
        return torch.exp(F)

    def conditional_variance(self, F):
        return torch.exp(F)

    def latent_init(self, Y):
        # f = log rate: start near the log of the observed counts
        return torch.log1p(Y)

    def propagate_log(self, mean_f, var_f, targets):
        """Closed form for the exp link: <y f − e^f − log y!> =
        y μ − e^{μ + s/2} − log y!."""
        rate = torch.exp(mean_f + 0.5 * var_f)
        return torch.sum(targets * mean_f - rate - torch.special.gammaln(targets + 1.0))
