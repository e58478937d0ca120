"""Likelihoods.

Counterpart of the Gaussian part of ``gptorch_tpu/likelihoods.py``: where
the reference gptorch passes distributions, (mean, variance) tensors are
passed.
"""

from __future__ import annotations

import math

import torch

from .module import Module
from .param import positive_param
from .util import as_array


class Likelihood(Module):
    """Factorizing observation model p(y | f)."""

    def logp(self, F, Y):
        """Pointwise log p(y | f)."""
        raise NotImplementedError

    def predict_mean_variance(self, mean_f, var_f):
        """Moments of p(y) = ∫ p(y|f) N(f; mean_f, var_f) df."""
        raise NotImplementedError

    def predict_mean_covariance(self, mean_f, cov_f):
        raise NotImplementedError

    def predict_log_density(self, mean_f, var_f, targets):
        """Pointwise log ∫ p(y*|f) N(f; mean_f, var_f) df."""
        raise NotImplementedError


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

    def predict_log_density(self, mean_f, var_f, targets):
        """Closed form: p(y*) = N(y*; mean_f, var_f + σ²)."""
        v = var_f + self._s()
        return -0.5 * (math.log(2.0 * math.pi) + torch.log(v) + torch.square(targets - mean_f) / v)
