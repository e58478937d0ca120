"""Likelihoods.

Counterpart of ``gptorch_tpu/likelihoods.py`` (the Gaussian family,
``Bernoulli``, ``Poisson``, ``StudentT``, ``Gamma``, ``Exponential``,
``Beta``, ``Ordinal`` and ``Softmax``): where the reference gptorch passes
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


class StudentT(Likelihood):
    """Student-t observation model (robust regression):
    p(y | f) = StudentT(y; loc f, scale √σ², df ν), with trainable σ²
    (``scale2``) and ν (``df``); expectations by quadrature."""

    def __init__(self, scale2: float = 1.0, df: float = 4.0):
        super().__init__()
        self.scale2 = positive_param(as_array(scale2))
        self.df = positive_param(as_array(df))

    def logp(self, F, Y):
        nu = self.df.value.reshape(())
        s2 = self.scale2.value.reshape(())
        z2 = torch.square(Y - F) / s2
        return (
            torch.special.gammaln(0.5 * (nu + 1.0))
            - torch.special.gammaln(0.5 * nu)
            - 0.5 * torch.log(nu * math.pi * s2)
            - 0.5 * (nu + 1.0) * torch.log1p(z2 / nu)
        )

    def conditional_mean(self, F):
        return F

    def conditional_variance(self, F):
        """ν σ² / (ν − 2), finite for ν > 2."""
        nu = self.df.value.reshape(())
        return (nu * self.scale2.value.reshape(()) / (nu - 2.0)).expand(F.shape)


class Gamma(Likelihood):
    """Gamma observation model for positive data, y | f ~ Gamma(shape k,
    scale e^f), E[y | f] = k e^f, with a trainable shape k > 0 and the
    closed-form expectation under q(f) = N(μ, s):

        <log p(y|f)> = (k − 1) log y − k μ − y e^{−μ + s/2} − log Γ(k)
    """

    def __init__(self, shape: float = 1.0):
        super().__init__()
        self.shape = positive_param(as_array(float(shape)))

    def logp(self, F, Y):
        k = self.shape.value.reshape(())
        return (k - 1.0) * torch.log(Y) - k * F - Y * torch.exp(-F) - torch.special.gammaln(k)

    def conditional_mean(self, F):
        return self.shape.value.reshape(()) * torch.exp(F)

    def conditional_variance(self, F):
        return self.shape.value.reshape(()) * torch.exp(2.0 * F)

    def latent_init(self, Y):
        # f = log scale: start from the observations
        return torch.log(torch.clamp(Y, min=1e-6))

    def propagate_log(self, mean_f, var_f, targets):
        k = self.shape.value.reshape(())
        vals = ((k - 1.0) * torch.log(targets) - k * mean_f - targets * torch.exp(-mean_f + 0.5 * var_f)
                - torch.special.gammaln(k))
        return torch.sum(vals)


class Exponential(Gamma):
    """Exponential observation model: Gamma with the shape fixed at k = 1,
    y | f ~ Exp(rate e^{−f}), E[y | f] = e^f."""

    def __init__(self):
        super().__init__(shape=1.0)
        self.shape.trainable = False


class Beta(Likelihood):
    """Beta observation model for data in (0, 1): μ = invlink(f) (probit or
    logit) and y | f ~ Beta(μ c, (1 − μ) c) with a trainable concentration
    c > 0, Var[y | f] = μ(1 − μ)/(c + 1); expectations by quadrature."""

    def __init__(self, concentration: float = 10.0, link: str = "probit"):
        super().__init__()
        if link not in ("probit", "logit"):
            raise ValueError("link must be 'probit' or 'logit'")
        self.link = link
        self.concentration = positive_param(as_array(float(concentration)))

    def invlink(self, F):
        if self.link == "probit":
            return 0.5 * (1.0 + torch.special.erf(F / math.sqrt(2.0)))
        return torch.sigmoid(F)

    def logp(self, F, Y):
        c = self.concentration.value.reshape(())
        eps = 1e-6
        mu = torch.clamp(self.invlink(F), eps, 1.0 - eps)
        alpha, beta = mu * c, (1.0 - mu) * c
        return ((alpha - 1.0) * torch.log(Y) + (beta - 1.0) * torch.log1p(-Y) + torch.special.gammaln(c)
                - torch.special.gammaln(alpha) - torch.special.gammaln(beta))

    def conditional_mean(self, F):
        return self.invlink(F)

    def conditional_variance(self, F):
        mu = self.invlink(F)
        return mu * (1.0 - mu) / (self.concentration.value.reshape(()) + 1.0)

    def latent_init(self, Y):
        eps = 1e-4
        Yc = torch.clamp(Y, eps, 1.0 - eps)
        if self.link == "probit":
            return torch.special.ndtri(Yc)
        return torch.log(Yc) - torch.log1p(-Yc)


class Ordinal(Likelihood):
    """Ordered categories by cumulative probit: K classes cut from the
    latent by fixed increasing bin edges b_1 < … < b_{K−1} and a trainable
    noise scale σ,

        p(y = k | f) = Φ((b_{k+1} − f)/σ) − Φ((b_k − f)/σ),  b_0 = −∞, b_K = +∞.

    Targets are class ids 0..K−1, carried as floats and cast to an index
    where read; ``conditional_mean`` is the expected class index."""

    def __init__(self, bin_edges, sigma: float = 1.0):
        super().__init__()
        edges = np.atleast_1d(np.asarray(bin_edges, dtype=float))
        if edges.ndim != 1 or edges.size < 1:
            raise ValueError("bin_edges must be a 1-D array with >= 1 edge")
        if np.any(np.diff(edges) <= 0):
            raise ValueError("bin_edges must be strictly increasing")
        self.register_buffer("bin_edges", as_array(edges))
        self.num_classes = int(edges.size) + 1
        self.sigma = positive_param(as_array(float(sigma)))

    @staticmethod
    def _ndtr(x):
        """Φ(x) by the JAX package's formula, ½(1 + erf(x/√2)) near 0 and
        ½(2 − erfc(|x|/√2)) or ½ erfc(|x|/√2) beyond: the class
        probabilities are differences of Φ near 1, whose rounding this
        keeps the same as the reference's."""
        half_sqrt_2 = 0.5 * math.sqrt(2.0)
        w = x * half_sqrt_2
        z = torch.abs(w)
        y = torch.where(z < half_sqrt_2, 1.0 + torch.special.erf(w),
                        torch.where(w > 0.0, 2.0 - torch.special.erfc(z), torch.special.erfc(z)))
        return 0.5 * y

    def class_probs(self, F):
        """(..., K) class probabilities at latent F."""
        z = (self.bin_edges - F[..., None]) / self.sigma.value.reshape(())
        cdf = self._ndtr(z)
        pad = torch.ones(F.shape + (1,), dtype=cdf.dtype, device=cdf.device)
        return torch.diff(torch.cat([0.0 * pad, cdf, pad], dim=-1), dim=-1)

    def _classes(self, Y):
        return torch.clamp(Y.to(torch.long), 0, self.num_classes - 1)

    def logp(self, F, Y):
        probs = self.class_probs(F)
        k = self._classes(Y).expand(F.shape)
        p = torch.gather(probs, -1, k[..., None])[..., 0]
        return torch.log(torch.clamp(p, min=torch.finfo(probs.dtype).tiny))

    def conditional_mean(self, F):
        classes = torch.arange(self.num_classes, dtype=F.dtype, device=F.device)
        return torch.sum(self.class_probs(F) * classes, dim=-1)

    def conditional_variance(self, F):
        classes = torch.arange(self.num_classes, dtype=F.dtype, device=F.device)
        p = self.class_probs(F)
        return torch.sum(p * torch.square(classes), dim=-1) - torch.square(torch.sum(p * classes, dim=-1))

    def latent_init(self, Y):
        # mid-bin latent values, the end bins one unit beyond the last edges
        edges = self.bin_edges
        centers = torch.cat([edges[:1] - 1.0, 0.5 * (edges[1:] + edges[:-1]), edges[-1:] + 1.0])
        return centers[self._classes(Y)]


class Softmax(Likelihood):
    """Multiclass classification over C jointly evaluated latent GPs, with
    one-hot (n, C) targets (:meth:`one_hot` converts labels).

    The variational expectation is the closed-form log-sum-exp bound
    <log softmax_y(f)> ≥ μ_y − log Σ_c exp(μ_c + v_c/2), and the predictive
    class probabilities use MacKay's moderation
    p_c ∝ softmax(μ_c / √(1 + π v_c / 8))."""

    joint_outputs = True  # the C columns are one distribution, not independent GPs

    def __init__(self, num_classes: int):
        super().__init__()
        if num_classes < 2:
            raise ValueError("Softmax needs >= 2 classes")
        self.num_classes = int(num_classes)

    @staticmethod
    def one_hot(labels, num_classes: int):
        """(n,) or (n, 1) integer labels -> (n, C) one-hot floats (the
        library default float); an out-of-range label gives a zero row, as
        the JAX package's ``jax.nn.one_hot`` does."""
        labels = torch.as_tensor(np.asarray(labels) if not isinstance(labels, torch.Tensor) else labels)
        labels = labels.reshape(-1).to(torch.long)
        classes = torch.arange(int(num_classes), device=labels.device)
        return (labels[:, None] == classes[None, :]).to(settings.default_float())

    def _check(self, Y):
        if Y.shape[-1] != self.num_classes:
            raise ValueError(
                f"Softmax targets must be one-hot with C={self.num_classes} columns (got {Y.shape[-1]}); "
                "use Softmax.one_hot(labels, C)"
            )

    def logp(self, F, Y):
        """Row log-likelihood log softmax(F)·Y, shaped (..., 1) so that sums
        count each row once."""
        return torch.sum(Y * torch.log_softmax(F, dim=-1), dim=-1, keepdim=True)

    def conditional_mean(self, F):
        return torch.softmax(F, dim=-1)

    def conditional_variance(self, F):
        p = torch.softmax(F, dim=-1)
        return p * (1.0 - p)

    def latent_init(self, Y):
        return 2.0 * Y - 1.0

    def _moderated_logits(self, mean_f, var_f):
        return mean_f / torch.sqrt(1.0 + (math.pi / 8.0) * var_f)

    def propagate_log(self, mean_f, var_f, targets):
        """The closed-form lower bound on Σ_n <log softmax_{y_n}(f_n)>."""
        self._check(targets)
        bound = torch.sum(targets * mean_f, dim=-1) - torch.logsumexp(mean_f + 0.5 * var_f, dim=-1)
        return torch.sum(bound)

    def predict_mean_variance(self, mean_f, var_f):
        p = torch.softmax(self._moderated_logits(mean_f, var_f), dim=-1)
        return p, p * (1.0 - p)

    def predict_log_density(self, mean_f, var_f, targets):
        self._check(targets)
        logp = torch.log_softmax(self._moderated_logits(mean_f, var_f), dim=-1)
        return torch.sum(targets * logp, dim=-1, keepdim=True)
