"""TPR: Student-t process regression (Shah, Wilson & Ghahramani 2014).

Counterpart of ``gptorch_tpu/models/studentt.py``: y ~ MVT_ν(m(X), K + σ²I)
with trainable degrees of freedom ν > 2,

    log p(y) = log Γ((ν+n)/2) − log Γ(ν/2) − (n/2) log((ν−2)π)
               − ½ log|Kyy| − ((ν+n)/2) log(1 + β/(ν−2)),   β = rᵀ Kyy⁻¹ r,

per output column.  The conditional f* | y is multivariate-t with ν + n
degrees of freedom, the GP's mean, and the GP's covariance scaled by
(ν + β − 2)/(ν + n − 2).  One Cholesky of Kyy (K1 builds an Rbf's Gram with
the noise on its diagonal on the card).
"""

from __future__ import annotations

import math

import torch

from .. import kernels as _k
from .. import settings
from ..bijectors import Chain, Exp, Shift
from ..functions import add_diag, cholesky, lt_log_determinant, trtrs
from ..likelihoods import Gaussian
from ..param import Param
from ..sampling import standard_normal, uniform
from .base import GPModel, _coerce_io

#: Proposals per draw of :func:`_gamma_draws`; Marsaglia–Tsang accepts each
#: with probability above 0.95 for a shape of at least 1, so all of them
#: fail with probability below 1e-20.
_GAMMA_PROPOSALS = 16


def _gamma_draws(generator, shape_param, size, like):
    """Gamma(shape_param, 1) draws (``shape_param`` ≥ 1, a 0-d tensor) of
    ``size`` from ``generator`` by Marsaglia and Tsang's method (2000), with
    a fixed number of proposals per draw: the first accepted one is kept, so
    the draw reads nothing back to the host."""
    d = shape_param - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    x = standard_normal(generator, (_GAMMA_PROPOSALS,) + tuple(size), like)
    u = uniform(generator, (_GAMMA_PROPOSALS,) + tuple(size), like)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(torch.clamp(v, min=1e-300)))
    first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)  # the first accepted proposal (0 if none)
    return d * torch.gather(v, 0, first)[0]


class TPR(GPModel):
    """Exact Student-t process regression.

    :param nu: initial degrees of freedom (> 2; trainable through ν = 2 +
        exp(raw)).  Small ν is heavy-tailed and robust; ν ≳ 30 is close to
        Gaussian.
    :param device: see :class:`~gptorch_tpu_torch.models.base.GPModel`.
    """

    def __init__(self, x, y, kernel, mean_function=None, likelihood=None, nu: float = 5.0, name: str = "tpr",
                 device=None):
        super().__init__(x, y, kernel, likelihood, mean_function, name, device=device)
        if not isinstance(self.likelihood, Gaussian):
            raise ValueError(
                "TPR folds Gaussian-style noise into the joint t covariance; pass a Gaussian likelihood (its "
                "variance is the σ² in Kyy)"
            )
        if nu <= 2.0:
            raise ValueError("nu must exceed 2 (finite covariance)")
        self.nu = Param(torch.tensor(float(nu), dtype=settings.default_float(), device=self.device),
                        transform=Chain([Shift(2.0), Exp()]))

    def _sigma2(self):
        return self.likelihood.variance.value.reshape(())

    def _kyy_chol(self, x):
        """chol(K(x, x) + σ²I); an Rbf's noise rides in its Gram's diagonal."""
        noise = self._sigma2().to(x.dtype)
        if type(self.kernel) is _k.Rbf:
            return cholesky(self.kernel.K(x, diag=noise))
        return cholesky(add_diag(self.kernel.K(x), noise))

    def log_likelihood(self, x=None, y=None, generator=None):
        x = x if x is not None else self.X
        y = y if y is not None else self.Y
        n = y.shape[0]
        nu = self.nu.value.reshape(())
        L = self._kyy_chol(x)
        alpha = trtrs(y - self.mean_function(x), L)  # (n, p)
        beta = torch.sum(torch.square(alpha), dim=0)  # (p,) rᵀKyy⁻¹r per output
        half = 0.5 * (nu + n)
        const = torch.special.gammaln(half) - torch.special.gammaln(0.5 * nu) - 0.5 * n * torch.log(
            (nu - 2.0) * math.pi)
        return torch.sum(const - lt_log_determinant(L) - half * torch.log1p(beta / (nu - 2.0)))

    def _joint(self):
        """(L, V, scale): one factorization for every predictive quantity;
        scale = (ν + β − 2)/(ν + n − 2) per output."""
        n = self.X.shape[0]
        nu = self.nu.value.reshape(())
        L = self._kyy_chol(self.X)
        V = trtrs(self.Y - self.mean_function(self.X), L)
        beta = torch.sum(torch.square(V), dim=0)
        return L, V, (nu + beta - 2.0) / (nu + n - 2.0)

    def _conditional(self, x_new, diag):
        """The multivariate-t conditional: (mean, var_f, scale)."""
        L, V, scale = self._joint()
        A = trtrs(self.kernel.K(self.X, x_new), L)
        mean_f = A.T @ V + self.mean_function(x_new)
        if diag:
            base = (self.kernel.Kdiag(x_new) - torch.sum(A * A, dim=0))[:, None]
            return mean_f, base * scale[None, :], scale
        if self.Y.shape[1] != 1:
            raise NotImplementedError(
                "full-covariance TPR predictions support one output column (the per-output scales differ); use "
                "diag=True"
            )
        return mean_f, (self.kernel.K(x_new) - A.T @ A) * scale.reshape(()), scale

    def _predict(self, x_new, diag=True):
        mean_f, var_f, _ = self._conditional(x_new, diag)
        return mean_f, var_f

    def predictive_dof(self):
        """Degrees of freedom of the posterior predictive t marginals, ν + n."""
        return float(self.nu.value.detach().reshape(())) + self.X.shape[0]

    @_coerce_io
    def predict_log_density(self, input_new, y_new):
        """Held-out log density under the Student-t predictive marginals
        (ν + n degrees of freedom; the noise σ² under the same t scale)."""
        x_new = input_new[:, None] if input_new.ndim == 1 else input_new
        y_new = torch.as_tensor(y_new, dtype=self.Y.dtype, device=self.device)
        if y_new.ndim == 1:
            y_new = y_new[:, None]
        mean_f, var_f, scale = self._conditional(x_new, diag=True)
        nu = self.nu.value.reshape(())
        var_y = var_f + self._sigma2() * scale[None, :]
        dof = nu + self.X.shape[0]
        s2 = var_y * (dof - 2.0) / dof  # the t scale where var = s²·dof/(dof − 2)
        z2 = torch.square(y_new - mean_f) / s2
        return (torch.special.gammaln(0.5 * (dof + 1.0)) - torch.special.gammaln(0.5 * dof)
                - 0.5 * torch.log(math.pi * dof * s2) - 0.5 * (dof + 1.0) * torch.log1p(z2 / dof))

    def _sample(self, input_new, n_samples, generator, observed):
        """Multivariate-t draws (ν + n degrees of freedom): μ + chol(S) z
        √(dof/g), z ~ N(0, I), g ~ χ²_dof, S = cov·(dof − 2)/dof, the
        normals and the χ² draws (2·Gamma(dof/2)) from ``generator``."""
        if generator is None:
            generator = settings.next_default_generator(self.device)
        mean_f, cov, scale = self._conditional(input_new, diag=False)
        if observed:
            cov = add_diag(cov, self._sigma2() * scale.reshape(()))
        nu = self.nu.value.reshape(())
        dof = nu + self.X.shape[0]
        chol_s = cholesky(cov * (dof - 2.0) / dof)
        z = standard_normal(generator, (n_samples,) + tuple(mean_f.shape), mean_f)
        g = 2.0 * _gamma_draws(generator, 0.5 * dof, (n_samples, 1, 1), mean_f)
        return mean_f + (chol_s[None] @ z) * torch.sqrt(dof / g)

    @_coerce_io
    def predict_y(self, input_new, diag=True):
        """Observation posterior: σ² added under the t scale (the noise lives
        inside the joint t covariance)."""
        x_new = input_new[:, None] if input_new.ndim == 1 else input_new
        mean_f, var_f, scale = self._conditional(x_new, diag=diag)
        if diag:
            return mean_f, var_f + self._sigma2() * scale[None, :]
        return mean_f, add_diag(var_f, self._sigma2() * scale.reshape(()))
