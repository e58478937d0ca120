"""Gradient-enhanced exact GP regression (derivative observations).

Counterpart of ``gptorch_tpu/models/derivative.py``.  ``DerivativeGPR``
conditions on function values y ≈ f(x) and gradients g ≈ ∇f(x): (f, ∇f) is
jointly Gaussian with cross-covariances that are kernel derivatives,

    cov(f(x),      ∂f(x')/∂x'_e)  = ∂k(x, x')/∂x'_e
    cov(∂f(x)/∂x_c, ∂f(x')/∂x'_e) = ∂²k(x, x')/∂x_c ∂x'_e,

so exact inference is one Cholesky of the (n(1+d), n(1+d)) joint Gram.

The value block is ``kernel.K`` (K1 on the card for an Rbf).  The
derivative blocks are ``torch.func.grad`` and ``jacfwd`` of the kernel's
pair function (:meth:`~gptorch_tpu_torch.kernels.Kernel.pair`), mapped
over the pairs by ``torch.func.vmap``, on every device: the JAX package
differentiates its generic ``Rbf.K``, not the Pallas tile, and K1 computes
Grams, not pair derivatives.  Kernels that are not twice differentiable at
coincident inputs (Exp/Matern, the cosine-of-distance Periodic,
ExpSinSquared, White) are rejected at construction.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from .. import kernels as _kernels
from ..functions import add_diag, cholesky, lt_log_determinant, trtrs
from ..likelihoods import FixedNoiseGaussian, Gaussian
from ..param import positive_param
from ..util import as_array
from .base import GPModel, _coerce_io

#: kernel classes whose K is not C² at coincident inputs
_NON_SMOOTH = (
    _kernels.Exp,  # incl. Matern12
    _kernels.Matern32,
    _kernels.Matern52,
    _kernels.Periodic,
    _kernels.ExpSinSquared,
    _kernels.White,
)


def _assert_smooth(kernel):
    for mod in kernel.modules():
        if isinstance(mod, _NON_SMOOTH):
            raise ValueError(
                f"DerivativeGPR needs a kernel that is twice differentiable at coincident inputs; "
                f"{type(mod).__name__} is not (its √distance / white-noise form has no second derivative at r=0). "
                f"Use Rbf/RationalQuadratic/Linear/Polynomial/Cosine/SpectralMixture composites."
            )


def _pairs(fn, xa, xb):
    """``fn(xa[i], xb[j])`` for every pair, stacked as (na, nb, ...)."""
    return vmap(vmap(fn, (None, 0)), (0, None))(xa, xb)


class DerivativeGPR(GPModel):
    """Exact GP regression on joint (value, gradient) observations.

    :param x: (n, d) inputs.
    :param y: (n, 1) function values.
    :param dydx: (n, d) observed gradients ∂y/∂x at each input.
    :param kernel: any C² kernel (validated; see the module docstring).
    :param grad_variance: initial observation-noise variance of the
        gradient channels (trainable, positive); the value noise is the
        Gaussian likelihood's.
    :param device: see :class:`~gptorch_tpu_torch.models.base.GPModel`.

    The exact-GP surface (loss, training, ``predict_f``/``predict_y``,
    samples, ``predict_log_density``) plus :meth:`predict_grad`.
    """

    _supports_fixed_noise = True  # per-observation value noise in _noise_diag

    def __init__(self, x, y, kernel, dydx, likelihood=None, mean_function=None, grad_variance: float = 1e-4,
                 name: str = "dgpr", device=None):
        _assert_smooth(kernel)
        super().__init__(x, y, kernel, likelihood, mean_function, name, device=device)
        if not isinstance(self.likelihood, Gaussian):
            raise ValueError(
                "DerivativeGPR requires a Gaussian likelihood (the joint (f, ∇f) conditioning is exact only for "
                "Gaussian noise)"
            )
        if self.Y.shape[1] != 1:
            raise ValueError(f"DerivativeGPR supports a single output column (got dy={self.Y.shape[1]})")
        dydx = dydx if isinstance(dydx, torch.Tensor) else np.asarray(dydx)
        if tuple(dydx.shape) != tuple(self.X.shape):
            raise ValueError(f"dydx must be (n, d)={tuple(self.X.shape)}, got {tuple(dydx.shape)}")
        self.register_buffer("dYdX", as_array(dydx, dtype=self.X.dtype, device=self.device))
        self.grad_variance = positive_param(as_array(float(grad_variance), device=self.device))

    # -- the kernel-derivative blocks ----------------------------------------

    def _cross_blocks(self, xa, xb):
        """[k(xa, xb), ∂k(xa, x_j)/∂x_j] → (na, nb(1+d)): the covariance of
        f(xa) with the joint (f, ∇f) observations at xb."""
        Kfg = _pairs(grad(self.kernel.pair, argnums=1), xa, xb)  # (na, nb, d)
        return torch.cat([self.kernel.K(xa, xb), Kfg.reshape(xa.shape[0], -1)], dim=1)

    def _grad_cross_blocks(self, xa, xb):
        """[∂k(xa_i, ·)/∂xa_c, ∂²k/∂xa_c∂x_j_e] → (na·d, nb(1+d)): the
        covariance of ∇f(xa) with the joint observations at xb."""
        kfun = self.kernel.pair
        Kgf = _pairs(grad(kfun, argnums=0), xa, xb)  # (na, nb, c)
        H = _pairs(jacfwd(grad(kfun, argnums=1), argnums=0), xa, xb)  # (na, nb, e, c)
        na, nb, d = xa.shape[0], xb.shape[0], xa.shape[1]
        left = Kgf.permute(0, 2, 1).reshape(na * d, nb)
        right = H.permute(0, 3, 1, 2).reshape(na * d, nb * d)
        return torch.cat([left, right], dim=1)

    def _joint_gram(self, x):
        """(N, N) joint covariance of (f(x), ∇f(x)), N = n(1+d)."""
        kfun = self.kernel.pair
        n, d = x.shape
        Kff = self.kernel.K(x)
        Kfg = _pairs(grad(kfun, argnums=1), x, x).reshape(n, n * d)
        # H[i, j, e, c] = ∂²k(x_i, x_j)/∂x_j_e ∂x_i_c → [(i, c), (j, e)]
        H = _pairs(jacfwd(grad(kfun, argnums=1), argnums=0), x, x)
        Kgg = H.permute(0, 3, 1, 2).reshape(n * d, n * d)
        top = torch.cat([Kff, Kfg], dim=1)
        bottom = torch.cat([Kfg.T, Kgg], dim=1)
        return torch.cat([top, bottom], dim=0)

    def _mean_grad(self, x):
        """∇m at each row of x: (n, d)."""
        mean_function = self.mean_function
        return vmap(grad(lambda a: mean_function(a[None, :])[0, 0]))(x)

    def _joint_mean(self, x):
        """(N, 1) mean of the joint observations (the mean function and its
        gradient)."""
        m = self.mean_function(x)  # (n, 1)
        return torch.cat([m.reshape(-1), self._mean_grad(x).reshape(-1)])[:, None]

    def _noise_diag(self, n, d, dtype):
        if isinstance(self.likelihood, FixedNoiseGaussian):
            # per-observation value noise (known measurement errors)
            sy_diag = self.likelihood.noise_diag(n).to(dtype)
        else:
            sy_diag = self.likelihood.variance.value.reshape(()).expand(n).to(dtype)
        sg = self.grad_variance.value.reshape(()).expand(n * d).to(dtype)
        return torch.cat([sy_diag, sg])

    def _factor(self, x, y, dydx):
        n, d = x.shape
        A = self._joint_gram(x)
        L = cholesky(add_diag(A, self._noise_diag(n, d, A.dtype)))
        z = torch.cat([y.reshape(-1), dydx.reshape(-1)])[:, None]
        return L, trtrs(z - self._joint_mean(x), L)

    # -- the exact-GP surface ---------------------------------------------

    def log_likelihood(self, x=None, y=None, generator=None):
        """The joint exact log marginal likelihood over the n(1+d)
        observations."""
        if x is not None or y is not None:
            raise ValueError(
                "DerivativeGPR trains on its stored (X, Y, dYdX); minibatching the joint Gram is not defined"
            )
        L, V = self._factor(self.X, self.Y, self.dYdX)
        N = V.shape[0]
        return -0.5 * torch.sum(torch.square(V)) - lt_log_determinant(L) - 0.5 * N * math.log(2.0 * math.pi)

    def _predict(self, x_new, diag=True):
        L, V = self._factor(self.X, self.Y, self.dYdX)
        A = trtrs(self._cross_blocks(x_new, self.X).T, L)  # (N, m)
        mean_f = A.T @ V + self.mean_function(x_new)
        if diag:
            var_f = (self.kernel.Kdiag(x_new) - torch.sum(A * A, dim=0))[:, None].expand(mean_f.shape)
        else:
            var_f = self.kernel.K(x_new) - A.T @ A
        return mean_f, var_f

    @_coerce_io
    def predict_grad(self, input_new):
        """Posterior moments of the gradient ∇f at new inputs: (mean (m, d),
        var (m, d)); the prior gradient variance is the Hessian diagonal
        ∂²k/∂x_c∂x'_c at x' = x."""
        x_new = input_new
        L, V = self._factor(self.X, self.Y, self.dYdX)
        A = trtrs(self._grad_cross_blocks(x_new, self.X).T, L)  # (N, m·d)
        m, d = x_new.shape
        gmean = (A.T @ V).reshape(m, d) + self._mean_grad(x_new)
        d2k = jacfwd(grad(self.kernel.pair, argnums=1), argnums=0)
        prior = vmap(lambda a: torch.diagonal(d2k(a, a)))(x_new)  # (m, d)
        return gmean, prior - torch.sum(A * A, dim=0).reshape(m, d)
