"""Deep Gaussian processes (doubly stochastic variational inference).

Counterpart of ``gptorch_tpu/models/deep.py`` (Salimbeni & Deisenroth
2017): a composition of SVGP layers

    F_0 = X,   F_l ~ GP_l(m_l(F_{l-1}), k_l)   (each with inducing points)

trained by sampling the hidden layers with the reparameterization trick
and evaluating the last layer's expected log-likelihood in closed form:

    ELBO = E_{q(F_1..F_{L-1})}[ Σ_i <log p(y_i | f_L,i)>_{q(f_L | F_{L-1})} ]
           - Σ_l KL[q(u_l) ‖ p(u_l)]

Each layer carries the Salimbeni linear mean (identity, truncation or
zero-padding to the next width); q(u) covariances start at 1e-5·I.

The JAX package maps one stochastic pass over S keys with ``jax.vmap``.
Here the S samples are a leading axis that every layer takes natively:
a hidden layer's input F is (S, n, w), and its K(Z, F) is one batched
Gram of the S members (Z repeated along the sample axis), so on the card
an :class:`~gptorch_tpu_torch.kernels.Rbf` layer builds K(Z, F) for all
samples in one launch of ``csrc/rbf_gram.cu`` -- and the first layer,
whose input X is shared by the samples, one (m, n) Gram.  The normals
of each hidden layer are one draw of (S, n, w) through
:func:`~gptorch_tpu_torch.sampling.standard_normal`.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import kernels as _k
from .. import sampling as _sampling
from .. import settings
from ..bijectors import LowerCholesky
from ..functions import add_diag, cholesky, lt_log_determinant, trtrs
from ..likelihoods import Gaussian
from ..module import Module
from ..param import Param
from ..util import as_array, kmeans_centers
from .base import GPModel


def _salimbeni_mean(d_in: int, d_out: int) -> np.ndarray:
    """Fixed linear mean W: identity when widths match, truncated identity
    when narrowing, zero-padded identity when widening."""
    W = np.zeros((d_in, d_out))
    for i in range(min(d_in, d_out)):
        W[i, i] = 1.0
    return W


class _DGPLayer(Module):
    """One SVGP layer: q(u) = N(m, L_q L_qᵀ), one covariance shared by its
    d_out output units, not whitened (SVGP's algebra)."""

    def __init__(self, kernel, z_init, d_out: int, mean_W, jitter: float = 1e-6, device=None):
        super().__init__()
        z = as_array(np.asarray(z_init), device=device)
        m = z.shape[0]
        self.kernel = kernel.to(device)
        self.Z = Param(z)
        self.q_mu = Param(torch.zeros((m, d_out), dtype=z.dtype, device=device))
        self.q_sqrt = Param(1e-5 * torch.eye(m, dtype=z.dtype, device=device), transform=LowerCholesky())
        self.register_buffer("mean_W", as_array(np.asarray(mean_W), device=device))
        self.d_out = int(d_out)
        self.jitter = float(jitter)

    def _kuu_chol(self):
        Kuu = self.kernel.K(self.Z.value)
        return cholesky(add_diag(Kuu, self.jitter * torch.mean(torch.diagonal(Kuu))), blocked=False)

    def marginal(self, F, chol_kuu=None):
        """q(f | F) moments at inputs F (n, w) or, one set per sample,
        (S, n, w): mean and var shaped (..., n, d_out).  For F with a sample
        axis, K(Z, F) is one batched Gram."""
        chol_kuu = self._kuu_chol() if chol_kuu is None else chol_kuu
        z = self.Z.value
        if F.ndim == 3:
            z = z.expand((F.shape[0],) + tuple(z.shape))
        alpha = trtrs(self.kernel.K(z, F), chol_kuu).mT  # (..., n, m)
        beta = trtrs(self.q_sqrt.value, chol_kuu)
        mean = alpha @ trtrs(self.q_mu.value, chol_kuu) + F @ self.mean_W
        gamma = alpha @ beta
        kdiag = self.kernel.Kdiag(F.reshape(-1, F.shape[-1])).reshape(F.shape[:-1])
        var = kdiag - torch.sum(torch.square(alpha), dim=-1) + torch.sum(torch.square(gamma), dim=-1)
        var = torch.clamp(var, min=1e-12)
        return mean, var[..., None].expand(mean.shape)

    def kl(self, chol_kuu=None):
        """KL[q(u) ‖ p(u)] summed over the layer's output units."""
        chol_kuu = self._kuu_chol() if chol_kuu is None else chol_kuu
        m = self.Z.shape[0]
        Lq = self.q_sqrt.value
        trace = torch.sum(torch.square(trtrs(Lq, chol_kuu)))
        mahal = torch.sum(torch.square(trtrs(self.q_mu.value, chol_kuu)))
        return (self.d_out * (lt_log_determinant(chol_kuu) - lt_log_determinant(Lq) + 0.5 * (trace - m))
                + 0.5 * mahal)


class DeepGP(GPModel):
    """Doubly stochastic deep GP.

    :param x: (n, d) inputs.  :param y: (n, dy) targets.
    :param widths: hidden-layer widths, e.g. (2,) for one hidden layer of
        width 2 (the output layer's width is y.shape[1]).
    :param kernels_: one kernel per layer (len(widths) + 1); Rbf-ARD if
        omitted.
    :param num_inducing: inducing points per layer (k-means centres of x,
        carried through each layer's mean map).
    :param num_samples: Monte Carlo samples through the hidden layers in
        the ELBO.
    :param device: see :class:`~gptorch_tpu_torch.models.base.GPModel`.

    The base ``kernel`` slot holds an unused ``Rbf(d)``, as in the JAX
    package, so the two packages' trainable paths agree.
    """

    def __init__(
        self,
        x,
        y,
        widths: Sequence[int] = (),
        kernels_: Optional[List] = None,
        num_inducing: int = 32,
        likelihood=None,
        num_samples: int = 1,
        name: str = "deep_gp",
        device=None,
    ):
        x_host = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        if likelihood is None:
            y_host = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
            likelihood = Gaussian(variance=max(0.01 * float(y_host.var()), 1e-6))
        super().__init__(x, y, _k.Rbf(x_host.shape[1]), likelihood, None, name, device=device)

        dims = [self.input_dimension] + list(widths) + [self.output_dimension]
        n_layers = len(dims) - 1
        if kernels_ is None:
            kernels_ = [_k.Rbf(dims[l], ARD=True) for l in range(n_layers)]
        if len(kernels_) != n_layers:
            raise ValueError(f"need {n_layers} kernels, got {len(kernels_)}")

        # k-means inducing starts carried through the fixed mean maps
        z = kmeans_centers(np.asarray(x_host, dtype=float), min(num_inducing, x_host.shape[0]), perturb_if_fail=True)
        for l in range(n_layers):
            W = _salimbeni_mean(dims[l], dims[l + 1])
            setattr(self, f"layer{l}", _DGPLayer(kernels_[l], z, dims[l + 1], W, device=self.device))
            z = np.asarray(z) @ W

        self.num_layers = n_layers
        self.num_samples = int(num_samples)

    def _layers(self):
        return [getattr(self, f"layer{l}") for l in range(self.num_layers)]

    def _propagate(self, x, generator, num_samples: int, sample_last: bool = False, chols=None):
        """One stochastic pass of ``num_samples`` samples: the last layer's
        (mean, var), each (S, n, dy) -- or, with ``sample_last``, its
        sample and None.  The first layer sees x (n, d), shared by the
        samples; each later one the (S, n, w) draws of the layer before."""
        layers = self._layers()
        chols = chols if chols is not None else [None] * len(layers)
        F = x
        for l, (layer, chol) in enumerate(zip(layers, chols)):
            mean, var = layer.marginal(F, chol)
            if F.ndim == 2:
                mean = mean.expand((num_samples,) + tuple(mean.shape))
                var = var.expand(mean.shape)
            if l + 1 < len(layers) or sample_last:
                eps = _sampling.standard_normal(generator, mean.shape, mean)
                F = mean + torch.sqrt(var) * eps
            else:
                return mean, var
        return F, None

    def log_likelihood(self, x=None, y=None, generator=None):
        """The ELBO on (x, y) (default: the training data), the expected
        log-likelihood averaged over ``num_samples`` passes and scaled to
        the full data; the normals come from ``generator`` (default: a fresh
        one from :func:`~gptorch_tpu_torch.settings.next_default_generator`)."""
        x = x if x is not None else self.X
        y = y if y is not None else self.Y
        if generator is None:
            generator = settings.next_default_generator(self.device)
        # each layer's chol(Kuu) serves its marginal and its KL
        chols = [layer._kuu_chol() for layer in self._layers()]
        mean, var = self._propagate(x, generator, self.num_samples, chols=chols)
        S = self.num_samples
        ell = (self.num_data / x.shape[0]) * self.likelihood.propagate_log(mean, var, y.expand(mean.shape)) / S
        return ell - sum(layer.kl(chol) for layer, chol in zip(self._layers(), chols))

    def _predict(self, x_new, diag=True, generator=None, num_samples: int = 20):
        """Moments of the Gaussian mixture over ``num_samples`` passes."""
        if not diag:
            raise NotImplementedError("DeepGP full covariance: use diag")
        if generator is None:
            generator = settings.next_default_generator(self.device)
        means, variances = self._propagate(x_new, generator, num_samples)
        mean = torch.mean(means, dim=0)
        return mean, torch.mean(variances + torch.square(means), dim=0) - torch.square(mean)
