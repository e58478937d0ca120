"""Random draws and random Fourier features for pathwise sampling.

Counterpart of ``gptorch_tpu/sampling.py``'s :class:`RandomFourierFeatures`
(Rahimi & Recht 2007): a feature map φ whose inner products approximate a
stationary kernel,

    φ_j(x) = √(2σ²/F) cos(ω_jᵀ x̃ + b_j),  x̃ = x/ℓ,  b_j ~ U[0, 2π),

with ω_j ~ N(0, I) for Rbf and, for the Matérn family, the multivariate
Student-t with 2ν degrees of freedom: ω = z·√(2ν/u), z ~ N(0, I),
u ~ χ²_{2ν}.  Since 2ν ∈ {1, 3, 5}, u is drawn exactly as the sum of 2ν
squared standard normals, which take a ``torch.Generator`` (torch's gamma
sampler takes none).  For SpectralMixture the frequencies come from its
own Gaussian-mixture spectral density, on unscaled inputs.  The JAX
package's PRNG keys become generators; the two packages draw different
numbers from the same seed.

Every draw goes through :func:`standard_normal` or :func:`uniform`, so a
caller can hold the draws fixed.

:func:`pathwise_svgp_samples` and :func:`pathwise_gpr_samples` draw
posterior function samples by Matheron's rule (Wilson et al. 2020): an
RFF prior path plus an update through the inducing points or the training
data,

    f_post(·) = f_prior(·) + K(·, Z) Kuu⁻¹ (u − f_prior(Z)),  u ~ q(u)
    f_post(·) = f_prior(·) + K(·, X) K̂⁻¹ (y − m(X) − f_prior(X) − ε),  ε ~ N(0, σ²I)

so a sample costs O(F + m) (or O(F + n)) per evaluation point.  On the
card K(x*, Z) and K(x*, X) of an Rbf kernel are launches of
``csrc/rbf_gram.cu``, and a ``solver="iterative"`` GPR's K̂⁻¹ is its
posterior's CG solve, whose products are launches of ``csrc/radial_mvm.cu``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import settings
from .functions import cholesky, trtrs
from .kernels import Exp, Matern32, Matern52, Rbf, SpectralMixture
from .util import _coerce_io

__all__ = ["RandomFourierFeatures", "pathwise_gpr_samples", "pathwise_svgp_samples", "standard_normal", "uniform"]

#: Matérn smoothness by kernel class; Matern12 is an Exp subclass, so the
#: order matters.
_MATERN_NU = ((Matern52, 2.5), (Matern32, 1.5), (Exp, 0.5))


def standard_normal(generator: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    """Standard normals of ``shape`` in ``like``'s dtype, on its device,
    from ``generator``."""
    return torch.randn(tuple(shape), generator=generator, dtype=like.dtype, device=like.device)


def uniform(generator: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    """U[0, 1) draws of ``shape`` in ``like``'s dtype, on its device, from
    ``generator``."""
    return torch.rand(tuple(shape), generator=generator, dtype=like.dtype, device=like.device)


class RandomFourierFeatures:
    """Feature map φ with E[φ(x)ᵀφ(x')] = k(x, x') for an Rbf, Matérn
    (Exp/Matern12, Matern32, Matern52) or SpectralMixture kernel; any other
    kernel raises ``TypeError``.

    :param generator: a ``torch.Generator`` on the kernel's device; default
        :func:`~gptorch_tpu_torch.settings.next_default_generator` there.

    For Rbf and the Matérn family the frequencies and phases are drawn
    once, and the length scales and the variance are read at every call,
    so φ is differentiable in x and in the hyperparameters.  For
    SpectralMixture each feature draws a component q ~ Cat(w/Σw), random
    signs s ∈ {±1}^d and ω = 2π(s⊙μ_q + √v_q⊙z), z ~ N(0, I) (the signs
    realize Π_d cos(2π τ_d μ_qd) = E_s[cos(2π Σ_d s_d τ_d μ_qd)]); the
    weights, means and scales are read once, at construction.
    """

    def __init__(self, kernel, num_features: int, generator: torch.Generator = None):
        self.kernel = kernel
        self.num_features = int(num_features)
        if isinstance(kernel, SpectralMixture):
            like = kernel.weights.value.detach()
        else:
            nu = None
            if not isinstance(kernel, Rbf):
                nu = next((v for cls, v in _MATERN_NU if isinstance(kernel, cls)), None)
                if nu is None:
                    raise TypeError(
                        "RandomFourierFeatures supports Rbf, the Matérn family and SpectralMixture; got "
                        f"{type(kernel).__name__}"
                    )
            like = kernel.variance.value.detach()
        if generator is None:
            generator = settings.next_default_generator(like.device)
        F = self.num_features
        if isinstance(kernel, SpectralMixture):
            w = kernel.weights.value.detach()
            mu, v = kernel.means.value.detach(), kernel.scales.value.detach()
            q = torch.multinomial(w / torch.sum(w), F, replacement=True, generator=generator)
            s = 2.0 * torch.randint(0, 2, (F, kernel.input_dim), generator=generator, device=like.device).to(
                like.dtype) - 1.0
            z = standard_normal(generator, (F, kernel.input_dim), like)
            self.omega = (2.0 * math.pi) * (s * mu[q] + torch.sqrt(v[q]) * z).T
            self._amplitude2 = torch.sum(w)
        else:
            self.omega = standard_normal(generator, (kernel.input_dim, F), like)
            if nu is not None:
                df = int(2 * nu)
                u = torch.sum(torch.square(standard_normal(generator, (F, df), like)), dim=1)
                self.omega = self.omega * torch.sqrt(df / u)[None, :]
            self._amplitude2 = None  # the variance, read at every call
        self.phase = 2.0 * math.pi * uniform(generator, (F,), like)

    def __call__(self, x):
        """φ(x): (n, F)."""
        if self._amplitude2 is None:
            var = self.kernel.variance.value.reshape(())
            x = x / self.kernel.length_scales.value
        else:
            var = self._amplitude2
        proj = x @ self.omega + self.phase
        return torch.sqrt(2.0 * var / self.num_features) * torch.cos(proj)


def _cholesky_solve(L, B):
    """(L Lᵀ)⁻¹ B by two triangular solves, batched over B's leading axes."""
    return trtrs(trtrs(B, L), L.mT, lower=False)


@_coerce_io
def pathwise_svgp_samples(model, x_star, num_samples: int = 10, num_features: int = 1024,
                          generator: torch.Generator = None):
    """``num_samples`` posterior function samples of an SVGP at ``x_star``
    by the sparse Matheron rule (see the module docstring): (num_samples,
    n*, dy).  The draws come from ``generator`` (default:
    :func:`~gptorch_tpu_torch.settings.next_default_generator` on the
    model's device) in the order: the features, the prior weights W
    (S, F, dy), the q(u) normals ζ (S, m, dy).  A whitened q is mapped back
    to u-space once."""
    if generator is None:
        generator = settings.next_default_generator(model.device)
    phi = RandomFourierFeatures(model.kernel, num_features, generator)
    z = model.Z.value
    L = cholesky(model._kuu(z), blocked=False)
    m_u = model.induced_output_mean.value  # (m, dy), relative to the mean function
    Lq = model.induced_output_chol_cov.value
    if getattr(model, "whiten", False):
        m_u, Lq = L @ m_u, L @ Lq
    m, dy = m_u.shape
    W = standard_normal(generator, (num_samples, num_features, dy), m_u)
    f_prior_star = torch.einsum("sfo,nf->sno", W, phi(x_star))
    f_prior_z = torch.einsum("sfo,mf->smo", W, phi(z))
    u = m_u[None] + torch.einsum("mk,sko->smo", Lq, standard_normal(generator, (num_samples, m, dy), m_u))
    v = _cholesky_solve(L, u - f_prior_z)  # Kuu⁻¹ (u − f_prior(Z)), (S, m, dy)
    update = torch.einsum("nm,smo->sno", model.kernel.K(x_star, z), v)
    return f_prior_star + update + model.mean_function(x_star)[None]


@_coerce_io
def pathwise_gpr_samples(model, x_star, num_samples: int = 10, num_features: int = 1024,
                         generator: torch.Generator = None):
    """Posterior function samples of an exact GPR at ``x_star`` by
    Matheron's rule (see the module docstring): (num_samples, n*, dy).
    K̂⁻¹ is the model's cached posterior solver: the dense Cholesky factor
    for ``solver="dense"``, the batched preconditioned CG of
    :class:`~gptorch_tpu_torch.models.posterior.IterativeGPRPosterior` for
    ``solver="iterative"``.  The draws come from ``generator`` in the order:
    the features, the prior weights W (S, F, dy), the noise ε (S, n, dy)."""
    if generator is None:
        generator = settings.next_default_generator(model.device)
    phi = RandomFourierFeatures(model.kernel, num_features, generator)
    X = model.X
    n, dy = model.Y.shape
    noise = model.likelihood.variance.value.reshape(())
    W = standard_normal(generator, (num_samples, num_features, dy), X)
    f_prior_star = torch.einsum("sfo,nf->sno", W, phi(x_star))
    f_prior_X = torch.einsum("sfo,nf->sno", W, phi(X))
    eps = torch.sqrt(noise) * standard_normal(generator, (num_samples, n, dy), X)
    resid = (model.Y - model.mean_function(X))[None] - f_prior_X - eps
    B = resid.movedim(0, -1).reshape(n, dy * num_samples)  # one K̂⁻¹ application for every sample
    post = model.posterior()
    V = post._solve(B) if hasattr(post, "_solve") else _cholesky_solve(post.L, B)
    V = V.reshape(n, dy, num_samples).movedim(-1, 0)  # (S, n, dy)
    update = torch.einsum("nm,smo->sno", model.kernel.K(x_star, X), V)
    return f_prior_star + update + model.mean_function(x_star)[None]
