"""Random draws and random Fourier features for pathwise sampling.

Counterpart of ``gptorch_tpu/sampling.py``'s :class:`RandomFourierFeatures`
(Rahimi & Recht 2007): a feature map φ whose inner products approximate a
stationary kernel,

    φ_j(x) = √(2σ²/F) cos(ω_jᵀ x̃ + b_j),  x̃ = x/ℓ,  b_j ~ U[0, 2π),

with ω_j ~ N(0, I) for Rbf and, for the Matérn family, the multivariate
Student-t with 2ν degrees of freedom: ω = z·√(2ν/u), z ~ N(0, I),
u ~ χ²_{2ν}.  Since 2ν ∈ {1, 3, 5}, u is drawn exactly as the sum of 2ν
squared standard normals, which take a ``torch.Generator`` (torch's gamma
sampler takes none).  The JAX package's PRNG keys become generators; the
two packages draw different numbers from the same seed.

Every draw goes through :func:`standard_normal` or :func:`uniform`, so a
caller can hold the draws fixed.  ``pathwise_gpr_samples`` and
``pathwise_svgp_samples`` are not ported yet (ROADMAP item 10).
"""

from __future__ import annotations

import math

import torch

from . import settings
from .kernels import Exp, Matern32, Matern52, Rbf

__all__ = ["RandomFourierFeatures", "standard_normal", "uniform"]

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
    """Feature map φ with E[φ(x)ᵀφ(x')] = k(x, x') for an Rbf or Matérn
    (Exp/Matern12, Matern32, Matern52) kernel.

    :param generator: a ``torch.Generator`` on the kernel's device; default
        :func:`~gptorch_tpu_torch.settings.next_default_generator` there.

    The frequencies and phases are drawn once; the length scales and the
    variance are read at every call, so φ is differentiable in x and in the
    hyperparameters.  SpectralMixture's branch comes with that kernel
    (ROADMAP item 8); any other kernel raises ``TypeError``.
    """

    def __init__(self, kernel, num_features: int, generator: torch.Generator = None):
        nu = None
        if not isinstance(kernel, Rbf):
            nu = next((v for cls, v in _MATERN_NU if isinstance(kernel, cls)), None)
            if nu is None:
                raise TypeError(
                    "RandomFourierFeatures supports Rbf and the Matérn family; got "
                    f"{type(kernel).__name__} (SpectralMixture comes with ROADMAP item 8)"
                )
        self.kernel = kernel
        self.num_features = int(num_features)
        like = kernel.variance.value.detach()
        if generator is None:
            generator = settings.next_default_generator(like.device)
        self.omega = standard_normal(generator, (kernel.input_dim, self.num_features), like)
        if nu is not None:
            df = int(2 * nu)
            u = torch.sum(torch.square(standard_normal(generator, (self.num_features, df), like)), dim=1)
            self.omega = self.omega * torch.sqrt(df / u)[None, :]
        self.phase = 2.0 * math.pi * uniform(generator, (self.num_features,), like)

    def __call__(self, x):
        """φ(x): (n, F)."""
        var = self.kernel.variance.value.reshape(())
        proj = (x / self.kernel.length_scales.value) @ self.omega + self.phase
        return torch.sqrt(2.0 * var / self.num_features) * torch.cos(proj)
