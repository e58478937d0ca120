"""Covariance kernels.

Counterpart of the radial, dot-product and algebra kernels of
``gptorch_tpu/kernels.py``: White, Constant/Bias, Exp/Matern12, Matern32,
Matern52, Rbf, RationalQuadratic, Linear, Polynomial, Sum and Product, with
the same parameterizations and the same ARD length scales and variances.

:class:`Rbf` on a CUDA tensor builds its Gram with the hand-written kernel
of :mod:`gptorch_tpu_torch.ops.gram`; the other kernels are plain
PyTorch on every device, as they are plain XLA in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .module import Module
from .ops.gram import rbf_gram
from .param import positive_param
from .util import as_array, squared_distance


def _k_shape(X, X2):
    n1 = X.shape[0]
    return (n1, n1) if X2 is None else (n1, X2.shape[0])


def _scalar(p):
    """A Param's value as a 0-d tensor."""
    return p.value.reshape(())


class Kernel(Module):
    """Base class: K(X, X2=None) -> (n1, n2) Gram matrix; Kdiag(X) -> (n,).

    Supports ``+`` and ``*`` composition."""

    def __init__(self, input_dim: int):
        super().__init__()
        self.input_dim = int(input_dim)

    def K(self, X, X2=None):
        raise NotImplementedError

    def Kdiag(self, X):
        raise NotImplementedError

    def _validate_ard_shape(self, x, ARD=None):
        """Broadcast a scalar-or-vector hyperparameter against input_dim;
        ``ARD=None`` infers it from the value's shape."""
        if ARD is None:
            ARD = np.asarray(x).squeeze().shape != ()
        x = np.asarray(x) * np.ones(self.input_dim)
        if x.shape != (self.input_dim,):
            raise ValueError("shape of possibly-ARD param does not match input_dim")
        return x, bool(ARD)

    def __add__(self, other):
        return Sum(self, other)

    def __mul__(self, other):
        return Product(self, other)


class Static(Kernel):
    """Input-independent kernels: only a variance parameter."""

    def __init__(self, input_dim: int, variance: float = 1.0):
        super().__init__(input_dim)
        self.variance = positive_param(as_array(variance))

    def Kdiag(self, X):
        return _scalar(self.variance).expand(X.shape[0])


class White(Static):
    """σ²·I for K(X); zeros for a cross-covariance."""

    def K(self, X, X2=None):
        var = _scalar(self.variance)
        if X2 is None:
            return torch.diag_embed(var.expand(X.shape[0]))
        return torch.zeros(_k_shape(X, X2), dtype=var.dtype, device=var.device)


class Constant(Static):
    """Constant (bias) kernel."""

    def K(self, X, X2=None):
        return _scalar(self.variance).expand(_k_shape(X, X2))


class Bias(Constant):
    pass


class Stationary(Kernel):
    """Base for kernels of r = ||x - x'|| / ℓ, with optional ARD."""

    def __init__(self, input_dim: int, variance: float = 1.0, length_scales=None, ARD: bool = False):
        super().__init__(input_dim)
        self.variance = positive_param(as_array(variance))
        self.ARD = bool(ARD)
        if ARD:
            if length_scales is None:
                length_scales = np.ones(input_dim)
            elif isinstance(length_scales, (np.ndarray, list, tuple)):
                length_scales = np.asarray(length_scales, dtype=float)
                if len(length_scales) != input_dim:
                    raise ValueError("ARD length_scales must have input_dim entries")
            else:
                length_scales = float(length_scales) * np.ones(input_dim)
            self.length_scales = positive_param(as_array(length_scales))
        else:
            if length_scales is None:
                length_scales = 1.0
            self.length_scales = positive_param(as_array(float(length_scales)))

    def squared_dist(self, X, X2=None):
        """Length-scale-scaled squared distances."""
        ell = self.length_scales.value
        return squared_distance(X / ell) if X2 is None else squared_distance(X / ell, X2 / ell)

    def dist(self, X, X2=None):
        """Scaled distance, clamped before the sqrt so its gradient stays
        finite at r = 0.  The floor is the dtype's smallest normal number
        (1e-40 is subnormal in float32 and flushes to 0)."""
        r2 = self.squared_dist(X, X2)
        floor = max(1e-40, float(torch.finfo(r2.dtype).tiny))
        return torch.sqrt(torch.clamp(r2, min=floor))

    def Kdiag(self, X):
        return _scalar(self.variance).expand(X.shape[0])


class Exp(Stationary):
    """k(r) = σ² exp(-r)."""

    def K(self, X, X2=None):
        return _scalar(self.variance) * torch.exp(-self.dist(X, X2))


class Matern12(Exp):
    pass


class Matern32(Stationary):
    """k(r) = σ² (1 + √3 r) exp(-√3 r)."""

    def K(self, X, X2=None):
        r3 = math.sqrt(3.0) * self.dist(X, X2)
        return _scalar(self.variance) * (1.0 + r3) * torch.exp(-r3)


class Matern52(Stationary):
    """k(r) = σ² (1 + √5 r + 5r²/3) exp(-√5 r)."""

    def K(self, X, X2=None):
        r = self.dist(X, X2)
        s5 = math.sqrt(5.0)
        return _scalar(self.variance) * (1.0 + s5 * r + (5.0 / 3.0) * r * r) * torch.exp(-s5 * r)


class Rbf(Stationary):
    """Squared exponential: k = σ² exp(-r²/2).

    The Gram goes through :func:`gptorch_tpu_torch.ops.gram.rbf_gram`: the
    hand-written kernel on a CUDA tensor, its plain twin (the same
    arithmetic as :meth:`squared_dist`) on the CPU.  Inputs are scaled by
    division, ``X / ℓ``, as in the JAX package's generic path.
    """

    def K(self, X, X2=None, diag=None):
        """:param diag: added on the diagonal of the symmetric Gram (the
        noise variance of ``K(X, X) + σ²I``), fused into the kernel's write
        on the card."""
        ell = self.length_scales.value
        x2 = None if X2 is None else (X2 / ell).contiguous()
        return rbf_gram((X / ell).contiguous(), x2, var=_scalar(self.variance), diag=diag)


class RationalQuadratic(Stationary):
    """k(r) = σ² (1 + r²/(2α))^(-α)."""

    def __init__(self, input_dim: int, variance: float = 1.0, length_scales=None, alpha: float = 1.0, ARD: bool = False):
        super().__init__(input_dim, variance, length_scales, ARD)
        self.alpha = positive_param(as_array(float(alpha)))

    def K(self, X, X2=None):
        r2 = self.squared_dist(X, X2)
        a = _scalar(self.alpha)
        return _scalar(self.variance) * torch.pow(1.0 + r2 / (2.0 * a), -a)


class Linear(Kernel):
    """k(x, x') = Σ_q σ²_q x_q x'_q, with per-dimension (ARD) variances.

    The Gram is one product, as in the JAX package, which leaves it to XLA
    outside any Pallas kernel."""

    def __init__(self, input_dim: int, variance=1.0, ARD=None):
        super().__init__(input_dim)
        variance, self.ARD = self._validate_ard_shape(variance, ARD)
        self.variance = positive_param(as_array(variance))

    def K(self, X, X2=None):
        other = X if X2 is None else X2
        return (X * self.variance.value) @ other.T

    def Kdiag(self, X):
        return torch.sum(X * X * self.variance.value, dim=1)


class Polynomial(Linear):
    """k(x, x') = (Σ_q σ²_q x_q x'_q + b)^p with ARD variances (from
    :class:`Linear`), a trainable offset b > 0 and a static integer degree
    p ≥ 1.  The base can be negative, so the exponent is a Python int:
    ``torch.pow`` then takes the exact integer power (and its gradient
    p·base^(p−1)), never exp·log."""

    def __init__(self, input_dim: int, degree: int = 2, variance=1.0, offset: float = 1.0, ARD=None):
        super().__init__(input_dim, variance=variance, ARD=ARD)
        if int(degree) < 1:
            raise ValueError("degree must be >= 1")
        self.degree = int(degree)
        self.offset = positive_param(as_array(float(offset)))

    def K(self, X, X2=None):
        return torch.pow(super().K(X, X2) + _scalar(self.offset), self.degree)

    def Kdiag(self, X):
        return torch.pow(super().Kdiag(X) + _scalar(self.offset), self.degree)


class Combination(Kernel):
    """Pair combination."""

    def __init__(self, kern1: Kernel, kern2: Kernel):
        if kern1.input_dim != kern2.input_dim:
            raise ValueError("Kernels need the same input_dim")
        super().__init__(kern1.input_dim)
        self.kern1 = kern1
        self.kern2 = kern2


class Product(Combination):
    def K(self, X, X2=None):
        return self.kern1.K(X, X2) * self.kern2.K(X, X2)

    def Kdiag(self, X):
        return self.kern1.Kdiag(X) * self.kern2.Kdiag(X)


class Sum(Combination):
    def K(self, X, X2=None):
        return self.kern1.K(X, X2) + self.kern2.K(X, X2)

    def Kdiag(self, X):
        return self.kern1.Kdiag(X) + self.kern2.Kdiag(X)
