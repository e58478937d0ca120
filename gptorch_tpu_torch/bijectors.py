"""Bijectors: smooth invertible maps that constrain parameters.

Counterpart of ``gptorch_tpu/bijectors.py``.  A :class:`~gptorch_tpu_torch.param.Param`
stores its value in unconstrained space and maps it forward on read.
Bijectors are small stateless objects compared by structure.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class Bijector:
    def forward(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError

    def forward_log_det_jacobian(self, x):
        """log |det d forward(x) / dx|, summed over the event."""
        raise NotImplementedError

    def __call__(self, x):
        return self.forward(x)

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self), tuple(sorted(self.__dict__.items()))))

    def __repr__(self):
        return type(self).__name__ + "()"


class Identity(Bijector):
    def forward(self, x):
        return x

    def inverse(self, y):
        return y

    def forward_log_det_jacobian(self, x):
        return torch.zeros((), dtype=x.dtype, device=x.device)


class Exp(Bijector):
    """y = exp(x), the reference gptorch's default positive transform."""

    def forward(self, x):
        return torch.exp(x)

    def inverse(self, y):
        return torch.log(y)

    def forward_log_det_jacobian(self, x):
        return torch.sum(x)


class Softplus(Bijector):
    """y = log(1 + exp(x)); better float32 conditioning than Exp."""

    def forward(self, x):
        return F.softplus(x)

    def inverse(self, y):
        return y + torch.log(-torch.expm1(-y))

    def forward_log_det_jacobian(self, x):
        return torch.sum(F.logsigmoid(x))


class LowerCholesky(Bijector):
    """Map an unconstrained square matrix to a lower-triangular matrix with a
    positive diagonal: ``tril(x, -1) + diag(exp(diag(x)))`` -- SVGP's
    variational Cholesky factor (torch.distributions'
    ``LowerCholeskyTransform``)."""

    def forward(self, x):
        return torch.tril(x, -1) + torch.diag_embed(torch.exp(torch.diagonal(x, dim1=-2, dim2=-1)))

    def inverse(self, y):
        return torch.tril(y, -1) + torch.diag_embed(torch.log(torch.diagonal(y, dim1=-2, dim2=-1)))

    def forward_log_det_jacobian(self, x):
        return torch.sum(torch.diagonal(x, dim1=-2, dim2=-1))


class Shift(Bijector):
    """y = x + shift."""

    def __init__(self, shift: float):
        self.shift = float(shift)

    def forward(self, x):
        return x + self.shift

    def inverse(self, y):
        return y - self.shift

    def forward_log_det_jacobian(self, x):
        return torch.zeros((), dtype=x.dtype, device=x.device)

    def __repr__(self):
        return f"Shift({self.shift})"


class Chain(Bijector):
    """Composition: Chain([f, g]).forward(x) = f(g(x)) (outermost first)."""

    def __init__(self, bijectors):
        self.bijectors = tuple(bijectors)

    def forward(self, x):
        for b in reversed(self.bijectors):
            x = b.forward(x)
        return x

    def inverse(self, y):
        for b in self.bijectors:
            y = b.inverse(y)
        return y

    def forward_log_det_jacobian(self, x):
        total = torch.zeros((), dtype=x.dtype, device=x.device)
        for b in reversed(self.bijectors):
            total = total + b.forward_log_det_jacobian(x)
            x = b.forward(x)
        return total

    def __repr__(self):
        return f"Chain({list(self.bijectors)})"


def positive() -> Bijector:
    """The configured default positive-constraint bijector."""
    from . import settings

    name = settings.config.positive_bijector
    if name == "exp":
        return Exp()
    if name == "softplus":
        return Softplus()
    raise ValueError(f"Unknown positive bijector {name!r}")
