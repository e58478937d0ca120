"""Prior distributions for parameters.

Counterpart of ``gptorch_tpu/priors.py``.  :meth:`Module.log_prior
<gptorch_tpu_torch.module.Module.log_prior>` evaluates them on the
constrained value with no Jacobian term, as the reference gptorch does.
"""

from __future__ import annotations

import math

import torch


class Prior:
    def log_prob(self, x):
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash((type(self), tuple(sorted(self.__dict__.items()))))

    def __repr__(self):
        args = ", ".join(f"{k}={v}" for k, v in self.__dict__.items())
        return f"{type(self).__name__}({args})"


class Normal(Prior):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc = float(loc)
        self.scale = float(scale)

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z**2 - math.log(self.scale) - 0.5 * math.log(2.0 * math.pi)


class LogNormal(Prior):
    def __init__(self, loc=0.0, scale=1.0):
        self.loc = float(loc)
        self.scale = float(scale)

    def log_prob(self, x):
        logx = torch.log(x)
        z = (logx - self.loc) / self.scale
        return -0.5 * z**2 - logx - math.log(self.scale) - 0.5 * math.log(2.0 * math.pi)


class Gamma(Prior):
    """Shape/rate parameterization, as torch.distributions.Gamma."""

    def __init__(self, concentration=1.0, rate=1.0):
        self.concentration = float(concentration)
        self.rate = float(rate)

    def log_prob(self, x):
        a, b = self.concentration, self.rate
        return a * math.log(b) + (a - 1.0) * torch.log(x) - b * x - math.lgamma(a)


class Uniform(Prior):
    def __init__(self, low=0.0, high=1.0):
        self.low = float(low)
        self.high = float(high)

    def log_prob(self, x):
        inside = (x >= self.low) & (x <= self.high)
        return torch.where(
            inside,
            torch.full_like(x, -math.log(self.high - self.low)),
            torch.full_like(x, -math.inf),
        )
