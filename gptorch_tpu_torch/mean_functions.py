"""Mean functions.

Counterpart of ``gptorch_tpu/mean_functions.py``: a mean function maps
(n, dx) inputs to (n, dy) outputs.  :class:`LinearMean` plays the part of
``torch.nn.Linear`` in the reference gptorch; :func:`as_mean_function`
wraps any callable.
"""

from __future__ import annotations

import numpy as np
import torch

from . import settings
from .module import Module
from .param import Param
from .util import as_array


class MeanFunction(Module):
    def forward(self, x):
        raise NotImplementedError


class Constant(MeanFunction):
    """Trainable constant mean: m(x) = val, broadcast to (n, dy)."""

    def __init__(self, dy: int, val=None, trainable: bool = True):
        super().__init__()
        if val is not None:
            val = as_array(np.asarray(val))
            if val.shape[0] != dy:
                raise ValueError("Provided val doesn't match output dimension")
        else:
            val = torch.zeros((dy,), dtype=settings.default_float())
        self.dy = int(dy)
        self.val = Param(val, trainable=trainable)

    def forward(self, x):
        return self.val.value.expand(x.shape[0], self.dy)


class Zero(Constant):
    """Zero mean, frozen; the GP default."""

    def __init__(self, dy: int):
        super().__init__(dy, trainable=False)


class LinearMean(MeanFunction):
    """m(x) = x Wᵀ + b.  Without ``W``, it starts at 0.01·N(0, 1) entries
    drawn from ``generator`` (a seeded ``torch.Generator`` by default)."""

    def __init__(self, dx: int, dy: int, W=None, b=None, generator=None):
        super().__init__()
        if W is None:
            if generator is None:
                generator = torch.Generator().manual_seed(settings.next_seed())
            W = 0.01 * torch.randn(dy, dx, generator=generator, dtype=settings.default_float())
        if b is None:
            b = np.zeros(dy)
        self.W = Param(as_array(W if isinstance(W, torch.Tensor) else np.asarray(W)))
        self.b = Param(as_array(b if isinstance(b, torch.Tensor) else np.asarray(b)))

    def forward(self, x):
        return x @ self.W.value.T + self.b.value


class FunctionMean(MeanFunction):
    """Wrap a stateless callable on tensors as a mean function."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def as_mean_function(obj) -> MeanFunction:
    if isinstance(obj, MeanFunction):
        return obj
    if callable(obj):
        return FunctionMean(obj)
    raise TypeError(f"Cannot interpret {type(obj)} as a mean function")
