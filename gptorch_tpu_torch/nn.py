"""Small feature-extractor networks for deep kernel learning.

Counterpart of ``gptorch_tpu/nn.py``: :class:`Dense` and :class:`MLP`, the
feature maps of :class:`~gptorch_tpu_torch.kernels.DeepKernel`.  Their
weights are :class:`~gptorch_tpu_torch.param.Param` children, so they
appear under the JAX package's dotted paths (``"kernel.net.layer0.w"``,
...) and train with the GP hyperparameters through every loop.

The initial weights are the JAX package's: a seeded
``np.random.RandomState`` on the host, He-scaled.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .module import Module
from .param import Param


class Dense(Module):
    """Affine layer ``x @ W + b`` with an optional activation.

    :param in_dim: input width.  :param out_dim: output width.
    :param activation: elementwise callable applied after the affine map
        (``None``: linear).
    :param seed: host RNG seed of the weight draw, W ~ N(0, 2/in_dim).
    """

    def __init__(self, in_dim: int, out_dim: int, activation: Optional[Callable] = None, seed: int = 0):
        super().__init__()
        rng = np.random.RandomState(seed)
        self.w = Param(rng.randn(in_dim, out_dim) * math.sqrt(2.0 / in_dim))
        self.b = Param(np.zeros(out_dim))
        self.activation = activation
        self.in_dim = int(in_dim)
        self.out_dim = int(out_dim)

    def forward(self, x):
        h = x @ self.w.value + self.b.value
        return self.activation(h) if self.activation is not None else h


class MLP(Module):
    """Multi-layer perceptron: ``MLP([d, 64, 64, 2])`` maps (n, d) to
    (n, 2) with tanh hidden activations and a linear last layer (the GP
    kernel supplies the final nonlinearity).  Layer i draws its weights
    from ``seed + i``."""

    def __init__(self, dims: Sequence[int], activation: Callable = torch.tanh, seed: int = 0):
        super().__init__()
        dims = [int(d) for d in dims]
        if len(dims) < 2:
            raise ValueError("MLP needs at least [in, out] dims")
        self.n_layers = len(dims) - 1
        self.in_dim = dims[0]
        self.out_dim = dims[-1]
        for i in range(self.n_layers):
            act = activation if i < self.n_layers - 1 else None
            setattr(self, f"layer{i}", Dense(dims[i], dims[i + 1], act, seed + i))

    def forward(self, x):
        for i in range(self.n_layers):
            x = getattr(self, f"layer{i}")(x)
        return x
