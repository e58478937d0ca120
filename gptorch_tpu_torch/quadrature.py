"""Gauss-Hermite quadrature for likelihood expectations.

Counterpart of ``gptorch_tpu/quadrature.py``: expectations of g(f) under
f ~ N(mean, var), elementwise, by the probabilists' Hermite rule
(``np.polynomial.hermite_e.hermegauss``) with weights normalized to sum
to 1:

    <g(f)> ≈ Σ_k w_k · g(mean + √var · z_k)
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _nodes_weights(order: int):
    z, w = np.polynomial.hermite_e.hermegauss(order)
    return z, w / math.sqrt(2.0 * math.pi)


@functools.lru_cache(maxsize=None)
def _nodes_weights_on(order: int, dtype, device):
    """The rule's nodes and weights as tensors, made once per dtype and
    device: a loss that a CUDA graph captures then copies nothing from the
    host."""
    z, w = _nodes_weights(order)
    return torch.as_tensor(z, dtype=dtype, device=device), torch.as_tensor(w, dtype=dtype, device=device)


def _abscissae(mean, var, order):
    """The quadrature points f_k = mean + √var·z_k, shape (order,) +
    mean.shape, and the weights, on ``mean``'s device and dtype."""
    z, w = _nodes_weights_on(order, mean.dtype, mean.device)
    z = z.reshape((-1,) + (1,) * mean.ndim)
    return mean[None, ...] + torch.sqrt(torch.clamp(var, min=0.0))[None, ...] * z, w


def gauss_hermite(g, mean, var, order: int = 20):
    """<g(f)>_{f ~ N(mean, var)} elementwise over ``mean``/``var``.

    ``g`` must be vectorized: it receives a tensor with one extra leading
    quadrature axis."""
    f, w = _abscissae(mean, var, order)
    return torch.tensordot(w, g(f), dims=([0], [0]))


def gauss_hermite_log(log_g, mean, var, order: int = 20):
    """log <g(f)>_{f ~ N(mean, var)} from log-domain integrand values,
    logsumexp_k(log w_k + log_g(f_k)): stable for densities that underflow
    in linear space (predictive log-densities far in the tails)."""
    f, w = _abscissae(mean, var, order)
    vals = log_g(f) + torch.log(w).reshape((-1,) + (1,) * mean.ndim)
    return torch.logsumexp(vals, dim=0)
