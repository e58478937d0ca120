"""VecchiaGPR: scalable GP regression through nearest-neighbour conditionals.

Counterpart of ``gptorch_tpu/models/vecchia.py``.  Approximate (exact as
m → n), any input dimension, O(n·m³): the whole likelihood is one batched
(m, m) Cholesky over n independent conditionals
(:mod:`gptorch_tpu_torch.ops.vecchia`), with no sequential structure, so
``fit_scan`` captures its step on the card.  The ordering and the
neighbour search run once on the host at construction; predictions
condition each test point on its m nearest training points (diagonal only:
Vecchia has no joint test covariance).

The neighbour indices are int64 buffers.  The JAX package stores them as
floats, because an integer leaf stops ``jax.grad`` over the model; a torch
buffer is not differentiated, so the port keeps the integers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..likelihoods import Gaussian
from ..ops import vecchia as _ops
from ..util import as_array
from .base import GPModel


class VecchiaGPR(GPModel):
    """Vecchia-approximate GP regression (Gaussian likelihood).

    :param num_neighbors: conditioning-set size m (32 is a strong default,
        Katzfuss & Guinness 2021); exact as m → n.
    :param ordering: "maxmin" (best quality, O(n²) host work), "coord"
        (first-PC sort, O(n log n)), or "auto" (maxmin for n ≤ 8192, coord
        above).
    :param chunk: conditionals per step of the loss's loop -- peak live
        memory is (chunk, m, m) per temporary.
    """

    def __init__(
        self,
        x,
        y,
        kernel,
        likelihood=None,
        mean_function=None,
        num_neighbors: int = 32,
        ordering: str = "auto",
        chunk: int = 4096,
        name: str = "vecchia",
        device=None,
    ):
        super().__init__(x, y, kernel, likelihood, mean_function, name, device=device)
        if not isinstance(self.likelihood, Gaussian):
            raise ValueError(
                "VecchiaGPR needs a Gaussian likelihood (the chain-rule conditionals are Gaussian); use "
                "LaplaceGP/SVGP for non-Gaussian observations"
            )
        n = self.X.shape[0]
        self.num_neighbors = int(min(num_neighbors, max(n - 1, 1)))
        self.chunk = int(chunk)
        if ordering == "auto":
            ordering = "maxmin" if n <= 8192 else "coord"
        if ordering not in ("maxmin", "coord"):
            raise ValueError("ordering must be 'maxmin', 'coord' or 'auto'")
        self.ordering = ordering

        xh = self.X.detach().cpu().numpy().astype(np.float64)
        order = _ops.maxmin_ordering(xh) if ordering == "maxmin" else _ops.coordinate_ordering(xh)
        # the data are kept in Vecchia order: training does not depend on
        # the order, and predictions gather by index
        order = torch.as_tensor(order, device=self.device)
        self.X = self.X[order]
        self.Y = self.Y[order]
        from scipy.spatial import cKDTree

        xo = self.X.detach().cpu().numpy().astype(np.float64)
        nn_idx, nn_mask = _ops.previous_neighbors(xo, self.num_neighbors)
        self._kdtree = cKDTree(xo)  # the prediction-time neighbour tree, built once
        self.register_buffer("nn_idx", torch.as_tensor(nn_idx, device=self.device))
        self.register_buffer("nn_mask", as_array(nn_mask, dtype=self.X.dtype, device=self.device))

    def _reads_jitter_policy(self) -> bool:
        return False  # one batched cholesky_ex, no jitter policy

    def log_likelihood(self, x=None, y=None, generator=None):
        if x is not None or y is not None:
            raise ValueError(
                "VecchiaGPR trains on its constructor data (the neighbor graph is precomputed for it); rebuild "
                "the model to change data"
            )
        resid = self.Y - self.mean_function(self.X)
        noise = self.likelihood.variance.value.reshape(())
        return _ops.vecchia_nlml(self.kernel, noise, self.X, resid, self.nn_idx, self.nn_mask, chunk=self.chunk)

    def _predict(self, x_new, diag=True):
        if not diag:
            raise NotImplementedError(
                "Vecchia predictions are independent per-point conditionals (no joint test covariance); use "
                "diag=True or an exact model for joint draws"
            )
        x_new = as_array(x_new, dtype=self.X.dtype, device=self.device)
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        nn = _ops.query_point_neighbors(
            self._kdtree, x_new.detach().cpu().numpy().astype(np.float64), self.num_neighbors, self.X.shape[0]
        )
        resid = self.Y - self.mean_function(self.X)
        noise = self.likelihood.variance.value.reshape(())
        mu, var = _ops.vecchia_predict(
            self.kernel, noise, self.X, resid, torch.as_tensor(nn, device=self.device), x_new, chunk=self.chunk
        )
        mean = mu + self.mean_function(x_new)
        return mean, torch.clamp(var, min=0.0)[:, None].expand(mean.shape)
