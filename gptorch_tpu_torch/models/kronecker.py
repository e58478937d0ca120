"""Structured (Kronecker) exact GP regression on Cartesian grids.

Counterpart of ``gptorch_tpu/models/kronecker.py`` (Saatçi 2011).  For
inputs on a grid X = X₁ × … × X_D with a product kernel K = K₁ ⊗ … ⊗ K_D,
exact regression takes per-axis eigendecompositions in place of an N³
factor:

    K_d = Q_d Λ_d Q_dᵀ
    K_yy⁻¹ = (⊗Q_d) diag(1/(λ + σ²)) (⊗Q_d)ᵀ,   λ = kron(λ₁, …, λ_D)
    log|K_yy| = Σ_j log(λ_j + σ²)

The heavy work is D small ``torch.linalg.eigh`` calls and mode products
(``torch.tensordot``); an ``Rbf`` axis builds its Gram with the hand-written
kernel K1 on the card.  ``eigh`` checks its status on the host, so a
training step is not captured as a CUDA graph (``fit_scan`` runs eagerly).

Grid ordering: y rows follow ``numpy.meshgrid(..., indexing="ij")``
flattening (axis 0 slowest), as :func:`grid_points` does.

The first kernel is also the model's ``kernel`` (``GPModel``'s slot), as in
the JAX package, whose ``get_trainable`` then lists its Params under two
paths, ``kernel.*`` and ``kern0.*``, as two leaves: training moves only
``kern0.*`` (the loss reads the ``kern{d}``), and ``kernel.*`` keeps its
start.  The port's ``kernel`` is a copy of the first kernel made at
construction, so its paths are separate Params too, and ``set_trainable``,
``convert.load_trainable`` and ``optimize("L-BFGS-B")`` treat them as the
JAX package does.
"""

from __future__ import annotations

import copy
import math
from typing import Sequence

import numpy as np
import torch

from ..util import as_array
from .base import GPModel


def _mode_chain(mats, tensor, pairwise=False):
    """Σ over the grid of ``tensor`` weighted by Π_d mats[d][t, i_d]
    (``pairwise``: by Π_d mats[d][t, i_d]·mats[d][u, i_d], for each pair
    (t, u)): the JAX package's einsum chain, axis 0 first."""
    out = tensor
    for d, M in enumerate(mats):
        if pairwise:
            out = torch.einsum("ti,ui,i...->tu...", M, M, out) if d == 0 else torch.einsum(
                "ti,ui,tui...->tu...", M, M, out)
        else:
            out = torch.einsum("ti,i...->t...", M, out) if d == 0 else torch.einsum("ti,ti...->t...", M, out)
    return out


def grid_predict(kernels, axes, qs, alpha, lam, sigma2, x_new, diag=True):
    """Posterior moments at off-grid points from cached Kronecker pieces
    (shared by :meth:`GridGPR._predict` and the cached
    :class:`~gptorch_tpu_torch.models.posterior.GridGPRPosterior`).

    mean_t = Σ_grid α[i₁..i_D] Π_d k_d(x*_t,d, X_d[i_d])
    var_t  = Π_d k_d(t,t) − Σ_j v_tj² / (λ_j + σ²),  v_t = ⊗_d (Q_dᵀ k_d(x*_t))
    cov_tu = Π_d k_d(t,u) − Σ_j v_tj v_uj / (λ_j + σ²)   (diag=False)
    """
    x_new = as_array(x_new, dtype=axes[0].dtype, device=axes[0].device)
    nt = x_new.shape[0]
    grid_sizes = tuple(a.shape[0] for a in axes)
    dy = alpha.shape[-1]

    crosses, rotated = [], []
    kdiag = torch.ones((nt,), dtype=x_new.dtype, device=x_new.device)
    for d, (k, a, q) in enumerate(zip(kernels, axes, qs)):
        col = x_new[:, d:d + 1]
        Kc = k.K(col, a)  # (nt, n_d)
        crosses.append(Kc)
        rotated.append(Kc @ q)
        kdiag = kdiag * k.Kdiag(col)
    mean = _mode_chain(crosses, alpha)  # (nt, dy)

    inv = (1.0 / (lam + sigma2)).reshape(grid_sizes)
    if diag:
        expl = _mode_chain([torch.square(W) for W in rotated], inv)
        var = torch.clamp(kdiag - expl, min=0.0)
        return mean, var[:, None].expand(nt, dy)
    expl = _mode_chain(rotated, inv, pairwise=True)
    prior = torch.ones((nt, nt), dtype=x_new.dtype, device=x_new.device)
    for d, k in enumerate(kernels):
        prior = prior * k.K(x_new[:, d:d + 1])
    cov = prior - expl
    return mean, 0.5 * (cov + cov.T)


def grid_points(axes: Sequence[np.ndarray]) -> np.ndarray:
    """Full (N, D) design matrix for grid axes [(n_1, 1), ..., (n_D, 1)]."""
    axes = [np.asarray(a).reshape(-1) for a in axes]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], axis=-1)


class GridGPR(GPModel):
    """Exact GP regression with Kronecker structure.

    :param grid_axes: D arrays, axis d holding the n_d coordinates of that
        dimension (1-D inputs of kernel d).
    :param y: (N, dy) observations, N = Π n_d, meshgrid-"ij" ordering.
    :param kernels: D kernels (input_dim=1 each); the kernel on the grid is
        their tensor product.
    """

    def __init__(self, grid_axes, y, kernels, likelihood=None, name="grid_gpr", device=None):
        if len(grid_axes) != len(kernels):
            raise ValueError("need one kernel per grid axis")
        axes_np = [np.asarray(a, dtype=float).reshape(-1, 1) for a in grid_axes]
        sizes = [a.shape[0] for a in axes_np]
        n_total = int(np.prod(sizes))
        y = np.asarray(y)
        if y.ndim == 1:
            y = y[:, None]
        if y.shape[0] != n_total:
            raise ValueError(f"y has {y.shape[0]} rows; grid has {n_total} points")

        x_full = grid_points([np.asarray(a) for a in grid_axes])
        super().__init__(x_full, y, copy.deepcopy(kernels[0]), likelihood, None, name, device=device)
        for d, k in enumerate(kernels):
            setattr(self, f"kern{d}", k.to(self.device))
        for d, a in enumerate(axes_np):
            self.register_buffer(f"axis{d}", as_array(a, device=self.device))
        self.num_axes = len(axes_np)
        self.grid_sizes = tuple(sizes)

    def _reads_jitter_policy(self) -> bool:
        return False  # eigendecompositions, no Cholesky

    def _capturable(self) -> bool:
        """``torch.linalg.eigh`` checks its status on the host."""
        return False

    # -- structure helpers -----------------------------------------------------

    def _kernels(self):
        return [getattr(self, f"kern{d}") for d in range(self.num_axes)]

    def _axes(self):
        return [getattr(self, f"axis{d}") for d in range(self.num_axes)]

    def _eigs(self):
        """Per-axis (eigenvalues, eigenvectors) of K_d."""
        lams, qs = [], []
        for k, a in zip(self._kernels(), self._axes()):
            lam, q = torch.linalg.eigh(k.K(a))
            lams.append(lam)
            qs.append(q)
        return lams, qs

    @staticmethod
    def _kron_eigs(lams):
        lam = lams[0]
        for l in lams[1:]:
            lam = (lam[:, None] * l[None, :]).reshape(-1)
        return lam

    def _mode_products(self, tensor, mats):
        """mats[d] applied along axis d of ``tensor`` (n_1, ..., n_D, dy)."""
        out = tensor
        for d, M in enumerate(mats):
            out = torch.movedim(torch.tensordot(M, out, dims=([1], [d])), 0, d)
        return out

    # -- NLML --------------------------------------------------------------------

    def log_likelihood(self, x=None, y=None, generator=None):
        if x is not None:
            raise ValueError("GridGPR is tied to its grid; x override unsupported")
        y = y if y is not None else self.Y
        n, dy = y.shape
        sigma2 = self.likelihood.variance.value.reshape(())
        lams, qs = self._eigs()
        denom = self._kron_eigs(lams) + sigma2
        ytil = self._mode_products(y.reshape(self.grid_sizes + (dy,)), [q.T for q in qs]).reshape(n, dy)
        quad = torch.sum(torch.square(ytil) / denom[:, None])
        logdet = torch.sum(torch.log(denom))
        return -0.5 * (quad + dy * logdet + n * dy * math.log(2.0 * math.pi))

    # -- prediction ---------------------------------------------------------------

    def _alpha(self):
        """K_yy⁻¹ Y on the grid, with the pieces it was built from."""
        n, dy = self.Y.shape
        sigma2 = self.likelihood.variance.value.reshape(())
        lams, qs = self._eigs()
        lam = self._kron_eigs(lams)
        ytil = self._mode_products(self.Y.reshape(self.grid_sizes + (dy,)), [q.T for q in qs]).reshape(n, dy)
        scaled = (ytil / (lam + sigma2)[:, None]).reshape(self.grid_sizes + (dy,))
        return self._mode_products(scaled, qs), lams, qs, lam, sigma2

    def _predict(self, x_new, diag=True):
        """Posterior at arbitrary (off-grid) points: :func:`grid_predict`
        (diagonal, or the full (nt, nt) covariance, O(nt²·N))."""
        alpha, _, qs, lam, sigma2 = self._alpha()
        return grid_predict(self._kernels(), self._axes(), qs, alpha, lam, sigma2, x_new, diag)

    @torch.no_grad()
    def posterior(self):
        """Cached predictive posterior: the per-axis eigendecompositions and
        the alpha grid computed once."""
        from .posterior import GridGPRPosterior

        alpha, _, qs, lam, _ = self._alpha()
        return GridGPRPosterior(self._kernels(), self.likelihood, self._axes(), alpha, qs, lam)
