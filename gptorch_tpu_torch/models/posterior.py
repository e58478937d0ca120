"""Cached predictive posteriors for exact-GP serving.

Counterpart of the exact-GP part of ``gptorch_tpu/models/posterior.py``:
``model.posterior()`` factorizes once and returns a :class:`GPRPosterior`
whose predictions cost one cross-Gram and one triangular solve;
:meth:`GPRPosterior.for_serving` converts L to L⁻¹ once and returns a
:class:`ServingGPRPosterior` whose predictions are matrix products only.

A posterior is a frozen serving artifact: its factors are computed under
``torch.no_grad()``.  Its public predict methods follow the model's rule
(``_coerce_io``): numpy in, numpy out, without autograd; tensor in, tensor
out, in the caller's grad mode.
"""

from __future__ import annotations

import torch

from ..functions import cholesky, trtrs
from .base import Predictive, _coerce_io


class Posterior(Predictive):
    """Base: precomputed factors plus the model pieces needed to predict.
    Subclasses implement ``_predict(x_new, diag)``."""

    def _batched(self, x, batch_size, fn):
        parts = [fn(x[lo : lo + batch_size]) for lo in range(0, x.shape[0], batch_size)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    @_coerce_io
    def predict_f_batched(self, x_new, batch_size: int = 4096):
        """Diagonal ``predict_f`` over a large query set, ``batch_size``
        queries at a time: peak memory is one chunk's (n, batch_size)
        cross-Gram instead of (n, n*)."""
        return self._batched(x_new, batch_size, self._predict)

    @_coerce_io
    def predict_y_batched(self, x_new, batch_size: int = 4096):
        """Chunked ``predict_y``; see :meth:`predict_f_batched`."""
        return self._batched(x_new, batch_size, self._predict_y)


class GPRPosterior(Posterior):
    """Exact-GP posterior with cached L = chol(Kyy) and V = L⁻¹(Y − m(X))."""

    def __init__(self, kernel, likelihood, mean_function, X, L, V):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.mean_function = mean_function
        self.X = X
        self.L = L
        self.V = V

    def _predict(self, x_new, diag=True):
        k_ys = self.kernel.K(self.X, x_new)
        A = trtrs(k_ys, self.L)
        mean = A.T @ self.V + self.mean_function(x_new)
        if diag:
            var = (self.kernel.Kdiag(x_new) - torch.sum(A * A, dim=0))[:, None].expand(mean.shape)
        else:
            var = self.kernel.K(x_new) - A.T @ A
        return mean, var

    @torch.no_grad()
    def for_serving(self, nb: int = 1024, method: str = "blocked"):
        """One-time L → L⁻¹ conversion, returning a
        :class:`ServingGPRPosterior` whose every predict is matrix products.

        ``method="blocked"`` is the divide-and-conquer
        :func:`~gptorch_tpu_torch.ops.blocked.blocked_trtri`;
        ``method="solve"`` is one triangular solve against the identity."""
        if method == "solve":
            eye = torch.eye(self.L.shape[0], dtype=self.L.dtype, device=self.L.device)
            Linv = torch.linalg.solve_triangular(self.L, eye, upper=False)
        elif method == "blocked":
            from ..ops.blocked import blocked_trtri

            Linv = blocked_trtri(self.L, nb=nb)
        else:
            raise ValueError("method must be 'blocked' or 'solve'")
        alpha = Linv.T @ self.V
        return ServingGPRPosterior(self.kernel, self.likelihood, self.mean_function, self.X, Linv, alpha)


class ServingGPRPosterior(Posterior):
    """Exact-GP serving posterior built from L⁻¹ and α = K̂⁻¹(Y − m(X)):

        mean = K(x*, X) α + m(x*)
        W    = L⁻¹ K(X, x*)
        var  = Kdiag − ΣW²   /   K** − WᵀW             (diag / full)

    The same algebra as :class:`GPRPosterior` with the triangular solve
    replaced by a product, so the moments agree to factorization roundoff."""

    def __init__(self, kernel, likelihood, mean_function, X, Linv, alpha):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.mean_function = mean_function
        self.X = X
        self.Linv = Linv
        self.alpha = alpha

    def _predict(self, x_new, diag=True):
        k_xs = self.kernel.K(self.X, x_new)
        mean = k_xs.T @ self.alpha + self.mean_function(x_new)
        W = self.Linv @ k_xs
        if diag:
            var = (self.kernel.Kdiag(x_new) - torch.sum(W * W, dim=0))[:, None].expand(mean.shape)
        else:
            var = self.kernel.K(x_new) - W.T @ W
        return mean, var

    @_coerce_io
    def mean_only(self, x_new):
        """Mean prediction alone: one cross-Gram and one product, no n²
        term."""
        return self.kernel.K(x_new, self.X) @ self.alpha + self.mean_function(x_new)


def _gpr_factors(model):
    L = cholesky(model._compute_kyy())
    V = trtrs(model.Y - model.mean_function(model.X), L)
    return L, V


@torch.no_grad()
def gpr_posterior(model) -> GPRPosterior:
    """Factorize ``model`` once into a :class:`GPRPosterior`."""
    L, V = _gpr_factors(model)
    return GPRPosterior(model.kernel, model.likelihood, model.mean_function, model.X, L, V)
