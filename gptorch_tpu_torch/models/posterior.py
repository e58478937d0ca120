"""Cached predictive posteriors for serving.

Counterpart of the exact-GP and sparse parts of
``gptorch_tpu/models/posterior.py``: ``model.posterior()`` factorizes once
and returns a posterior whose predictions cost one cross-Gram and
triangular solves (:class:`GPRPosterior`; :class:`LowRankPosterior` for VFE
and FITC; :class:`SVGPPosterior`); its ``for_serving`` inverts the
triangular factors once and returns a serving twin whose predictions are
matrix products only.

A posterior is a frozen serving artifact: its factors are computed under
``torch.no_grad()``.  Its public predict methods follow the model's rule
(``_coerce_io``): numpy in, numpy out, without autograd; tensor in, tensor
out, in the caller's grad mode.
"""

from __future__ import annotations

import torch

from ..functions import cholesky, trtrs
from ..ops.blocked import blocked_trtri
from .base import Predictive, _coerce_io
from .sparse_gpr import _diag_or_full, _low_rank_solve


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


class LowRankPosterior(Posterior):
    """Sparse (VFE, FITC) posterior with cached L = chol(Kuu),
    LB = chol(B) and c; each predict is O(m²·n*)."""

    def __init__(self, kernel, likelihood, mean_function, Z, L, LB, c):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.mean_function = mean_function
        self.Z = Z
        self.L = L
        self.LB = LB
        self.c = c

    @torch.no_grad()
    def for_serving(self, nb: int = 1024):
        """E₁ = L⁻¹, E₂ = LB⁻¹L⁻¹ and w = E₂ᵀc, once →
        :class:`ServingLowRankPosterior`."""
        E1 = blocked_trtri(self.L, nb=nb)
        E2 = blocked_trtri(self.LB, nb=nb) @ E1
        return ServingLowRankPosterior(
            self.kernel, self.likelihood, self.mean_function, self.Z, E1, E2, E2.T @ self.c
        )

    def _predict(self, x_new, diag=True):
        Kus = self.kernel.K(self.Z, x_new)
        tmp1 = trtrs(Kus, self.L)
        tmp2 = trtrs(tmp1, self.LB)
        mean = tmp2.T @ self.c
        if self.mean_function is not None:
            mean = mean + self.mean_function(x_new)
        return mean, _diag_or_full(self.kernel, x_new, mean, tmp1, tmp2, diag)


class ServingLowRankPosterior(Posterior):
    """Sparse serving posterior from E₁ = L⁻¹, E₂ = LB⁻¹L⁻¹ and w = E₂ᵀc:
    each predict is two (m, m)×(m, n*) products, no triangular solve."""

    def __init__(self, kernel, likelihood, mean_function, Z, E1, E2, w):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.mean_function = mean_function
        self.Z = Z
        self.E1 = E1
        self.E2 = E2
        self.w = w

    def _predict(self, x_new, diag=True):
        Kus = self.kernel.K(self.Z, x_new)
        mean = Kus.T @ self.w
        if self.mean_function is not None:
            mean = mean + self.mean_function(x_new)
        return mean, _diag_or_full(self.kernel, x_new, mean, self.E1 @ Kus, self.E2 @ Kus, diag)


class SVGPPosterior(Posterior):
    """SVGP posterior with cached L = chol(Kuu), L⁻¹m_u and β = L⁻¹L_q."""

    def __init__(self, kernel, likelihood, mean_function, Z, L, Linv_m, beta):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.mean_function = mean_function
        self.Z = Z
        self.L = L
        self.Linv_m = Linv_m
        self.beta = beta

    @torch.no_grad()
    def for_serving(self, nb: int = 1024):
        """E₁ = L⁻¹, G = βᵀE₁ and w = E₁ᵀ(L⁻¹m_u), once →
        :class:`ServingSVGPPosterior`."""
        E1 = blocked_trtri(self.L, nb=nb)
        return ServingSVGPPosterior(
            self.kernel, self.likelihood, self.mean_function, self.Z, E1, self.beta.T @ E1, E1.T @ self.Linv_m
        )

    def _predict(self, x_new, diag=True):
        alpha_t = trtrs(self.kernel.K(self.Z, x_new), self.L)  # (m, n*)
        mean = alpha_t.T @ self.Linv_m + self.mean_function(x_new)
        return mean, _diag_or_full(self.kernel, x_new, mean, alpha_t, self.beta.T @ alpha_t, diag)


class ServingSVGPPosterior(Posterior):
    """SVGP serving posterior from E₁ = L⁻¹, G = (L⁻¹L_q)ᵀL⁻¹ and
    w = L⁻ᵀ(L⁻¹m_u): each predict is two (m, m)×(m, n*) products."""

    def __init__(self, kernel, likelihood, mean_function, Z, E1, G, w):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.mean_function = mean_function
        self.Z = Z
        self.E1 = E1
        self.G = G
        self.w = w

    def _predict(self, x_new, diag=True):
        kuf = self.kernel.K(self.Z, x_new)
        mean = kuf.T @ self.w + self.mean_function(x_new)
        return mean, _diag_or_full(self.kernel, x_new, mean, self.E1 @ kuf, self.G @ kuf, diag)


@torch.no_grad()
def vfe_posterior(model) -> LowRankPosterior:
    """Factorize a VFE model once into a :class:`LowRankPosterior`."""
    z = model.Z.value.detach()
    L, LB, c = _low_rank_solve(model, z, model.X, model._sigma2())
    return LowRankPosterior(model.kernel, model.likelihood, model.mean_function, z, L, LB, c)


@torch.no_grad()
def fitc_posterior(model) -> LowRankPosterior:
    """Factorize a FITC model once into a :class:`LowRankPosterior`."""
    z = model.Z.value.detach()
    L, LB, c = _low_rank_solve(model, z, model.X, None)
    return LowRankPosterior(model.kernel, model.likelihood, model.mean_function, z, L, LB, c)


@torch.no_grad()
def svgp_posterior(model) -> SVGPPosterior:
    """Factorize an SVGP model once into an :class:`SVGPPosterior`; a
    whitened q is already in L⁻¹-space."""
    z = model.Z.value.detach()
    L = cholesky(model._kuu(z))
    if model.whiten:
        Linv_m = model.induced_output_mean.value
        beta = model.induced_output_chol_cov.value
    else:
        Linv_m = trtrs(model.induced_output_mean.value, L)
        beta = trtrs(model.induced_output_chol_cov.value, L)
    return SVGPPosterior(model.kernel, model.likelihood, model.mean_function, z, L, Linv_m, beta)
