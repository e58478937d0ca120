"""KISS-GP: exact-GP inference under structured kernel interpolation.

Counterpart of ``gptorch_tpu/models/ski.py`` (Wilson & Nickisch 2015).  A
product-form stationary kernel is approximated on a regular grid,

    K(X, X)  ≈  W K_g Wᵀ,      K_g = T_1 ⊗ … ⊗ T_d,

with sparse cubic-interpolation rows W and symmetric-Toeplitz factors T_k,
so one product costs O(n·4ᵈ + G log G) (:mod:`gptorch_tpu_torch.ops.ski`).
Inference runs the matrix-free machinery of
:mod:`gptorch_tpu_torch.ops.iterative` unchanged: batched CG solves and
stochastic Lanczos quadrature for the log-determinant.

Gradients follow the BBMM surrogate identities

    d/dθ log det K = tr(K⁻¹ dK)   ≈  E_z [(K⁻¹ z)ᵀ dK z]
    d/dθ yᵀ K⁻¹ y = −αᵀ dK α,

by differentiating K(θ)-products of detached CG solutions: no
differentiation through CG.  The only θ-dependent inputs are the per-axis
first kernel rows (``kernel.K`` on the grid axis) and the noise.

Wᵀ sums each grid node's entries in a fixed order built once for the
training stencil (:func:`~gptorch_tpu_torch.ops.ski.transpose_plan`), so
two identical calls give the same bits on the card.  SLQ's batched
``torch.linalg.eigh`` checks its status on the host: a training step is
not captured as a CUDA graph.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import likelihoods as _likelihoods
from ..kernels import Stationary
from ..ops import ski as _ski
from ..ops.iterative import lanczos_logdet_quadratic, mbcg
from ..util import as_array
from .base import GPModel, _coerce_io
from .multioutput import _KernelList
from .posterior import Posterior as _Posterior
from .posterior import _frozen

__all__ = ["SKIGPR", "SKIPosterior"]


class SKIGPR(GPModel):
    """Grid-interpolated exact GP (KISS-GP).

    :param kernels: one stationary kernel (``input_dim`` 1, for 1-D data)
        or a list of ``d`` one-dimensional stationary kernels forming the
        product kernel K(x, z) = Π_k k_k(x_k, z_k).
    :param grid_shape: grid nodes per dimension (int or tuple); a product
        costs O(n·4ᵈ + G log G), G = Π grid_shape; memory O(G).
    :param num_probes: SLQ probe vectors for the log-det estimate.
    :param max_cg_iters / cg_tol: the batched CG's budget.
    """

    def __init__(
        self,
        x,
        y,
        kernels,
        grid_shape=128,
        likelihood=None,
        mean_function=None,
        num_probes: int = 16,
        max_cg_iters: int = 256,
        cg_tol: float = 1e-6,
        jitter: float = 1e-6,
        probe_seed: int = 0,
        name: str = "ski_gpr",
        device=None,
    ):
        kernels = list(kernels) if isinstance(kernels, (list, tuple)) else [kernels]
        for k in kernels:
            if not isinstance(k, Stationary):
                raise ValueError(
                    "SKIGPR needs stationary per-dimension kernels (the "
                    f"grid factors must be Toeplitz); got {type(k).__name__}"
                )
            if k.input_dim != 1:
                raise ValueError(
                    "each SKI kernel factor is one-dimensional; got "
                    f"input_dim={k.input_dim} (pass a list of 1-D kernels "
                    "for multi-dimensional inputs)"
                )
        d = len(kernels)
        if isinstance(grid_shape, int):
            grid_shape = (grid_shape,) * d
        grid_shape = tuple(int(g) for g in grid_shape)
        if len(grid_shape) != d:
            raise ValueError("grid_shape must have one entry per dimension")
        if any(g < 8 for g in grid_shape):
            raise ValueError("grid axes need >= 8 nodes (cubic stencil + margin)")

        kernel = kernels[0] if d == 1 else _KernelList(kernels)
        super().__init__(x, y, kernel, likelihood=likelihood, mean_function=mean_function, name=name, device=device)
        if self.X.shape[1] != d:
            raise ValueError(f"got {d} kernel factor(s) for {self.X.shape[1]}-dimensional inputs")
        if likelihood is not None and not isinstance(likelihood, _likelihoods.Gaussian):
            raise ValueError("SKIGPR requires a Gaussian likelihood")

        self.grid_shape = grid_shape
        self.num_probes = int(num_probes)
        self.max_cg_iters = int(max_cg_iters)
        self.cg_tol = float(cg_tol)
        self.jitter = float(jitter)

        lows, spacings = _ski.make_grid(self.X, grid_shape)
        self.register_buffer("grid_lows", lows)
        self.register_buffer("grid_spacings", spacings)
        train_idx, train_w = self._stencil(self.X)
        self.register_buffer("_train_idx", train_idx)
        self.register_buffer("_train_w", train_w)
        for name, t in zip(("_wt_rows", "_wt_weights", "_wt_lengths"),
                           _ski.transpose_plan(train_idx, train_w, self.num_grid)):
            self.register_buffer(name, t)
        probes = np.sign(np.random.RandomState(probe_seed).randn(self.X.shape[0], self.num_probes))
        self.register_buffer("probes", as_array(probes, dtype=self.X.dtype, device=self.device))

    def _reads_jitter_policy(self) -> bool:
        return False  # CG and SLQ, no Cholesky

    def _capturable(self) -> bool:
        """SLQ's batched ``torch.linalg.eigh`` checks its status on the host."""
        return False

    # -- structure ----------------------------------------------------------

    @property
    def _factors(self):
        k = self.kernel
        return list(k) if isinstance(k, _KernelList) else [k]

    @property
    def _plan(self):
        """Wᵀ's fixed summation order for the training stencil."""
        return self._wt_rows, self._wt_weights, self._wt_lengths

    @property
    def num_grid(self) -> int:
        return int(np.prod(self.grid_shape))

    def _stencil(self, x):
        per_dim = []
        for k, g in enumerate(self.grid_shape):
            t = (x[:, k] - self.grid_lows[k]) / self.grid_spacings[k]
            per_dim.append(_ski.cubic_interp(t, g))
        return _ski.combine_dims(per_dim, self.grid_shape)

    def _rows(self):
        """Per-axis first kernel rows on the grid (differentiable in the
        kernel hyperparameters)."""
        rows = []
        for k, (factor, g) in enumerate(zip(self._factors, self.grid_shape)):
            nodes = (self.grid_lows[k] + torch.arange(g, dtype=self.X.dtype, device=self.device)
                     * self.grid_spacings[k])[:, None]
            rows.append(factor.K(nodes[:1], nodes)[0])
        return rows

    def _noise(self):
        return self.likelihood.variance.value.reshape(()) + self.jitter

    def _mvm(self, rows, noise, V):
        """(W K_g Wᵀ + noise·I) V, (n, t) -> (n, t)."""
        u = _ski.interp_rmatvec(self._train_idx, self._train_w, V, self.num_grid, plan=self._plan)
        u = _ski.kron_toeplitz_matvec(rows, u, self.grid_shape)
        out = _ski.interp_matvec(self._train_idx, self._train_w, u, plan=self._plan)
        return out + noise * V

    def _cg(self, rows, noise, B):
        return mbcg(lambda V: self._mvm(rows, noise, V), lambda V: V, B, max_iters=self.max_cg_iters,
                    tol=self.cg_tol)

    # -- training objective --------------------------------------------------

    def log_likelihood(self, x=None, y=None, generator=None):
        if x is not None or y is not None:
            raise ValueError(
                "SKIGPR's objective is tied to the training set (its "
                "interpolation stencil is precomputed); minibatch loss is "
                "not supported"
            )
        rows = self._rows()
        noise = self._noise()
        y_res = self.Y - self.mean_function(self.X)
        n, dy = y_res.shape
        Z = self.probes

        with torch.no_grad():
            sol, alphas, betas, valid = self._cg([r.detach() for r in rows], noise.detach(), torch.cat([y_res, Z], 1))
            logdet = lanczos_logdet_quadratic(alphas[:, dy:], betas[:, dy:], valid[:, dy:], torch.sum(Z * Z, dim=0), n)
        alpha, vz = sol[:, :dy], sol[:, dy:]
        quad = torch.sum(y_res * alpha)
        value = -0.5 * (dy * logdet + quad + n * dy * math.log(2.0 * math.pi))

        # BBMM surrogate: gradients by K(θ)-products of the detached solves
        kz = self._mvm(rows, noise, Z)
        s_logdet = torch.mean(torch.sum(vz * kz, dim=0))
        ka = self._mvm(rows, noise, alpha)
        s_quad = -torch.sum(alpha * ka)
        surrogate = -0.5 * (dy * s_logdet + s_quad)
        return (value - surrogate).detach() + surrogate

    # -- prediction ----------------------------------------------------------

    def _solve_alpha(self, rows, noise):
        return self._cg(rows, noise, self.Y - self.mean_function(self.X))[0]

    def _grid_weights(self, rows, alpha):
        """kg_u = K_g Wᵀ α: with it cached, a posterior mean at any x* is
        one interpolation gather, O(n*·4ᵈ)."""
        u = _ski.interp_rmatvec(self._train_idx, self._train_w, alpha, self.num_grid, plan=self._plan)
        return _ski.kron_toeplitz_matvec(rows, u, self.grid_shape)

    def _variance_terms(self, rows, noise, idx_s, w_s, x_new, diag):
        """(C, K⁻¹C, prior term) of the predictive second moment."""
        n_star = x_new.shape[0]
        eye = torch.eye(n_star, dtype=x_new.dtype, device=x_new.device)
        ws_t = _ski.interp_rmatvec(idx_s, w_s, eye, self.num_grid)  # (G, n*)
        s = _ski.kron_toeplitz_matvec(rows, ws_t, self.grid_shape)
        C = _ski.interp_matvec(self._train_idx, self._train_w, s, plan=self._plan)  # (n, n*)
        kinv_c = self._cg(rows, noise, C)[0]
        if diag:
            prior = torch.ones(n_star, dtype=x_new.dtype, device=x_new.device)
            for k, factor in enumerate(self._factors):
                prior = prior * factor.Kdiag(x_new[:, k:k + 1])
        else:
            prior = torch.ones((n_star, n_star), dtype=x_new.dtype, device=x_new.device)
            for k, factor in enumerate(self._factors):
                prior = prior * factor.K(x_new[:, k:k + 1])
        return C, kinv_c, prior

    def _predict(self, x_new, diag=True, _kg_u=None, _rows=None, _noise=None):
        rows = self._rows() if _rows is None else _rows
        noise = self._noise() if _noise is None else _noise
        if _kg_u is None:
            _kg_u = self._grid_weights(rows, self._solve_alpha(rows, noise))
        idx_s, w_s = self._stencil(x_new)
        mean = _ski.interp_matvec(idx_s, w_s, _kg_u) + self.mean_function(x_new)
        C, kinv_c, prior = self._variance_terms(rows, noise, idx_s, w_s, x_new, diag)
        if diag:
            var = torch.clamp(prior - torch.sum(C * kinv_c, dim=0), min=0.0)
            return mean, var[:, None].expand(mean.shape)
        return mean, prior - C.T @ kinv_c

    @torch.no_grad()
    def posterior(self):
        """Cached predictive posterior: one CG solve for α, then the grid
        weights K_g Wᵀ α are stored; each later mean is one O(n*·4ᵈ)
        interpolation (variances still run a CG on the cross-covariance
        columns per call)."""
        rows = self._rows()
        noise = self._noise()
        kg_u = self._grid_weights(rows, self._solve_alpha(rows, noise))
        return SKIPosterior(self, rows, noise, kg_u)


class SKIPosterior(_Posterior):
    """Serving wrapper over a fitted :class:`SKIGPR` (see
    ``SKIGPR.posterior``).  It holds a frozen copy of the model, so training
    the model afterwards does not change it."""

    def __init__(self, model, rows, noise, kg_u):
        super().__init__(None, model.likelihood, None)
        self.model = _frozen(model)
        self.rows = list(rows)
        self.noise = noise
        self.kg_u = kg_u

    def _input_reference(self):
        return self.model.X

    def _predict(self, x_new, diag=True):
        return self.model._predict(x_new, diag=diag, _kg_u=self.kg_u, _rows=self.rows, _noise=self.noise)

    @_coerce_io
    def predict_mean(self, x_new):
        """The mean only, with no CG: one interpolation gather per batch."""
        idx_s, w_s = self.model._stencil(x_new)
        return _ski.interp_matvec(idx_s, w_s, self.kg_u) + self.model.mean_function(x_new)
