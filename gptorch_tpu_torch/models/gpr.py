"""Exact Gaussian-process regression.

Counterpart of ``gptorch_tpu/models/gpr.py`` -- GPML Algorithm 2.1:

    L = chol(K(X,X) + σ²I)
    α = L⁻¹ (y - m(X))
    log p(y) = -½ Σα² - dy·Σ log diag L - ½·dy·n·log 2π

and the posterior

    A = L⁻¹ K(X, X*)
    mean = Aᵀ(L⁻¹(y-m(X))) + m(X*)
    var  = Kdiag(X*) - ΣA²   (diag)  |  K(X*,X*) - AᵀA  (full)

The training loss routes as the JAX package's does: a radial kernel (Rbf,
Matern12/32/52, RationalQuadratic, ARD or not) with a Zero mean and Exp
bijectors takes the fused radial NLML (:mod:`~gptorch_tpu_torch.ops.gpr_fast`);
any other kernel without a White component takes the kernel-general fused
NLML (:mod:`~gptorch_tpu_torch.ops.gpr_general`); both at n ≥
``AUTO_FAST_MIN_N`` unless ``fast`` forces them on or off.  Everything else
takes the generic path (autograd through :func:`cholesky`).  Off the CPU
the fused radial path's backward launches the contraction kernel, which
takes d ≤ 32 and dy ≤ 32 (:mod:`~gptorch_tpu_torch.ops.contract`); wider
inputs there take the kernel-general path, which computes the same NLML and
gradient.  ``objective="loo"`` trains on the leave-one-out log predictive
probability instead (:meth:`GPR.loo_log_likelihood`).

``solver="iterative"`` takes the matrix-free BBMM path first
(:mod:`~gptorch_tpu_torch.ops.iterative`: batched preconditioned CG and
stochastic Lanczos quadrature through the hand-written kernels K3 and K4 on
the card): O(n·probes) memory, for n past the factorization's n² buffers.
It takes the radial configurations of the fused path at any n; any other
configuration raises at construction, and a minibatched loss raises at call
time, so the matrix-free path never falls back to a dense one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import kernels as _k
from .. import mean_functions as _m
from ..bijectors import Exp
from ..functions import add_diag, cholesky, lt_log_determinant, trtrs
from ..likelihoods import FixedNoiseGaussian, Gaussian
from ..ops.contract import kernel_takes
from ..ops.gpr_fast import radial_nlml
from ..ops.gpr_general import general_nlml
from ..ops.iterative import radial_nlml_iterative, radial_slq_diagnostics
from .base import GPModel, _coerce_io

#: Auto-routing threshold: below this n the generic autograd path is cheap;
#: at and above it the fused closed-form-backward paths are faster and
#: leaner in memory.
AUTO_FAST_MIN_N = 4096

_FAST_KINDS = (
    ("rbf", _k.Rbf),
    ("matern12", _k.Matern12),
    ("matern32", _k.Matern32),
    ("matern52", _k.Matern52),
    ("rq", _k.RationalQuadratic),
)


class GPR(GPModel):
    """Exact GP regression with a Gaussian likelihood.

    :param device: see :class:`~gptorch_tpu_torch.models.base.GPModel`.
    """

    _supports_fixed_noise = True  # the per-observation diagonal in _compute_kyy

    def __init__(
        self,
        x,
        y,
        kernel,
        mean_function=None,
        likelihood=None,
        name="gpr",
        fast=None,
        fast_block: int = 1024,
        fast_jitter: float = 0.0,
        fast_rel_jitter=None,
        fast_precision: str = "highest",
        objective: str = "nlml",
        solver: str = "dense",
        probes: int = 16,
        max_cg_iters: int = 256,
        precond_rank: int = 64,
        cg_tol: float = 1e-6,
        mvm_slab: int = 2048,
        probe_seed: int = 0,
        device=None,
    ):
        if objective not in ("nlml", "loo"):
            raise ValueError("objective must be 'nlml' or 'loo'")
        if solver not in ("dense", "iterative"):
            raise ValueError("solver must be 'dense' or 'iterative'")
        if fast_precision not in ("highest", "default"):
            raise ValueError("fast_precision must be 'highest' or 'default'")
        super().__init__(x, y, kernel, likelihood, mean_function, name, device=device)
        self.fast = fast if fast is None else bool(fast)
        self.fast_block = int(fast_block)
        self.fast_jitter = float(fast_jitter)
        if fast_rel_jitter is None:
            fast_rel_jitter = 1e-6 if self.X.dtype == torch.float32 else 0.0
        self.fast_rel_jitter = float(fast_rel_jitter)
        self.fast_precision = fast_precision
        self.objective = objective
        self.solver = solver
        if solver == "iterative" and not self._fast_eligible_config():
            # fail at construction: the matrix-free path exists to avoid the
            # dense one, so it never falls back to it
            raise ValueError(
                "solver='iterative' requires a radial kernel (Rbf/Matern*/RationalQuadratic incl. ARD), "
                f"Zero mean, and Exp bijectors; got kernel={type(kernel).__name__}, "
                f"mean={type(self.mean_function).__name__}"
            )
        self.probes = int(probes)
        self.max_cg_iters = int(max_cg_iters)
        self.precond_rank = int(min(precond_rank, self.X.shape[0]))
        self.cg_tol = float(cg_tol)
        self.mvm_slab = int(mvm_slab)
        if solver == "iterative":
            # standard-normal seeds drawn as the JAX package draws them,
            # warped to N(0, P) inside the op; fixed: a deterministic,
            # smooth objective (common random numbers)
            seeds = np.random.RandomState(probe_seed).randn(self.X.shape[0] + self.precond_rank, self.probes)
            self.register_buffer("probe_seeds", torch.as_tensor(seeds, dtype=self.X.dtype, device=self.X.device))

    def _fast_kind(self):
        for kind, cls in _FAST_KINDS:
            if type(self.kernel) is cls:
                return kind
        return None

    def _fast_eligible(self, x, y=None):
        """Whether the loss at (x, y) (default: the training targets) takes
        the fused radial path.  Off the CPU the contraction kernel must take
        the shapes (d ≤ 32, dy ≤ 32); wider ones go to the general path."""
        if self.fast is False:
            return False
        if self.fast is None and x.shape[0] < AUTO_FAST_MIN_N:
            return False
        dy = (y if y is not None else self.Y).shape[1]
        if x.device.type != "cpu" and not kernel_takes(x.shape[1], dy):
            return False
        return self._fast_eligible_config()

    def _general_eligible(self, x):
        """Eligibility for the kernel-general fused path: any kernel, mean
        and bijector, a Gaussian likelihood, and no White component in the
        kernel (its cross-covariance is zeros, so the row rebuild would drop
        its diagonal -- fold White into the noise instead)."""
        if self.fast is False:
            return False
        if self.fast is None and x.shape[0] < AUTO_FAST_MIN_N:
            return False
        has_white = any(isinstance(m, _k.White) for m in self.kernel.modules())
        return type(self.likelihood) is Gaussian and not has_white

    def _fast_eligible_config(self):
        """A radial kernel, a Zero mean, and Exp bijectors on every
        hyperparameter: the fused op reads the raw values as logs."""
        kind = self._fast_kind()
        ok = (
            type(self.likelihood) is Gaussian
            and kind is not None
            and isinstance(self.mean_function, _m.Zero)
            and isinstance(self.kernel.length_scales.bijector, Exp)
            and isinstance(self.kernel.variance.bijector, Exp)
            and isinstance(self.likelihood.variance.bijector, Exp)
        )
        if ok and kind == "rq":
            ok = isinstance(self.kernel.alpha.bijector, Exp)
        return ok

    def _iterative_eligible(self, x):
        """Whether the loss at ``x`` takes the matrix-free path: always for
        ``solver="iterative"`` (whose configuration the constructor checked)
        on the model's own n; a minibatch raises."""
        if self.solver != "iterative":
            return False
        if x.shape[0] != self.X.shape[0]:
            raise ValueError(
                f"solver='iterative' GPR got x with {x.shape[0]} rows but was built with n={self.X.shape[0]}: "
                "minibatched loss is not supported on the matrix-free path (it would silently fall back to "
                "the dense O(n^2) autograd path)"
            )
        return self._fast_eligible_config()

    def _iterative_args(self):
        """The log hyperparameters the iterative ops take: (kind, log ℓ,
        log σ², log σ_n², log α or None)."""
        kind = self._fast_kind()
        log_extra = self.kernel.alpha.raw.reshape((1,)) if kind == "rq" else None
        return (
            kind,
            self.kernel.length_scales.raw,
            self.kernel.variance.raw.reshape(()),
            self.likelihood.variance.raw.reshape(()),
            log_extra,
        )

    def _capturable(self) -> bool:
        """The iterative solver's SLQ runs a batched ``torch.linalg.eigh``,
        which checks its status on the host."""
        return self.solver != "iterative"

    def _reads_jitter_policy(self) -> bool:
        """The fused and iterative paths use fixed jitters; the generic path
        and the leave-one-out objective go through ``functions.cholesky``."""
        if self.objective == "loo":
            return True
        return not (self.solver == "iterative" or self._fast_eligible(self.X) or self._general_eligible(self.X))

    def log_likelihood(self, x=None, y=None, generator=None):
        """The log marginal likelihood; ``generator`` is accepted for the
        common signature and unused (no minibatches)."""
        x = x if x is not None else self.X
        y = y if y is not None else self.Y
        if self._iterative_eligible(x):
            kind, log_ell, log_var, log_noise, log_extra = self._iterative_args()
            return -radial_nlml_iterative(
                kind, log_ell, log_var, log_noise, x.detach(), y.detach(), self.probe_seeds,
                self.fast_jitter, self.mvm_slab, self.probes, self.max_cg_iters, self.precond_rank,
                self.cg_tol, log_extra,
            )
        if self._fast_eligible(x, y):
            # x and y are data: detached, so no caller silently gets a zero
            # gradient for them from the closed-form backward.
            kind = self._fast_kind()
            log_extra = self.kernel.alpha.raw.reshape((1,)) if kind == "rq" else None
            return -radial_nlml(
                kind,
                self.kernel.length_scales.raw,
                self.kernel.variance.raw.reshape(()),
                self.likelihood.variance.raw.reshape(()),
                x.detach(),
                y.detach(),
                self.fast_jitter,
                self.fast_block,
                self.fast_rel_jitter,
                log_extra,
            )
        if self._general_eligible(x):
            return -general_nlml(
                self.kernel,
                self.mean_function,
                self.likelihood.variance.value.reshape(()),
                x.detach(),
                y.detach(),
                self.fast_jitter,
                self.fast_block,
                self.fast_rel_jitter,
                self.fast_precision,
            )
        num_input, dim_output = y.shape
        L = cholesky(self._compute_kyy(x=x), blocked=False)
        alpha = trtrs(y - self.mean_function(x), L)
        const = -0.5 * dim_output * num_input * math.log(2.0 * math.pi)
        return -0.5 * torch.sum(torch.square(alpha)) - dim_output * lt_log_determinant(L) + const

    def loo_log_likelihood(self, x=None, y=None):
        """Leave-one-out log predictive probability (GPML §5.4.2, eqs
        5.10-5.12), Σᵢ log p(yᵢ | X, y₋ᵢ, θ), from one factorization:

            α = K⁻¹(y − m(X)),  c = diag(K⁻¹) = Σₖ (L⁻¹)ₖᵢ²
            yᵢ − μ₋ᵢ = αᵢ / cᵢ,   σ²₋ᵢ = 1 / cᵢ

        so each point adds −½ log 2π + ½ log cᵢ − αᵢ²/(2cᵢ).  Differentiable
        (autograd); the factor is blocked from n = 4096 on, as in the JAX
        package (:func:`~gptorch_tpu_torch.functions.cholesky`)."""
        x = x if x is not None else self.X
        y = y if y is not None else self.Y
        r = y - self.mean_function(x)
        L = cholesky(self._compute_kyy(x=x))
        l_inv = trtrs(torch.eye(x.shape[0], dtype=x.dtype, device=x.device), L)
        c = torch.sum(torch.square(l_inv), dim=0)[:, None]  # diag(K⁻¹), (n, 1)
        alpha = l_inv.T @ (l_inv @ r)  # K⁻¹ r, (n, dy)
        return torch.sum(-0.5 * math.log(2.0 * math.pi) + 0.5 * torch.log(c) - torch.square(alpha) / (2.0 * c))

    def _loss(self, x=None, y=None, generator=None):
        if self.objective == "loo":
            return -(self.loo_log_likelihood(x=x, y=y) + self.log_prior())
        return super()._loss(x=x, y=y, generator=generator)

    def _compute_kyy(self, x=None):
        """K(X,X) + σ²I.  For an Rbf kernel the noise rides in the Gram's
        ``diag`` argument, which the card's kernel adds as it writes; a
        :class:`~gptorch_tpu_torch.likelihoods.FixedNoiseGaussian` adds its
        per-observation diagonal."""
        x = x if x is not None else self.X
        if isinstance(self.likelihood, FixedNoiseGaussian):
            return add_diag(self.kernel.K(x), self.likelihood.noise_diag(x.shape[0]).to(x.dtype))
        noise = self.likelihood.variance.value.reshape(()).to(x.dtype)
        if type(self.kernel) is _k.Rbf:
            return self.kernel.K(x, diag=noise)
        return add_diag(self.kernel.K(x), noise)

    def iterative_diagnostics(self):
        """SLQ/CG estimator diagnostics of a ``solver="iterative"`` model
        (:func:`~gptorch_tpu_torch.ops.iterative.radial_slq_diagnostics`) as
        numpy arrays: the per-probe logdet spread (``nlml_stderr``, its 1σ
        Monte-Carlo error in NLML units), the CG iterations used and the
        exact final residuals.  Use it to size ``probes`` and
        ``max_cg_iters`` on evidence for the data's n and conditioning."""
        if not self._iterative_eligible(self.X):
            raise ValueError("iterative_diagnostics requires solver='iterative'")
        kind, log_ell, log_var, log_noise, log_extra = self._iterative_args()
        out = radial_slq_diagnostics(
            kind, log_ell, log_var, log_noise, self.X, self.Y, self.probe_seeds, self.fast_jitter,
            self.mvm_slab, self.probes, self.max_cg_iters, self.precond_rank, self.cg_tol, log_extra,
        )
        return {k: v.detach().cpu().numpy() for k, v in out.items()}

    def posterior(self, love_rank=None):
        """Cached predictive posterior: factorizes Kyy once (dense solver) or
        CG-solves α once (iterative solver); each later predict costs one
        cross-Gram and a triangular solve, or a CG solve for the variances
        (see :mod:`gptorch_tpu_torch.models.posterior`).

        :param love_rank: iterative solver only: also cache a rank-k LOVE
            root-inverse (Pleiss et al. 2018), so a variance query costs one
            (k, n)·(n, n*) product instead of a CG solve.  The rank must
            cover the kernel spectrum's effective rank (~128 for smooth
            kernels on 1-2-D inputs, 256-512 for d ≳ 3 or short length
            scales).  ``None`` keeps CG-exact variances.
        """
        if self._iterative_eligible(self.X):
            from .posterior import iterative_gpr_posterior

            return iterative_gpr_posterior(self, love_rank=love_rank)
        if love_rank is not None:
            raise ValueError(
                "love_rank applies to solver='iterative' (the dense posterior's variances are already exact "
                "via the cached Cholesky factor)"
            )
        from .posterior import gpr_posterior

        return gpr_posterior(self)

    @_coerce_io
    def predict_uncertain(self, x_mean, x_var):
        """Posterior moments at uncertain inputs x* ~ N(x_mean, x_var) by
        moment matching through the kernel's ψ-statistics (Girard et al.
        2003): the exact-GP conditional is the Z = X case of the sparse
        one, f*(x) ~ N(k(x,X) α, k(x,x) − k(x,X)K⁻¹k(X,x)) with
        α = K⁻¹(y − m(X)) and G = K⁻¹.  Build the model with a ψ-statistics
        kernel (:class:`gptorch_tpu_torch.ekernels.Rbf` / ``.Linear``).  At
        ``x_var = 0`` this equals ``predict_f``.  It forms K⁻¹ and ψ₂ with
        Z = X, (n*, n, n) in row chunks: O(n*·n²) per call (dense solver
        only).

        :param x_mean: (n*, q) input means.
        :param x_var: (n*, q) diagonal or (n*, q, q) full covariances.
        :return: (mean (n*, p), var (n*, p)).
        """
        if self.solver != "dense":
            raise NotImplementedError(
                "predict_uncertain requires the dense solver (it needs the explicit K^-1)"
            )
        from ..ekernels import uncertain_predict

        x = self.X
        L = cholesky(self._compute_kyy(x=x))
        linv = trtrs(torch.eye(x.shape[0], dtype=x.dtype, device=x.device), L)
        w = linv.T @ (linv @ (self.Y - self.mean_function(x)))
        return uncertain_predict(self.kernel, self.mean_function, x, w, linv.T @ linv, x_mean, x_var)

    def _predict(self, x_new, diag=True):
        """Posterior p(f* | y) at x_new (an iterative model predicts through
        its posterior, CG-exact)."""
        if self._iterative_eligible(self.X):
            return self.posterior()._predict(x_new, diag=diag)
        x = self.X
        k_ys = self.kernel.K(x, x_new)
        L = cholesky(self._compute_kyy(x=x), blocked=False)
        A = trtrs(k_ys, L)
        V = trtrs(self.Y - self.mean_function(x), L)
        mean_f = A.T @ V + self.mean_function(x_new)
        if diag:
            var_f = (self.kernel.Kdiag(x_new) - torch.sum(A * A, dim=0))[:, None].expand(mean_f.shape)
        else:
            var_f = self.kernel.K(x_new) - A.T @ A
        return mean_f, var_f
