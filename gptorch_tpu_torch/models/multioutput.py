"""Correlated-output GP regression: exact ICM and sparse-variational LMC.

Counterpart of ``gptorch_tpu/models/multioutput.py``:

* :class:`ICM` -- exact inference for the intrinsic coregionalization
  model over fully observed outputs, cov(y_q(x), y_q'(x')) = B_qq'·k(x, x')
  with B = W Wᵀ + diag(κ), through the two eigendecompositions
  K_x = Q_x Λ_x Q_xᵀ and B = Q_b Λ_b Q_bᵀ (``torch.linalg.eigh``, cuSOLVER
  on the card):

      NLML = ½ Σ_ij Ỹ²_ij/(λx_i λb_j + σ²) + ½ Σ log(λx_i λb_j + σ²) + c,
      Ỹ = Q_xᵀ Y Q_b.

* :class:`LMC` -- y(x) = W g(x) + ε with L independent latent GPs g_l and
  a Hensman-style q(u_l) per latent on shared inducing inputs; the ELBO
  needs only the marginal moments E[f] = μ Wᵀ, Var[f] = s (W²)ᵀ, so any
  likelihood works and the ELBO minibatches as SVGP's does.

Also the kernel container :class:`_KernelList` that LMC's latents and
SKI's per-dimension factors are held in.  An Rbf's Grams (ICM's K_x, each
latent's Kuu and Kuf) go through K1 on the card.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Optional

import numpy as np
import torch

from .. import settings
from ..bijectors import LowerCholesky
from ..functions import cholesky
from ..module import Module
from ..param import Param, positive_param
from ..sampling import standard_normal
from ..util import as_array
from .base import GPModel, _coerce_io


class _KernelList(Module):
    """A list of kernels registered as the attributes k0, k1, ..., so their
    Params have the JAX package's paths (``kernel.k0.variance``, ...)."""

    def __init__(self, kernels):
        super().__init__()
        self.n = len(kernels)
        for i, k in enumerate(kernels):
            setattr(self, f"k{i}", k)

    def __len__(self):
        return self.n

    def __iter__(self):
        return (getattr(self, f"k{i}") for i in range(self.n))

    def __getitem__(self, i):
        return getattr(self, f"k{int(i)}")


def _joint_samples(model, x_new, n_samples, generator):
    """Draws (S, nt, p) from a model's joint (point × output) posterior
    through its ``predict_f_joint``; the normals come from ``generator``
    (default :func:`~gptorch_tpu_torch.settings.next_default_generator`)."""
    from_numpy = isinstance(x_new, np.ndarray)
    ref = model._input_reference()
    with torch.no_grad() if from_numpy else contextlib.nullcontext():
        mean, cov = model.predict_f_joint(as_array(x_new, dtype=ref.dtype, device=ref.device))
    if generator is None:
        generator = settings.next_default_generator(mean.device)
    nt, p = mean.shape
    L = cholesky(cov.reshape(nt * p, nt * p))
    eps = standard_normal(generator, (n_samples, nt * p), mean)
    draws = (mean.reshape(-1)[None, :] + eps @ L.T).reshape(n_samples, nt, p)
    return draws.cpu().numpy() if from_numpy else draws


def _icm_predict(kernel, X, alpha, lx, qx, lb, qb, B, sigma2, x_new):
    """ICM posterior over all p outputs at x_new: mean K_*x α B (nt, p) and
    var_tq = B_qq·k** − Σ_ij (Q_xᵀk_*)²_i (Q_bᵀB_{:q})²_j / (λx_i λb_j + σ²),
    clamped at 0."""
    Ks = kernel.K(x_new, X)  # (nt, n)
    mean = Ks @ alpha @ B
    Wx2 = torch.square(qx.T @ Ks.T)  # (n, nt)
    Wb2 = torch.square(qb.T @ B)  # (p, p)
    inv = 1.0 / (lx[:, None] * lb[None, :] + sigma2)
    var = torch.clamp(kernel.Kdiag(x_new)[:, None] * torch.diagonal(B)[None, :] - Wx2.T @ inv @ Wb2, min=0.0)
    return mean, var


def _icm_joint(kernel, X, alpha, lx, qx, lb, qb, B, sigma2, x_new):
    """ICM joint posterior over the (nt, p) grid: mean (nt, p) and cov
    (nt, p, nt, p) = B ⊗ K** − H Hᵀ with H[(t,q),(i,j)] =
    (K_*x Q_x)[t,i]·(B Q_b)[q,j]·(λx_i λb_j + σ²)^(−½)."""
    nt, p = x_new.shape[0], B.shape[0]
    Ks = kernel.K(x_new, X)
    mean = Ks @ alpha @ B
    A = Ks @ qx  # (nt, n)
    C = B @ qb  # (p, p)
    sqrt_inv = 1.0 / torch.sqrt(lx[:, None] * lb[None, :] + sigma2)
    H = (A[:, None, :, None] * C[None, :, None, :] * sqrt_inv[None, None, :, :]).reshape(nt * p, -1)
    prior = kernel.K(x_new)[:, None, :, None] * B[None, :, None, :]
    cov = prior.reshape(nt * p, nt * p) - H @ H.T
    return mean, cov.reshape(nt, p, nt, p)


class ICM(GPModel):
    """Intrinsic coregionalization model over fully observed outputs.

    :param x: (n, d) inputs.
    :param y: (n, p) outputs (every output observed at every input).
    :param kernel: input-space kernel k(x, x').
    :param rank: rank r of the coregionalization factor W (default 1).
    :param device: see :class:`~gptorch_tpu_torch.models.base.GPModel`.
    """

    def __init__(self, x, y, kernel, rank: int = 1, likelihood=None, name="icm", device=None):
        super().__init__(x, y, kernel, likelihood, None, name, device=device)
        p = self.output_dimension
        rng = np.random.RandomState(0)
        self.W = Param(as_array(0.1 * rng.randn(p, rank), device=self.device))
        self.kappa = positive_param(as_array(np.ones(p), device=self.device))

    @property
    def rank(self) -> int:
        return self.W.shape[1]

    def coregion_matrix(self):
        """B = W Wᵀ + diag(κ)."""
        W = self.W.value
        return W @ W.T + torch.diag(self.kappa.value)

    def _eigs(self):
        lx, qx = torch.linalg.eigh(self.kernel.K(self.X))
        lb, qb = torch.linalg.eigh(self.coregion_matrix())
        return lx, qx, lb, qb

    def _sigma2(self):
        return self.likelihood.variance.value.reshape(())

    def log_likelihood(self, x=None, y=None, generator=None):
        if x is not None:
            raise ValueError("ICM ties training data at construction")
        y = y if y is not None else self.Y
        n, p = y.shape
        lx, qx, lb, qb = self._eigs()
        denom = lx[:, None] * lb[None, :] + self._sigma2()  # (n, p)
        ytil = qx.T @ y @ qb
        quad = torch.sum(torch.square(ytil) / denom)
        logdet = torch.sum(torch.log(denom))
        return -0.5 * (quad + logdet + n * p * math.log(2.0 * math.pi))

    def _pieces(self):
        """(α, λx, Qx, λb, Qb, B, σ²): α = K⁻¹ vec(Y) as an (n, p) matrix in
        the original bases, and what the predictions need beside it."""
        sigma2 = self._sigma2()
        lx, qx, lb, qb = self._eigs()
        denom = lx[:, None] * lb[None, :] + sigma2
        ytil = qx.T @ self.Y @ qb
        return qx @ (ytil / denom) @ qb.T, lx, qx, lb, qb, self.coregion_matrix(), sigma2

    @torch.no_grad()
    def posterior(self):
        """Cached predictive posterior: the O(n³ + p³) eigendecompositions
        once (:class:`~gptorch_tpu_torch.models.posterior.ICMPosterior`)."""
        from .posterior import ICMPosterior

        alpha, lx, qx, lb, qb, B, _ = self._pieces()
        return ICMPosterior(self.kernel, self.likelihood, self.X, alpha, lx, qx, lb, qb, B)

    def _predict(self, x_new, diag=True):
        """Posterior over all p outputs at x_new: mean (nt, p), var (nt, p)."""
        if not diag:
            raise NotImplementedError(
                "ICM full joint covariance across points AND outputs: use predict_f_joint(x_new)"
            )
        return _icm_predict(self.kernel, self.X, *self._pieces(), x_new)

    def predict_f_joint(self, x_new):
        """Joint posterior over the (nt, p) grid of test points × outputs:
        mean (nt, p), cov (nt, p, nt, p); ``cov.reshape(nt*p, nt*p)`` is the
        dense joint covariance in row-major (point, output) order."""
        return self.posterior().predict_f_joint(x_new)

    def predict_f_joint_samples(self, x_new, n_samples: int = 1, generator=None):
        """Output-correlated posterior draws (S, nt, p)."""
        return _joint_samples(self, x_new, n_samples, generator)


class LMC(GPModel):
    """Sparse-variational linear model of coregionalization,

        y(x) = W g(x) + ε,    g_l ~ GP(0, k_l) independent, W: (p, L),

    with shared inducing inputs Z (m, d) and per-latent q(u_l) = N(m_l, S_l)
    (``q_mu`` (m, L), ``q_chol`` (L, m, m)).

    :param kernels: a list of L latent kernels, or one kernel replicated
        ``num_latents`` times as independent deep copies (each latent its
        own Params).
    :param num_latents: L (only with a single kernel; default 1).
    :param device: see :class:`~gptorch_tpu_torch.models.base.GPModel`.
    """

    def __init__(self, x, y, kernels, num_latents: Optional[int] = None, num_inducing_points: Optional[int] = None,
                 inducing_points=None, likelihood=None, mean_function=None, batch_size: Optional[int] = None,
                 jitter: float = 1e-6, name: str = "lmc", device=None):
        if isinstance(kernels, (list, tuple)):
            if num_latents is not None and num_latents != len(kernels):
                raise ValueError("num_latents != len(kernels)")
            kernels = list(kernels)
        else:
            kernels = [copy.deepcopy(kernels) for _ in range(num_latents or 1)]
        super().__init__(x, y, _KernelList(kernels), likelihood, mean_function, name, device=device)
        L = len(kernels)
        p = self.output_dimension
        self.jitter = float(jitter)
        self.batch_size = batch_size

        from .sparse_gpr import init_inducing_points

        x_host = self.X.cpu().numpy()
        z = init_inducing_points(x_host, num_inducing_points, inducing_points)
        self.Z = Param(as_array(z if isinstance(z, torch.Tensor) else np.asarray(z), device=self.device))
        m = self.Z.shape[0]

        # the mixing matrix: Y's principal directions scaled by their
        # standard deviations for the first min(L, p) columns, small random
        # values for the rest
        yh = self.Y.cpu().numpy().astype(np.float64)
        yc = yh - yh.mean(0)
        evals, evecs = np.linalg.eigh(np.cov(yc.T).reshape(p, p))
        order = np.argsort(evals)[::-1]
        rng = np.random.RandomState(0)
        W0 = 0.1 * rng.randn(p, L)
        for l in range(min(L, p)):
            W0[:, l] = evecs[:, order[l]] * math.sqrt(max(evals[order[l]], 1e-12))
        self.W = Param(as_array(W0, device=self.device))

        # q(u) matched to the prior: m_l = 0, S_l = Kuu_l (KL = 0)
        self.q_mu = Param(as_array(np.zeros((m, L)), device=self.device))
        with torch.no_grad():
            chols = torch.stack([cholesky(self._kuu(self.Z.value, k)) for k in self.kernels])
        self.q_chol = Param(chols, transform=LowerCholesky())
        # the natural-gradient protocol (training.natgrad): stacked per-latent q
        self.variational_groups = (("q_mu", "q_chol"),)

    @property
    def kernels(self) -> _KernelList:
        return self.kernel

    @property
    def num_latents(self) -> int:
        return len(self.kernel)

    @property
    def num_inducing(self) -> int:
        return self.Z.shape[0]

    def _kuu(self, z, k):
        from .sparse_gpr import kuu_with_jitter

        return kuu_with_jitter(k, z, self.jitter)

    def _latent_moments(self, x_new, diag=True):
        """Per-latent posterior moments μ (n, L) and s ((n, L) marginals, or
        (L, n, n) covariances with ``diag=False``), and the summed KL."""
        from .sparse_gpr import latent_marginals

        z = self.Z.value
        mus, svars, kl = [], [], 0.0
        for l, k in enumerate(self.kernels):
            mu_l, s_l, kl_l = latent_marginals(k, z, self.q_mu.value[:, l : l + 1], self.q_chol.value[l], x_new,
                                               self.jitter, diag=diag)
            mus.append(mu_l)
            svars.append(s_l)
            kl = kl + kl_l
        return torch.stack(mus, dim=1), torch.stack(svars, dim=1 if diag else 0), kl

    def log_likelihood(self, x=None, y=None, generator=None):
        """The ELBO, minibatched from ``generator`` when ``batch_size`` is set
        (SVGP's pattern, the KL summed over latents)."""
        if x is None:
            if self.batch_size is not None:
                from .sparse_gpr import draw_minibatch

                if generator is None:
                    generator = settings.next_default_generator(self.device)
                x, y = draw_minibatch(generator, self.X, self.Y, self.batch_size)
            else:
                x, y = self.X, self.Y
        elif y is None:
            raise ValueError("Provide y together with x")
        mu, s, kl = self._latent_moments(x)
        W = self.W.value
        mean_f = mu @ W.T + self.mean_function(x)  # (n, p)
        var_f = s @ torch.square(W).T  # (n, p)
        mll = self.likelihood.propagate_log(mean_f, var_f, y) * (self.num_data / x.shape[0])
        return mll - kl

    def _predict(self, x_new, diag=True):
        """Marginal posterior over all p outputs: mean (n*, p), var (n*, p)."""
        if not diag:
            raise NotImplementedError(
                "LMC full joint covariance across points AND outputs: use predict_f_joint(x_new)"
            )
        mu, s, _ = self._latent_moments(x_new)
        W = self.W.value
        return mu @ W.T + self.mean_function(x_new), s @ torch.square(W).T

    @_coerce_io
    def predict_f_joint(self, x_new):
        """Joint posterior over the (nt, p) grid: cov[(t,q),(u,v)] =
        Σ_l W[q,l] W[v,l]·S_l[t,u]; returns mean (nt, p), cov (nt, p, nt, p)."""
        mu, S, _ = self._latent_moments(x_new, diag=False)
        W = self.W.value
        return mu @ W.T + self.mean_function(x_new), torch.einsum("ltu,ql,vl->tquv", S, W, W)

    def predict_f_joint_samples(self, x_new, n_samples: int = 1, generator=None):
        """Output-correlated posterior draws (S, nt, p)."""
        return _joint_samples(self, x_new, n_samples, generator)

    def posterior(self):
        """Cached predictive posterior: the L latents factored once
        (:func:`~gptorch_tpu_torch.models.posterior.lmc_posterior`)."""
        from .posterior import lmc_posterior

        return lmc_posterior(self)
