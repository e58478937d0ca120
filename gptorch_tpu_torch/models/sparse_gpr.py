"""Sparse GP regression: VFE (Titsias), FITC and SVGP (Hensman).

Counterpart of ``gptorch_tpu/models/sparse_gpr.py``, with the same algebra
and the same deliberate departures from the reference gptorch: inputs
first in every constructor, VFE uses the ``y`` it is given, a fresh
Gaussian likelihood per SVGP, FITC implemented (Snelson & Ghahramani 2006).

Minibatches are drawn without replacement from an explicit
``torch.Generator`` (the JAX package threads a PRNG key).  The two
packages draw different batches from the same seed, so they agree on a
minibatched loss only for a batch passed to both as ``(x, y)``.

On the card, ``Kuu`` (symmetric, no added diagonal), ``Kuf`` and ``Kus``
of an :class:`~gptorch_tpu_torch.kernels.Rbf` kernel are launches of the
Gram kernel (``csrc/rbf_gram.cu``); the products, Cholesky factors and
triangular solves are ``torch.linalg`` / ``torch.matmul``, as the JAX
package leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import settings
from ..bijectors import LowerCholesky
from ..functions import add_diag, cholesky, lt_log_determinant, trtrs
from ..likelihoods import Gaussian
from ..param import Param
from ..util import as_array, kmeans_centers
from .base import GPModel, _coerce_io
from .gpr import GPR


def kuu_with_jitter(kernel, z, jitter: float):
    """K(Z, Z) plus an optional relative diagonal floor ``jitter`` times the
    mean diagonal (0: the reference's jitter-on-failure-only behaviour)."""
    Kuu = kernel.K(z)
    if jitter:
        Kuu = add_diag(Kuu, jitter * torch.mean(torch.diagonal(Kuu)))
    return Kuu


def latent_marginals(kernel, z, q_mu, q_chol, x_new, jitter: float, diag=True):
    """Posterior moments and KL of one non-whitened SVGP latent:

        q(u) = N(q_mu, q_chol q_cholᵀ),  p(u) = N(0, Kuu)
        mu(x) = Kxu Kuu⁻¹ q_mu,  s(x) = Kxx_diag − ‖α‖² + ‖αᵀβ‖²

    :param q_mu: (m, 1).  :param q_chol: (m, m) lower.
    :return: (mu (n,), s, kl) with s the (n,) marginal variances
        (``diag=True``) or the (n, n) covariance.
    """
    Lu = cholesky(kuu_with_jitter(kernel, z, jitter), blocked=False)
    alpha = trtrs(kernel.K(z, x_new), Lu).T  # (n, m)
    beta = trtrs(q_chol, Lu)
    gamma = alpha @ beta
    Linv_mu = trtrs(q_mu, Lu)
    mu = (alpha @ Linv_mu)[:, 0]
    if diag:
        s = kernel.Kdiag(x_new) - torch.sum(torch.square(alpha), dim=1) + torch.sum(torch.square(gamma), dim=1)
    else:
        s = kernel.K(x_new) - alpha @ alpha.T + gamma @ gamma.T
    kl = (
        lt_log_determinant(Lu)
        - lt_log_determinant(q_chol)
        + 0.5 * (torch.sum(torch.square(beta)) - z.shape[0] + torch.sum(torch.square(Linv_mu)))
    )
    return mu, s, kl


def init_inducing_points(x, num_inducing_points=None, inducing_points=None):
    """Inducing inputs: ``inducing_points`` if given, else k-means centres
    of ``x`` (host arrays) with the reference's default count
    M = clip(n // 10, 1, 100)."""
    if inducing_points is not None:
        return inducing_points
    x = np.asarray(x, dtype=float)
    if num_inducing_points is None:
        num_inducing_points = int(np.clip(x.shape[0] // 10, 1, 100))
    return kmeans_centers(x.reshape(len(x), -1), num_inducing_points, perturb_if_fail=True)


def minibatch_indices(generator, n: int, batch_size: int, device):
    """``batch_size`` of the indices 0..n−1 drawn without replacement from
    ``generator`` (on ``device``)."""
    return torch.randperm(n, generator=generator, device=device)[:batch_size]


def draw_minibatch(generator, X, Y, batch_size: int):
    """``batch_size`` rows of (X, Y) drawn without replacement from
    ``generator`` (on X's device)."""
    idx = minibatch_indices(generator, X.shape[0], batch_size, X.device)
    return X[idx], Y[idx]


def _low_rank_solve(model, z, x, lam):
    """The low-rank factors shared by VFE's and FITC's predictions and
    posteriors: L = chol(Kuu), LB = chol(I + A Aᵀ) and c = LB⁻¹ A ỹ with
    A = L⁻¹Kuf / √λ and ỹ = (y − m(x)) / √λ, for a noise λ that is σ² (VFE:
    then c = LB⁻¹ L⁻¹Kuf (y − m(x)) / σ², the JAX package's c) or, given
    None, FITC's per-point Λ = diag(Kff − Qff) + σ².  Returns (L, LB, c)."""
    L = cholesky(model._kuu(z), blocked=False)
    V = trtrs(model.kernel.K(z, x), L)
    if lam is None:  # FITC's Λ from V
        lam = model.kernel.Kdiag(x) - torch.sum(torch.square(V), dim=0) + model._sigma2()
    root = torch.sqrt(lam)
    A = V / root
    LB = cholesky(add_diag(A @ A.T, 1.0), blocked=False)
    ytil = (model.Y - model.mean_function(x)) / (root[:, None] if root.ndim else root)
    c = trtrs(A @ ytil, LB)
    return L, LB, c


class _InducingPointsGP(GPModel):
    """Parent of the inducing-point models: inducing inputs Z (trainable,
    k-means-initialized by default) and an optional relative jitter floor
    on Kuu (``jitter``; ~1e-6 for training runs in which Z moves)."""

    def __init__(
        self,
        x,
        y,
        kernel,
        num_inducing_points: Optional[int] = None,
        inducing_points=None,
        mean_function=None,
        likelihood=None,
        jitter: float = 0.0,
        name: str = "sparse_gp",
        device=None,
    ):
        super().__init__(x, y, kernel, likelihood, mean_function, name, device=device)
        self.jitter = float(jitter)
        host_x = self.X.cpu().numpy() if inducing_points is None else None
        z = init_inducing_points(host_x, num_inducing_points, inducing_points)
        self.Z = Param(as_array(z if isinstance(z, torch.Tensor) else np.asarray(z), device=self.device))

    def _kuu(self, z):
        """K(Z, Z) (+ the optional relative floor jitter)."""
        return kuu_with_jitter(self.kernel, z, self.jitter)

    def _sigma2(self):
        return self.likelihood.variance.value.reshape(())

    @property
    def num_inducing(self) -> int:
        return self.Z.shape[0]

    def _uncertain_wG(self):
        """(w (m, p), G (m, m)) of the conditional
        f*(x) ~ N(k(x,Z) w, k(x,x) − k(x,Z) G k(Z,x))."""
        raise NotImplementedError

    @_coerce_io
    def predict_uncertain(self, x_mean, x_var):
        """Posterior moments at uncertain inputs x* ~ N(x_mean, x_var) via
        the kernel's ψ-statistics (moment matching, Girard et al. 2003),
        from the conditional's (w, G) (:meth:`_uncertain_wG`).  Build the
        model with a ψ-statistics kernel
        (:class:`gptorch_tpu_torch.ekernels.Rbf` / ``.Linear``).  At
        ``x_var = 0`` this equals ``predict_f``.

        :param x_mean: (n*, q) input means.
        :param x_var: (n*, q) diagonal or (n*, q, q) full covariances.
        :return: (mean (n*, p), var (n*, p)).
        """
        from ..ekernels import uncertain_predict

        w, G = self._uncertain_wG()
        return uncertain_predict(self.kernel, self.mean_function, self.Z.value.detach(), w, G, x_mean, x_var)


def _diag_or_full(kernel, x_new, mean, minus, plus, diag):
    """Kdiag − Σ minus² + Σ plus² over axis 0 (diag) broadcast to the
    mean's shape, or K − minusᵀminus + plusᵀplus (full), for (m, n*)
    factors."""
    if diag:
        var = kernel.Kdiag(x_new) - torch.sum(torch.square(minus), dim=0) + torch.sum(torch.square(plus), dim=0)
        return var[:, None].expand(mean.shape)
    return kernel.K(x_new) + plus.T @ plus - minus.T @ minus


class VFE(_InducingPointsGP):
    """Titsias (2009) collapsed variational free energy; any mean function
    (the residual y − m(x) is used throughout)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("name", "vfe")
        super().__init__(*args, **kwargs)

    def log_likelihood(self, x=None, y=None, generator=None):
        """Titsias Eqn (9) on (x, y) (default: the training data);
        ``generator`` is unused."""
        x = x if x is not None else self.X
        y = y if y is not None else self.Y
        num_data = x.shape[0]
        d_out = self.output_dimension
        err = y - self.mean_function(x)
        sigma2 = self._sigma2()

        Kff_diag = self.kernel.Kdiag(x)
        Kuf = self.kernel.K(self.Z.value, x)
        L = cholesky(self._kuu(self.Z.value), blocked=False)
        A = trtrs(Kuf, L)
        AAT = A @ A.T / sigma2
        LB = cholesky(add_diag(AAT, 1.0), blocked=False)
        c = trtrs(A @ err, LB) / sigma2

        elbo = -0.5 * d_out * num_data * math.log(2.0 * math.pi)
        elbo = elbo - d_out * lt_log_determinant(LB)
        elbo = elbo - 0.5 * d_out * num_data * torch.log(sigma2)
        elbo = elbo - 0.5 * (torch.sum(torch.square(err)) + d_out * torch.sum(Kff_diag)) / sigma2
        elbo = elbo + 0.5 * torch.sum(torch.square(c))
        elbo = elbo + 0.5 * d_out * torch.trace(AAT)
        return elbo

    def upper_bound(self):
        """Titsias (2014) upper bound on the log marginal likelihood:

            log p(y) ≤ −½ n log 2π − ½ log|Qff + σ²I| − ½ yᵀ(Qff + (σ² + t)I)⁻¹ y,
            t = tr(Kff − Qff) ≥ 0

        by the same low-rank identities as the ELBO; with
        :meth:`log_likelihood` it brackets the evidence."""
        x = self.X
        n = x.shape[0]
        d_out = self.output_dimension
        err = self.Y - self.mean_function(x)
        sigma2 = self._sigma2()

        Kff_diag = self.kernel.Kdiag(x)
        Kuf = self.kernel.K(self.Z.value, x)
        L = cholesky(self._kuu(self.Z.value), blocked=False)
        A = trtrs(Kuf, L)  # (m, n): Qff = AᵀA
        AAT = A @ A.T

        # log|Qff + σ²I| = n log σ² + log|I + AAᵀ/σ²|
        LB = cholesky(add_diag(AAT / sigma2, 1.0), blocked=False)
        logdet = n * torch.log(sigma2) + 2.0 * lt_log_determinant(LB)

        # the trace slack inflates the noise in the quadratic (Woodbury)
        t = torch.clamp(torch.sum(Kff_diag) - torch.sum(torch.square(A)), min=0.0)
        s2t = sigma2 + t
        LBt = cholesky(add_diag(AAT / s2t, 1.0), blocked=False)
        c = trtrs(A @ err, LBt) / s2t
        quad = torch.sum(torch.square(err)) / s2t - torch.sum(torch.square(c))
        return -0.5 * d_out * n * math.log(2.0 * math.pi) - 0.5 * d_out * logdet - 0.5 * quad

    def posterior(self):
        """Cached predictive posterior (:mod:`gptorch_tpu_torch.models.posterior`)."""
        from .posterior import vfe_posterior

        return vfe_posterior(self)

    def _predict(self, x_new, diag=True, x=None):
        """Low-rank posterior; Z is held fixed (detached), as in the
        reference."""
        x = x if x is not None else self.X
        z = self.Z.value.detach()
        L, LB, c = _low_rank_solve(self, z, x, self._sigma2())
        tmp1 = trtrs(self.kernel.K(z, x_new), L)
        tmp2 = trtrs(tmp1, LB)
        mean = tmp2.T @ c + self.mean_function(x_new)
        return mean, _diag_or_full(self.kernel, x_new, mean, tmp1, tmp2, diag)

    def _uncertain_wG(self):
        """w = L⁻ᵀLB⁻ᵀc, G = Kuu⁻¹ − L⁻ᵀB⁻¹L⁻¹ (the _predict identities with
        k(x, Z) factored out)."""
        L, LB, c = _low_rank_solve(self, self.Z.value.detach(), self.X, self._sigma2())
        return _low_rank_wG(L, LB, c)


def _low_rank_wG(L, LB, c):
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    Linv = trtrs(eye, L)
    LBinvLinv = trtrs(Linv, LB)
    return LBinvLinv.T @ c, Linv.T @ Linv - LBinvLinv.T @ LBinvLinv


class FITC(_InducingPointsGP):
    """Fully Independent Training Conditional (Snelson & Ghahramani 2006):

        Qff = Kfu Kuu⁻¹ Kuf,  Λ = diag(Kff − Qff) + σ²I,
        log p(y) = log N(y | m(x), Qff + Λ)

    by VFE's Woodbury/Cholesky identities with the per-point Λ in place of
    σ²."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("name", "fitc")
        super().__init__(*args, **kwargs)

    def log_likelihood(self, x=None, y=None, generator=None):
        """log N(y | m(x), Qff + Λ) on (x, y) (default: the training data);
        ``generator`` is unused."""
        x = x if x is not None else self.X
        y = y if y is not None else self.Y
        n, d_out = y.shape

        Kff_diag = self.kernel.Kdiag(x)
        Kuf = self.kernel.K(self.Z.value, x)
        L = cholesky(self._kuu(self.Z.value), blocked=False)
        V = trtrs(Kuf, L)
        lam = Kff_diag - torch.sum(torch.square(V), dim=0) + self._sigma2()

        A = V / torch.sqrt(lam)
        LB = cholesky(add_diag(A @ A.T, 1.0), blocked=False)
        ytil = (y - self.mean_function(x)) / torch.sqrt(lam)[:, None]
        c = trtrs(A @ ytil, LB)

        ll = -0.5 * d_out * n * math.log(2.0 * math.pi)
        ll = ll - d_out * lt_log_determinant(LB)
        ll = ll - 0.5 * d_out * torch.sum(torch.log(lam))
        ll = ll - 0.5 * torch.sum(torch.square(ytil))
        ll = ll + 0.5 * torch.sum(torch.square(c))
        return ll

    def posterior(self):
        """Cached predictive posterior."""
        from .posterior import fitc_posterior

        return fitc_posterior(self)

    def _predict(self, x_new, diag=True, x=None):
        x = x if x is not None else self.X
        z = self.Z.value.detach()
        L, LB, c = _low_rank_solve(self, z, x, None)
        tmp1 = trtrs(self.kernel.K(z, x_new), L)
        tmp2 = trtrs(tmp1, LB)
        mean = tmp2.T @ c + self.mean_function(x_new)
        return mean, _diag_or_full(self.kernel, x_new, mean, tmp1, tmp2, diag)

    def _uncertain_wG(self):
        """VFE's algebra with the per-point Λ in place of σ²."""
        L, LB, c = _low_rank_solve(self, self.Z.value.detach(), self.X, None)
        return _low_rank_wG(L, LB, c)


class SVGP(_InducingPointsGP):
    """Stochastic variational GP (Hensman et al. 2013/2015): an explicit
    q(u) = N(m, L_q L_qᵀ) with a LowerCholesky-constrained L_q, trained on
    the minibatched ELBO.

    ``whiten=True`` parameterizes q(v) = N(m, S) with u = L₀ v,
    L₀ = chol(Kuu): the prior on v is N(0, I), so the KL no longer involves
    Kuu.  Both parameterizations start from the same distribution.
    """

    def __init__(
        self,
        x,
        y,
        kernel,
        num_inducing_points: Optional[int] = None,
        inducing_points=None,
        mean_function=None,
        likelihood=None,
        batch_size: Optional[int] = None,
        jitter: float = 0.0,
        whiten: bool = False,
        name: str = "svgp",
        device=None,
    ):
        super().__init__(
            x,
            y,
            kernel,
            num_inducing_points=num_inducing_points,
            inducing_points=inducing_points,
            mean_function=mean_function,
            likelihood=likelihood if likelihood is not None else Gaussian(),
            jitter=jitter,
            name=name,
            device=device,
        )
        self.batch_size = batch_size
        self.whiten = bool(whiten)
        mean_init, chol_init = self._init_posterior()
        self.induced_output_mean = mean_init
        self.induced_output_chol_cov = chol_init
        # (mean, chol) trainable names of each Gaussian variational
        # distribution -- what training.natgrad reads.
        self.variational_groups = (("induced_output_mean", "induced_output_chol_cov"),)

    def log_likelihood(self, x=None, y=None, generator=None):
        """The ELBO on (x, y), scaled to the full data.  Without ``x`` and
        with ``batch_size`` set, a batch is drawn without replacement from
        ``generator`` (default: a fresh one from
        :func:`~gptorch_tpu_torch.settings.next_default_generator`)."""
        if x is None:
            if self.batch_size is not None:
                if generator is None:
                    generator = settings.next_default_generator(self.device)
                x, y = draw_minibatch(generator, self.X, self.Y, self.batch_size)
            else:
                x, y = self.X, self.Y
        elif y is None:
            raise ValueError("Provide y together with x")

        chol_kuu = cholesky(self._kuu(self.Z.value), blocked=False)
        f_mean, f_var = self._predict(x, diag=True, chol_kuu=chol_kuu)
        mll = self.likelihood.propagate_log(f_mean, f_var, y) * (self.num_data / x.shape[0])
        return mll - self._kl(chol_kuu)

    def _kl(self, chol_kuu):
        """KL[q(u) ‖ p(u)] summed over output dims:

            KL = d·[Σlog diag L₀ − Σlog diag L_q + ½(‖L₀⁻¹L_q‖² − m)] + ½ Σ_i ‖L₀⁻¹ m_i‖²

        and, whitened (prior N(0, I)),

            KL = d·[−Σlog diag L_q + ½(‖L_q‖² − m)] + ½ Σ_i ‖m_i‖²
        """
        m = self.num_inducing
        d_out = self.output_dimension
        Lq = self.induced_output_chol_cov.value
        logdetq = lt_log_determinant(Lq)
        if self.whiten:
            trace = torch.sum(torch.square(Lq))
            mahal = torch.sum(torch.square(self.induced_output_mean.value))
            return d_out * (-logdetq + 0.5 * (trace - m)) + 0.5 * mahal
        trace = torch.sum(torch.square(trtrs(Lq, chol_kuu)))
        mahal = torch.sum(torch.square(trtrs(self.induced_output_mean.value, chol_kuu)))
        return d_out * (lt_log_determinant(chol_kuu) - logdetq + 0.5 * (trace - m)) + 0.5 * mahal

    @torch.no_grad()
    def _init_posterior(self):
        """q(u) from the posterior at Z of an exact GPR on at most 100
        training points (the same ``RandomState(0)`` subsample as the JAX
        package), with a relative floor 1e-6·mean diag on its covariance
        (the subsampled posterior at dense Z is near-singular).  Returns
        (mean Param, LowerCholesky Param)."""
        n = self.num_data
        i = torch.as_tensor(np.random.RandomState(0).permutation(n)[: min(n, 100)], device=self.device)
        y = self.likelihood.latent_init(self.Y[i])
        # non-Gaussian likelihoods seed the latent GP at the likelihood's
        # latent scale, with a Gaussian of 1 % of its variance
        likelihood = (
            self.likelihood
            if isinstance(self.likelihood, Gaussian)
            else Gaussian(variance=float(0.01 * y.var(correction=0)))
        )
        model = GPR(self.X[i], y, self.kernel, mean_function=self.mean_function, likelihood=likelihood,
                    device=self.device)
        z = self.Z.value
        mean, cov = model.predict_f(z, diag=False)
        mean = mean - self.mean_function(z)
        chol_cov = cholesky(add_diag(cov, 1e-6 * torch.mean(torch.diagonal(cov))), blocked=False)
        if self.whiten:
            # the same distribution in v-space: m_v = L₀⁻¹ m_u, chol S_v = L₀⁻¹ chol S_u
            L0 = cholesky(self._kuu(z), blocked=False)
            mean = trtrs(mean, L0)
            chol_cov = trtrs(chol_cov, L0)
        return Param(mean), Param(chol_cov, transform=LowerCholesky())

    def posterior(self):
        """Cached predictive posterior."""
        from .posterior import svgp_posterior

        return svgp_posterior(self)

    def _predict(self, x_new, diag=True, chol_kuu=None):
        """Moments of q(f(x_new)).  Whitened, the projector Kfu Kuu⁻¹ L₀ is
        αᵀ, so the q parameters enter without L₀ solves."""
        z = self.Z.value
        chol_kuu = cholesky(self._kuu(z), blocked=False) if chol_kuu is None else chol_kuu
        alpha = trtrs(self.kernel.K(z, x_new), chol_kuu)  # (m, n*): αᵀ
        mu_x = self.mean_function(x_new)
        if self.whiten:
            beta = self.induced_output_chol_cov.value
            f_mean = alpha.T @ self.induced_output_mean.value + mu_x
        else:
            beta = trtrs(self.induced_output_chol_cov.value, chol_kuu)
            f_mean = alpha.T @ trtrs(self.induced_output_mean.value, chol_kuu) + mu_x
        return f_mean, _diag_or_full(self.kernel, x_new, f_mean, alpha, beta.T @ alpha, diag)

    def _uncertain_wG(self):
        """Non-whitened: w = Kuu⁻¹ q_mu, G = Kuu⁻¹ − Kuu⁻¹SKuu⁻¹.
        Whitened (u = L₀v): w = L₀⁻ᵀ m_v, G = L₀⁻ᵀ(I − S_v)L₀⁻¹."""
        L0 = cholesky(self._kuu(self.Z.value), blocked=False)
        Linv = trtrs(torch.eye(L0.shape[0], dtype=L0.dtype, device=L0.device), L0)
        Lq = self.induced_output_chol_cov.value
        mq = self.induced_output_mean.value
        if self.whiten:
            w, t = Linv.T @ mq, Linv.T @ Lq
        else:
            w, t = Linv.T @ (Linv @ mq), Linv.T @ (Linv @ Lq)
        return w, Linv.T @ Linv - t @ t.T
