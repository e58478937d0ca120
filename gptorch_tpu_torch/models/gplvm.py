"""Bayesian GPLVM: variational latent-variable GP (collapsed bound).

Counterpart of ``gptorch_tpu/models/gplvm.py`` -- Titsias & Lawrence
(2010), "Bayesian Gaussian Process Latent Variable Model", with the
collapsed evidence lower bound built from the ψ-statistics of
:mod:`gptorch_tpu_torch.ekernels`:

    q(X) = Π_i N(x_i | μ_i, diag(s_i)),   p(X) = Π_i N(0, I)

    F = -np/2·log 2π + np/2·log β - p·Σ log diag L_B
        - β/2·‖Y‖² + ½‖c‖² - βp/2·ψ₀ + p/2·tr(A)
        - KL[q(X) ‖ p(X)]

    with  L = chol(Kuu),  A = β·L⁻¹Ψ₂L⁻ᵀ,  B = I + A,  L_B = chol(B),
          c = β·L_B⁻¹L⁻¹Ψ₁ᵀY,
          KL = ½ Σ_iq (μ²_iq + s_iq - log s_iq - 1).

A temporal (dynamical) prior over the latents and Damianou's
reparameterized q(X) are options of the constructor.  The bound holds no
host read, so ``fit_scan`` captures it on the card under the ``fixed`` or
``none`` jitter policy (the ``adaptive`` one probes on the host, see
:func:`~gptorch_tpu_torch.training.fit.captures`).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import ekernels
from .. import kernels as _k
from ..functions import add_diag, cholesky, lt_log_determinant, trtrs
from ..likelihoods import Gaussian
from ..param import Param, positive_param
from ..training import fit as _fit
from ..util import PCA, as_array, kmeans_centers
from .base import GPModel, _coerce_io
from .sparse_gpr import _diag_or_full, _low_rank_wG


class GPLVM(GPModel):
    """Bayesian GPLVM with the collapsed (Titsias-Lawrence) bound.

    :param y: observations (n, p).
    :param latent_dim: dimensionality q of the latent space.
    :param kernel: a ψ-statistics kernel (:class:`gptorch_tpu_torch.ekernels.Rbf`
        / ``.Linear``); ``ekernels.Rbf(q, ARD=True)`` if omitted.
    :param num_inducing_points: M (default clip(n//10, 1, 100)), placed by
        k-means on the PCA start unless ``inducing_points`` are given.
    :param jitter: the always-on relative floor jitter of Kuu: the GPLVM
        moves its inducing points through a changing latent space and
        drives Kuu near-singular, where the factorization succeeds but the
        trailing solves explode.
    :param times: (n,) or (n, 1) timestamps: a dynamical prior
        p(x_:q) = N(0, K_t) over them (Damianou's variational GP dynamical
        system) instead of the iid N(0, I); ``time_kernel`` defaults to
        ``kernels.Rbf(1, length_scales=ptp(times)/2)``.
    :param large_p: evaluate the bound against YYᵀ, cached once, so no
        (n, p) or (m, p) intermediate is formed in a step (default: p > n).
    :param reparam: (dynamical only) Damianou's (3.30) q(X): per latent
        dim, q(x_:q) = N(K_t μ̄_q, (K_t⁻¹ + diag(λ_q))⁻¹) with free (μ̄, λ > 0).
    """

    def __init__(
        self,
        y,
        latent_dim: int,
        kernel=None,
        num_inducing_points: Optional[int] = None,
        inducing_points=None,
        likelihood=None,
        jitter: float = 1e-6,
        times=None,
        time_kernel=None,
        large_p: Optional[bool] = None,
        reparam: bool = False,
        name: str = "gplvm",
        device=None,
    ):
        y = np.asarray(y.detach().cpu() if isinstance(y, torch.Tensor) else y, dtype=float)
        n = y.shape[0]
        # latents start at the PCA projection, random when q exceeds p
        if latent_dim <= y.shape[1]:
            x_init = PCA(y, latent_dim)
            x_init = x_init / max(x_init.std(), 1e-12)
        else:
            x_init = np.random.RandomState(0).randn(n, latent_dim)

        if kernel is None:
            kernel = ekernels.Rbf(latent_dim, ARD=True)
        if not hasattr(kernel, "eKxz"):
            raise TypeError("GPLVM requires a kernel with psi-statistics (gptorch_tpu_torch.ekernels.Rbf / .Linear)")
        if likelihood is None:
            likelihood = Gaussian(variance=max(0.01 * y.var(), 1e-6))

        super().__init__(x_init, y, kernel, likelihood, None, name, device=device)
        device = self.device

        if inducing_points is None:
            if num_inducing_points is None:
                num_inducing_points = int(np.clip(n // 10, 1, 100))
            num_inducing_points = min(num_inducing_points, n)
            inducing_points = kmeans_centers(x_init, num_inducing_points, perturb_if_fail=True)
        self.Z = Param(as_array(np.asarray(inducing_points), device=device))

        self.large_p = bool(y.shape[1] > n) if large_p is None else bool(large_p)
        if self.large_p:
            self.register_buffer("_YYT", self.Y @ self.Y.T)  # (n, n), computed once
            self.register_buffer("_trYY", torch.sum(torch.square(self.Y)).reshape(()))

        self.dynamical = times is not None
        if self.dynamical:
            times = np.asarray(times, dtype=float).reshape(-1, 1)
            if times.shape[0] != n:
                raise ValueError("times must have one entry per datum")
            if time_kernel is None:
                time_kernel = _k.Rbf(1, length_scales=0.5 * float(np.ptp(times) or 1.0))
            self.register_buffer("times", as_array(times, device=device))
            self.time_kernel = time_kernel.to(device)

        if reparam and not self.dynamical:
            raise ValueError(
                "reparam=True is the (3.30) reparameterization of q(X) under the temporal prior; it requires times="
            )
        self.reparam = bool(reparam)
        if self.reparam:
            # the implied mean K_t μ̄ starts near x_init, and λ = 1.  The
            # solve is ridged (1e-2, not the 1e-6 floor): the exact
            # K_t⁻¹x_init amplifies what high frequencies PCA left in
            # x_init through the smooth prior's tiny eigenvalues.
            with torch.no_grad():
                Kt0 = self.time_kernel.K(self.times).cpu().numpy()
            Kt0 = Kt0 + 1e-2 * np.mean(np.diag(Kt0)) * np.eye(n)
            self.Xbar = Param(as_array(np.linalg.solve(Kt0, x_init), device=device))
            self.Xlambda = positive_param(as_array(np.ones_like(x_init), device=device))
        else:
            self.Xmean = Param(as_array(x_init, device=device))
            self.Xvar = positive_param(as_array(0.1 * np.ones_like(x_init), device=device))
        self.jitter = float(jitter)

    @property
    def num_inducing(self) -> int:
        return self.Z.shape[0]

    @property
    def latent_dimension(self) -> int:
        return (self.Xbar if self.reparam else self.Xmean).shape[1]

    def _kuu(self, Z):
        """K(Z, Z) with the always-on relative floor jitter."""
        Kuu = self.kernel.K(Z)
        return add_diag(Kuu, self.jitter * torch.mean(torch.diagonal(Kuu)))

    # -- bound ------------------------------------------------------------------

    @staticmethod
    def _low_rank_blocks(Psi1, Psi2, y, beta, L):
        """The factor chain shared by the bound and the posterior:
        A = βL⁻¹Ψ₂L⁻ᵀ, L_B = chol(A + I), c = βL_B⁻¹L⁻¹Ψ₁ᵀY (y may be None
        to skip c)."""
        A = beta * trtrs(trtrs(Psi2, L).T, L)
        LB = cholesky(A + torch.eye(A.shape[0], dtype=A.dtype, device=A.device))
        c = None if y is None else beta * trtrs(trtrs(Psi1.T @ y, L), LB)
        return A, LB, c

    @staticmethod
    def _bound_terms(n, p, beta, LB, y2, c2, psi0, A):
        """The data-fit bound from its pieces: ‖Y‖² (``y2``) and ‖c‖²
        (``c2``) are the only terms the large-p form computes otherwise."""
        elbo = -0.5 * n * p * math.log(2.0 * math.pi)
        elbo = elbo + 0.5 * n * p * torch.log(beta)
        elbo = elbo - p * lt_log_determinant(LB)
        elbo = elbo - 0.5 * beta * y2
        elbo = elbo + 0.5 * c2
        elbo = elbo - 0.5 * beta * p * psi0
        return elbo + 0.5 * p * torch.diagonal(A).sum()  # not torch.trace: its backward reads the host

    @classmethod
    def _collapsed_likelihood(cls, psi0, Psi1, Psi2, y, beta, L):
        """The data-fit part of the collapsed bound (all but the KL over the
        latents) from the ψ-statistics and L = chol(Kuu)."""
        n, p = y.shape
        A, LB, c = cls._low_rank_blocks(Psi1, Psi2, y, beta, L)
        return cls._bound_terms(n, p, beta, LB, torch.sum(torch.square(y)), torch.sum(torch.square(c)), psi0, A)

    def _collapsed_likelihood_large_p(self, psi0, Psi1, Psi2, beta, L, n, p):
        """The data-fit bound against the cached YYᵀ, independent of p:

            ‖Y‖² = tr(YYᵀ)                         (cached scalar)
            ‖c‖² = β²·tr(TᵀT · YYᵀ),  T = L_B⁻¹L⁻¹Ψ₁ᵀ   (m, n)

        -- O(n²m) per step with no (n, p) intermediate."""
        A, LB, _ = self._low_rank_blocks(Psi1, Psi2, None, beta, L)
        T = trtrs(trtrs(Psi1.T, L), LB)  # (m, n)
        c2 = beta ** 2 * torch.sum((T.T @ T) * self._YYT)
        return self._bound_terms(n, p, beta, LB, self._trYY, c2, psi0, A)

    def _kt_chol(self):
        """K_t (with its 1e-6 relative floor) and its Cholesky factor."""
        Kt = self.time_kernel.K(self.times)
        Kt = add_diag(Kt, 1e-6 * torch.mean(torch.diagonal(Kt)))
        return Kt, cholesky(Kt)

    def _latents_and_kl(self):
        """(Xmean (n, q), Xvar (n, q) marginal variances, KL[q(X)‖p(X)]).

        * iid prior, diagonal q:  KL = ½Σ(μ² + s − log s − 1).
        * dynamical prior, diagonal q:
          KL_q = ½[tr(K_t⁻¹S_q) + μ_qᵀK_t⁻¹μ_q − n + log|K_t| − Σlog s_q].
        * dynamical prior, reparameterized q: μ_q = K_t μ̄_q,
          S_q = (K_t⁻¹ + Λ_q)⁻¹ = L_t C_q⁻¹ L_tᵀ with C_q = I + L_tᵀΛ_qL_t,
          KL_q = ½[tr(C_q⁻¹) + μ̄_qᵀK_t μ̄_q − n + log|C_q|]; the q latent
          dimensions' (n, n) systems are one batch of q.
        """
        if not self.dynamical:
            mu = self.Xmean.value
            s = self.Xvar.value
            return mu, s, 0.5 * torch.sum(torch.square(mu) + s - torch.log(s) - 1.0)

        n = self.times.shape[0]
        Kt, Lt = self._kt_chol()
        if self.reparam:
            mub = self.Xbar.value  # (n, q)
            lam = self.Xlambda.value  # (n, q) > 0
            eye = torch.eye(n, dtype=Kt.dtype, device=Kt.device)
            C = eye + (Lt.T[None, :, :] * lam.T[:, None, :]) @ Lt  # (q, n, n)
            LC = cholesky(C)
            M = trtrs(Lt.T.expand_as(LC), LC)  # L_C⁻¹ L_tᵀ; S = MᵀM
            s = torch.sum(torch.square(M), dim=-2)  # (q, n)
            tr_cinv = torch.sum(torch.square(trtrs(eye.expand_as(LC), LC)), dim=(-2, -1))
            kls = 0.5 * (tr_cinv + torch.sum(mub * (Kt @ mub), dim=0) - n + 2.0 * lt_log_determinant(LC))
            return Kt @ mub, s.T, torch.sum(kls)

        mu = self.Xmean.value
        s = self.Xvar.value
        mahal = torch.sum(torch.square(trtrs(mu, Lt)))
        Ktinv_diag = torch.diagonal(torch.cholesky_solve(torch.eye(n, dtype=Kt.dtype, device=Kt.device), Lt))
        trace = torch.sum(Ktinv_diag[:, None] * s)
        q_dims = mu.shape[1]
        logdet_t = 2.0 * lt_log_determinant(Lt)
        kl = 0.5 * (trace + mahal - n * q_dims + q_dims * logdet_t - torch.sum(torch.log(s)))
        return mu, s, kl

    def _q_x(self):
        """Marginal moments (Xmean, Xvar) of q(X) under any parameterization."""
        mu, s, _ = self._latents_and_kl()
        return mu, s

    def _sigma2(self):
        return self.likelihood.variance.value.reshape(())

    def log_likelihood(self, x=None, y=None, generator=None):
        """Collapsed ELBO F(q) ≤ log p(Y) (see the module docstring)."""
        use_cached_yy = self.large_p and y is None
        y = y if y is not None else self.Y

        beta = 1.0 / self._sigma2()
        Z = self.Z.value
        Xmean, Xvar, kl = self._latents_and_kl()

        psi0 = torch.sum(self.kernel.eKxx(Xmean))
        Psi1 = self.kernel.eKxz(Z, Xmean, Xvar)
        Psi2 = self.kernel.eKzxKxz(Z, Xmean, Xvar, sum=True)
        L = cholesky(self._kuu(Z))

        if use_cached_yy:
            elbo = self._collapsed_likelihood_large_p(psi0, Psi1, Psi2, beta, L, y.shape[0], y.shape[1])
        else:
            elbo = self._collapsed_likelihood(psi0, Psi1, Psi2, y, beta, L)
        return elbo - kl

    def _kl_x(self):
        """KL[q(X) || p(X)] (see :meth:`_latents_and_kl`)."""
        return self._latents_and_kl()[2]

    # -- prediction ---------------------------------------------------------------

    def _posterior(self):
        """(L, L_B, c) of the predictive posterior over f at the trained
        variational quantities (c is O(nmp), fine for large-p models too:
        prediction happens once)."""
        beta = 1.0 / self._sigma2()
        Z = self.Z.value
        Xmean, Xvar = self._q_x()
        Psi1 = self.kernel.eKxz(Z, Xmean, Xvar)
        Psi2 = self.kernel.eKzxKxz(Z, Xmean, Xvar, sum=True)
        L = cholesky(self._kuu(Z))
        _, LB, c = self._low_rank_blocks(Psi1, Psi2, self.Y, beta, L)
        return L, LB, c

    def posterior(self):
        """Cached predictive posterior at deterministic latents
        (:func:`~gptorch_tpu_torch.models.posterior.gplvm_posterior`)."""
        from .posterior import gplvm_posterior

        return gplvm_posterior(self)

    def _predict(self, x_new, diag=True):
        """Posterior p(f* | Y) at deterministic latent points x_new -- the
        low-rank identities of VFE."""
        L, LB, c = self._posterior()
        tmp1 = trtrs(self.kernel.K(self.Z.value, x_new), L)
        tmp2 = trtrs(tmp1, LB)
        mean = tmp2.T @ c
        return mean, _diag_or_full(self.kernel, x_new, mean, tmp1, tmp2, diag)

    # -- test-time projection and imputation ------------------------------------

    def project(self, y_test, observed_dims=None, max_iter: int = 500, learning_rate: float = 0.05):
        """Infer q(x*) = N(μ*, diag(s*)) for new, possibly partially observed,
        outputs ``y_test``.

        The objective is the collapsed ELBO over the union of training and
        test data restricted to the observed output dims, with everything
        trained (hyperparameters, Z, q(X_train)) frozen and only (μ*, s*)
        optimized by Adam (optax's rule) for ``max_iter`` steps; the training
        latents' ψ-statistics and chol(Kuu) are computed once.  q(x*) starts
        at the training latent of the nearest neighbour in observed-data
        space.  The KL is the joint one (train part constant + test part),
        Titsias & Lawrence (2010) eqn (14).

        :param y_test: (n*, p) if fully observed, else (n*, len(observed_dims)).
        :param observed_dims: 1-D int array of observed output dims, or None.
        :return: (x_mean (n*, q), x_var (n*, q)) as numpy arrays.
        """
        if self.dynamical:
            raise NotImplementedError("project() supports the iid latent prior only (like the reference, gplvm.py:339)")
        from .posterior import _frozen

        y_test = np.atleast_2d(np.asarray(y_test, dtype=float))
        p_total = self.Y.shape[1]
        if observed_dims is None:
            if y_test.shape[1] != p_total:
                raise ValueError(
                    "Fully-observed y_test must have the training output dim; pass observed_dims for partial "
                    "observations"
                )
            obs = torch.arange(p_total, device=self.device)
        else:
            obs = torch.as_tensor(np.asarray(observed_dims, dtype=int), device=self.device)
            if y_test.shape[1] != obs.shape[0]:
                raise ValueError("y_test columns must match observed_dims")

        kernel = _frozen(self.kernel)
        with torch.no_grad():
            y_te = as_array(y_test, dtype=self.Y.dtype, device=self.device)
            Y_obs_tr = self.Y[:, obs]
            # nearest-neighbour start in observed-data space
            d2 = (
                torch.sum(y_te ** 2, 1, keepdim=True)
                + torch.sum(Y_obs_tr ** 2, 1)[None, :]
                - 2.0 * y_te @ Y_obs_tr.T
            )
            idx = torch.argmin(d2, dim=1)
            beta = 1.0 / self._sigma2()
            Z = self.Z.value
            Xmean, Xvar = self.Xmean.value, self.Xvar.value
            psi0_tr = torch.sum(kernel.eKxx(Xmean))
            Psi1_tr = kernel.eKxz(Z, Xmean, Xvar)
            Psi2_tr = kernel.eKzxKxz(Z, Xmean, Xvar, sum=True)
            L = cholesky(self._kuu(Z))
            kl_train = 0.5 * torch.sum(torch.square(Xmean) + Xvar - torch.log(Xvar) - 1.0)
            Y_joint = torch.cat([Y_obs_tr, y_te], dim=0)
            mu_t = Xmean[idx].clone().requires_grad_(True)
            log_s_t = torch.log(Xvar[idx]).requires_grad_(True)

        def neg_bound():
            s_t = torch.exp(log_s_t)
            psi0 = psi0_tr + torch.sum(kernel.eKxx(mu_t))
            Psi1 = torch.cat([Psi1_tr, kernel.eKxz(Z, mu_t, s_t)], dim=0)
            Psi2 = Psi2_tr + kernel.eKzxKxz(Z, mu_t, s_t, sum=True)
            elbo = self._collapsed_likelihood(psi0, Psi1, Psi2, Y_joint, beta, L)
            kl_test = 0.5 * torch.sum(torch.square(mu_t) + s_t - log_s_t - 1.0)
            return -(elbo - kl_train - kl_test)

        opt = _fit.make_optimizer("Adam", [mu_t, log_s_t], learning_rate)
        for _ in range(int(max_iter)):
            opt.zero_grad(set_to_none=True)
            neg_bound().backward()
            opt.step()
        return mu_t.detach().cpu().numpy(), torch.exp(log_s_t).detach().cpu().numpy()

    def impute(self, y_test, observed_dims, max_iter: int = 500, learning_rate: float = 0.05):
        """Predict the missing output dims of partially observed ``y_test``:
        :meth:`project` to q(x*), then :meth:`predict_uncertain` there.

        :return: (mean (n*, p_total), var (n*, p_total)) as numpy arrays
            over all output dims (observed columns are the model's
            reconstruction, not the inputs echoed back).
        """
        x_mean, x_var = self.project(y_test, observed_dims, max_iter=max_iter, learning_rate=learning_rate)
        return self.predict_uncertain(x_mean, x_var)

    @_coerce_io
    def predict_uncertain(self, x_mean, x_var):
        """Posterior moments at uncertain latent inputs N(x_mean, x_var) via
        ψ-statistics, from the sparse conditional's w = L⁻ᵀL_B⁻ᵀc and
        G = Kuu⁻¹ − (Kuu + βΨ₂)⁻¹ (whitened).

        :return: (mean (n*, p), var (n*, p))."""
        L, LB, c = self._posterior()
        w, G = _low_rank_wG(L, LB, c)
        return ekernels.uncertain_conditional(self.kernel, self.Z.value, w, G, x_mean, x_var)
