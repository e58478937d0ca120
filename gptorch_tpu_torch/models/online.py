"""OnlineSGPR: streaming sparse GP with adapting hyperparameters.

Counterpart of ``gptorch_tpu/models/online.py`` (Bui, Nguyen & Turner
2017, "Streaming sparse Gaussian process approximations"): when a batch
arrives, the old posterior q_old(a) over the old inducing outputs a (at
Z_old, under the old kernel prior N(0, V_aa)) is carried forward as a
correction factor q_old(a)/p_old(a) in the new variational objective, so
the kernel hyperparameters, the noise and the inducing points keep
training online with the old batches summarised in O(M²).  For Gaussian
regression the factor is a block of pseudo-observations ŷ_a = D S_a⁻¹ m_a
at Z_old with correlated noise D, D⁻¹ = S_a⁻¹ − V_aa⁻¹, and the collapsed
online bound is

    F = −(p/2)[n log 2πσ² + log|B|] − ½(‖r_f‖² − ‖c‖²)
        − (p/2)[σ⁻²Σᵢ K_ff,ii − ‖A_f‖²_F]
        − (p/2)[tr(L_D⁻¹ K_aa L_D⁻ᵀ) − ‖A_a‖²_F]
        + (p/2)[log|V_aa| − log|S_a|] − ½Σ_j‖L_Sa⁻¹ m_j‖²

with A_f = L⁻¹K_bf/σ, A_a = L⁻¹K_ba L_D⁻ᵀ, B = I + A_fA_fᵀ + A_aA_aᵀ,
r_f = (y−μ(X))/σ, c = LB⁻¹(A_f r_f + A_a L_Dᵀ S_a⁻¹ m_a), every kernel
quantity under the current θ.  With θ and Z held fixed the streamed
posterior and the summed bounds equal batch VFE on the concatenated data.

:meth:`OnlineSGPR.step` trains by
:func:`~gptorch_tpu_torch.training.fit.fit_scan`, with a fresh optimizer
state per call.  On the card, where :func:`~gptorch_tpu_torch.training.fit.captures` allows
it, one optimizer step is a captured CUDA graph that later calls reuse
for the same batch size and the same ``has_old``: the batch is copied
into fixed buffers and :meth:`OnlineSGPR._absorb` overwrites the summary
(``Z_old``, ``m_a``, ``L_Sa``, ``V_aa``, ``L_Vaa``, ``L_D``, ``r_a``) in
place, so the graph's addresses stay valid.  Kuu, Kuf, K(Z, Z_old) and
Ksu of an :class:`~gptorch_tpu_torch.kernels.Rbf` kernel are launches of
``csrc/rbf_gram.cu``.

Under the ``fixed`` jitter policy the relative jitter on the factor of S_a
lifts S_a above V_aa in Kuu's near-null directions once θ has trained,
and chol(V_aa − S_a) is NaN, in the JAX package as here: capture under
``none``.  In float32 the 1e-10 floor on V_aa − S_a lies below the
rounding, and the summary goes NaN in both packages as well.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import likelihoods as _likelihoods
from .. import mean_functions as _means
from .. import settings
from ..functions import cholesky, trtrs
from ..param import Param
from ..util import as_array
from .base import Predictive, _coerce_io
from .sparse_gpr import kuu_with_jitter

def _chol(a):
    return cholesky(a, blocked=False)


class OnlineSGPR(Predictive):
    """Streaming sparse GP regression with online hyperparameter and
    inducing-point adaptation (Bui et al. 2017, Gaussian likelihood).

    Lifecycle: ``model.step(x_b, y_b, fit_iters=...)`` per batch: each step
    (optionally) trains (θ, σ², Z) on the online bound, then absorbs the
    batch into the O(M²) summary of the old posterior, from which
    predictions are served between steps.

    :param inducing_points: (M, d) initial inducing inputs (trainable).
    :param jitter: relative diagonal floor on the kernel's Grams (keep it
        above 0: a moving Z drives Kuu near-singular).
    :param device: where the model lives (see
        :func:`~gptorch_tpu_torch.settings.resolve_device`).
    """

    def __init__(
        self,
        kernel,
        inducing_points,
        likelihood=None,
        mean_function=None,
        jitter: float = 1e-6,
        name: str = "online_sgpr",
        output_dim: int = 1,
        device=None,
    ):
        super().__init__()
        device = settings.resolve_device(device)
        z = as_array(inducing_points if isinstance(inducing_points, torch.Tensor) else np.asarray(inducing_points),
                     device=device)
        if z.ndim == 1:
            z = z[:, None]
        self.kernel = kernel
        self.likelihood = likelihood if likelihood is not None else _likelihoods.Gaussian(0.1)
        if not isinstance(self.likelihood, _likelihoods.Gaussian):
            raise ValueError("OnlineSGPR needs a Gaussian likelihood")
        self.mean_function = (
            _means.as_mean_function(mean_function) if mean_function is not None else _means.Zero(output_dim)
        )
        self.Z = Param(z)
        self.jitter = float(jitter)
        self.name = name
        self.output_dim = int(output_dim)
        self.has_old = False
        self.register_buffer("X", z.new_zeros((0, z.shape[1])))
        self.register_buffer("Y", z.new_zeros((0, output_dim)))
        # the fixed buffers a batch of each size is copied into
        self._batch_buffers = {}
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.Z.raw.device

    @property
    def num_inducing(self) -> int:
        return self.Z.shape[0]

    def _input_reference(self) -> torch.Tensor:
        """Numpy inputs take Z's dtype and device (Z_old's once a batch has
        been absorbed: the same); X is empty between steps."""
        return self.Z_old if self.has_old else self.Z.raw

    def _reads_jitter_policy(self) -> bool:
        return True

    def _capturable(self) -> bool:
        return True

    # -- old-posterior summary ------------------------------------------------

    def _compute_d_factors(self):
        """(L_D, r_a) with D = S_a + T Tᵀ, T = S_a L_vs⁻ᵀ, L_vs = chol(V_aa −
        S_a), and r_a = L_Dᵀ S_a⁻¹ m_a (= L_D⁻¹ ŷ_a); θ-independent, so
        :meth:`_absorb` computes them once per step."""
        S_a = self.L_Sa @ self.L_Sa.T
        # relative floor: V − S can be numerically semidefinite where a
        # direction is barely informed (the JAX package's 1e-10)
        scale = torch.mean(torch.diagonal(self.V_aa))
        vs = self.V_aa - S_a + (1e-10 * scale) * torch.eye(S_a.shape[0], dtype=S_a.dtype, device=S_a.device)
        t = trtrs(S_a, _chol(vs)).T  # S_a L_vs⁻ᵀ
        L_D = _chol(S_a + t @ t.T)
        return L_D, L_D.T @ torch.cholesky_solve(self.m_a, self.L_Sa)

    # -- the online bound -----------------------------------------------------

    def log_likelihood(self, x=None, y=None, generator=None):
        """The collapsed online bound on the current batch (plus the old
        posterior's correction); ``generator`` is unused."""
        x = x if x is not None else self.X
        y = y if y is not None else self.Y
        if x.shape[0] == 0:
            raise ValueError("no current batch: call step(x_b, y_b) (the bound is defined per streamed batch)")
        n, p = y.shape
        z = self.Z.value
        eye = torch.eye(self.num_inducing, dtype=z.dtype, device=z.device)
        sigma2 = self.likelihood.variance.value.reshape(())

        L = _chol(kuu_with_jitter(self.kernel, z, self.jitter))
        a_f = trtrs(self.kernel.K(z, x), L) / torch.sqrt(sigma2)
        r_f = (y - self.mean_function(x)) / torch.sqrt(sigma2)

        out = -0.5 * p * n * torch.log(2.0 * torch.pi * sigma2)
        out = out - 0.5 * p * (torch.sum(self.kernel.Kdiag(x)) / sigma2 - torch.sum(torch.square(a_f)))
        b = eye + a_f @ a_f.T
        t_vec = a_f @ r_f
        if self.has_old:
            a_a = trtrs(trtrs(self.kernel.K(z, self.Z_old), L).T, self.L_D).T  # L⁻¹ K_ba L_D⁻ᵀ
            k_aa = kuu_with_jitter(self.kernel, self.Z_old, self.jitter)
            tr_a = torch.sum(torch.diagonal(trtrs(trtrs(k_aa, self.L_D).T, self.L_D)))  # tr(L_D⁻¹K_aaL_D⁻ᵀ)
            out = out - 0.5 * p * (tr_a - torch.sum(torch.square(a_a)))
            # θ-independent normalizer (values comparable across steps)
            out = out + p * (torch.sum(torch.log(torch.diagonal(self.L_Vaa)))
                             - torch.sum(torch.log(torch.diagonal(self.L_Sa))))
            out = out - 0.5 * torch.sum(torch.square(trtrs(self.m_a, self.L_Sa)))
            b = b + a_a @ a_a.T
            t_vec = t_vec + a_a @ self.r_a

        LB = _chol(b)
        c = trtrs(t_vec, LB)
        out = out - p * torch.sum(torch.log(torch.diagonal(LB)))
        return out - 0.5 * (torch.sum(torch.square(r_f)) - torch.sum(torch.square(c)))

    def loss(self, x=None, y=None, generator=None):
        return -(self.log_likelihood(x=x, y=y) + self.log_prior())

    def _loss(self, x=None, y=None, generator=None):
        return self.loss(x=x, y=y)

    # -- streaming lifecycle ---------------------------------------------------

    def _set_batch(self, x_b, y_b):
        """Copy the batch into the fixed buffers of its size, which become X
        and Y (a captured step reads them at the same addresses)."""
        x_b = as_array(x_b if isinstance(x_b, torch.Tensor) else np.asarray(x_b), dtype=self.Z.dtype,
                       device=self.device)
        y_b = as_array(y_b if isinstance(y_b, torch.Tensor) else np.asarray(y_b), dtype=self.Z.dtype,
                       device=self.device)
        x_b = x_b[:, None] if x_b.ndim == 1 else x_b
        y_b = y_b[:, None] if y_b.ndim == 1 else y_b
        key = (tuple(x_b.shape), tuple(y_b.shape))
        if key not in self._batch_buffers:
            self._batch_buffers[key] = (torch.empty_like(x_b), torch.empty_like(y_b))
        X, Y = self._batch_buffers[key]
        X.copy_(x_b)
        Y.copy_(y_b)
        self.X, self.Y = X, Y

    def step(self, x_b, y_b, fit_iters: int = 100, learning_rate: float = 0.05, method: str = "Adam") -> "OnlineSGPR":
        """Absorb one batch: train (θ, σ², Z) on the online bound for
        ``fit_iters`` steps of ``method`` (a fresh optimizer state per
        call; first-order methods only) by
        :func:`~gptorch_tpu_torch.training.fit.fit_scan`, then roll the
        batch into the summary of the old posterior.  A non-finite loss puts
        back the values the model had on entry and raises
        ``FloatingPointError``.  Mutates and returns self."""
        from ..training import fit

        if method == "LBFGS":
            raise ValueError(
                "OnlineSGPR.step supports first-order optimizers (each call runs a fixed number of steps)"
            )
        self._set_batch(x_b, y_b)
        if fit_iters > 0:
            fit.fit_scan(self, method, max_iter=fit_iters, learning_rate=learning_rate)
        self._absorb()
        return self

    def _collapsed_posterior(self):
        """The optimal q(u) at the current (θ, Z) given the batch and the old
        summary: (m_u (M, p), S_u (M, M), L = chol(Kzz))."""
        x, y = self.X, self.Y
        z = self.Z.value
        sigma2 = self.likelihood.variance.value.reshape(())

        L = _chol(kuu_with_jitter(self.kernel, z, self.jitter))
        a_f = trtrs(self.kernel.K(z, x), L) / torch.sqrt(sigma2)
        r_f = (y - self.mean_function(x)) / torch.sqrt(sigma2)
        b = torch.eye(self.num_inducing, dtype=z.dtype, device=z.device) + a_f @ a_f.T
        t_vec = a_f @ r_f
        if self.has_old:
            a_a = trtrs(trtrs(self.kernel.K(z, self.Z_old), L).T, self.L_D).T
            b = b + a_a @ a_a.T
            t_vec = t_vec + a_a @ self.r_a
        LB = _chol(b)
        c = trtrs(t_vec, LB)
        # m_u = L B⁻¹ t = L LB⁻ᵀ c;  S_u = L B⁻¹ Lᵀ = (LB⁻¹Lᵀ)ᵀ(LB⁻¹Lᵀ)
        m_u = L @ trtrs(c, LB.T, lower=False)
        half = trtrs(L.T, LB)
        return m_u, half.T @ half, L

    @torch.no_grad()
    def _absorb(self):
        """Roll the current batch into the summary of the old posterior: the
        first absorb makes the summary's buffers, later ones overwrite them
        in place.  X and Y are left empty."""
        m_u, S_u, _ = self._collapsed_posterior()
        scale = torch.mean(torch.diagonal(S_u))
        S_u = S_u + (1e-10 * scale) * torch.eye(S_u.shape[0], dtype=S_u.dtype, device=S_u.device)
        z_old = self.Z.value.clone()
        v_aa = kuu_with_jitter(self.kernel, z_old, self.jitter)
        new = {"Z_old": z_old, "m_a": m_u, "L_Sa": _chol(S_u), "V_aa": v_aa, "L_Vaa": _chol(v_aa)}
        for name, value in new.items():
            self._store(name, value)
        self.has_old = True
        L_D, r_a = self._compute_d_factors()
        self._store("L_D", L_D)
        self._store("r_a", r_a)
        self.X = self.X.new_zeros((0, self.X.shape[1]))
        self.Y = self.Y.new_zeros((0, self.output_dim))

    def _store(self, name, value):
        if name in self._buffers and self._buffers[name].shape == value.shape:
            self._buffers[name].copy_(value)
        else:
            self.register_buffer(name, value)

    # -- prediction -------------------------------------------------------------

    def _uncertain_wG(self):
        """The serving conditional from the summary (θ as at the last
        absorb): w = V_aa⁻¹ m_a, G = V_aa⁻¹ − V_aa⁻¹ S_a V_aa⁻¹."""
        if not self.has_old:
            raise ValueError("no data absorbed yet: call step() first")
        eye = torch.eye(self.Z_old.shape[0], dtype=self.V_aa.dtype, device=self.V_aa.device)
        linv = trtrs(eye, self.L_Vaa)
        kinv = linv.T @ linv
        t = kinv @ self.L_Sa
        return kinv @ self.m_a, kinv - t @ t.T

    def _predict(self, x_new, diag=True):
        ref = self._input_reference()  # any array-like, cast to Z's dtype as in the JAX package
        x_new = torch.as_tensor(x_new, dtype=ref.dtype, device=ref.device)
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        w, G = self._uncertain_wG()
        ksu = self.kernel.K(x_new, self.Z_old)
        mean = ksu @ w + self.mean_function(x_new)
        if diag:
            var = self.kernel.Kdiag(x_new) - torch.einsum("sk,kl,sl->s", ksu, G, ksu)
            return mean, torch.clamp(var, min=0.0)[:, None].expand(mean.shape)
        return mean, self.kernel.K(x_new) - ksu @ G @ ksu.T

    @_coerce_io
    def predict_uncertain(self, x_mean, x_var):
        """Moment-matched prediction at uncertain inputs from the streamed
        summary (needs a ψ-statistics kernel; see the batch models)."""
        from ..ekernels import uncertain_predict

        w, G = self._uncertain_wG()
        return uncertain_predict(self.kernel, self.mean_function, self.Z_old, w, G, x_mean, x_var)

    def __repr__(self):
        return f"OnlineSGPR(M={self.num_inducing}, has_old={self.has_old})"
