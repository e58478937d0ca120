"""StreamingVFE: exact sparse-GP regression over a data stream.

Counterpart of ``gptorch_tpu/models/streaming.py``.  For fixed inducing
points and hyperparameters, the Titsias (2009) collapsed bound and its
optimal q(u) depend on the data only through O(m²) statistics that add
over data points:

    Φ̃ = Σ_b A_b A_bᵀ,  A_b = L⁻¹ K(Z, X_b),  L = chol(Kuu)   (m, m)
    r̃ = Σ_b A_b (y_b − m(X_b))                                (m, p)
    yy = Σ_b ‖y_b − m(X_b)‖²,  t = Σ_b Σ Kdiag(X_b),  n = Σ_b n_b

so a stream of batches is absorbed one at a time in O(n_b·m²) work and
O(m²) state, and the result is exactly the batch VFE posterior and bound
over everything seen.  The statistics are accumulated whitened (through
L), so B = I + βΦ̃ stays factorizable in float32.

The JAX package's ``update``/``downdate`` return a new model through its
pytree ``replace``; here they return a new :class:`StreamingVFE` that
shares the kernel, likelihood, mean function and Z and holds new
statistic tensors, leaving the old model as it was.  :meth:`observe`
updates in place and returns ``self``.  ``update`` is differentiable, as
the JAX package's is: stream under ``torch.no_grad()`` to keep no autograd
history across batches.  It reads nothing back to the host (under the
``fixed`` or ``none`` jitter policy), so a stream of
equal-sized batches can be captured as one CUDA graph: the counterpart of
``lax.scan`` over the stream.  On the card, Kuu, Kuf and Ksu of an
:class:`~gptorch_tpu_torch.kernels.Rbf` kernel are launches of
``csrc/rbf_gram.cu``.

Scope: a Gaussian likelihood; Z and the hyperparameters fixed while
streaming (the statistics depend on the kernel).
"""

from __future__ import annotations

import copy

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

_STATS = ("phi_w", "r_w", "yy", "kdiag_sum", "n_seen")


class StreamingVFE(Predictive):
    """Sparse GP regression with streaming (additive-statistics) updates.

    :param kernel: kernel (a ψ-statistics ``ekernels`` kernel enables
        :meth:`predict_uncertain`).
    :param inducing_points: (m, d) fixed inducing inputs.
    :param likelihood: Gaussian (default Gaussian(0.1)); its noise is one
        of the fixed hyperparameters.
    :param jitter: relative diagonal floor on Kuu.
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
        name: str = "streaming_vfe",
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
            raise ValueError(
                "StreamingVFE needs a Gaussian likelihood (the additive sufficient statistics exist only for "
                "conjugate noise)"
            )
        self.mean_function = (
            _means.as_mean_function(mean_function) if mean_function is not None else _means.Zero(output_dim)
        )
        self.Z = Param(z, trainable=False)
        self.jitter = float(jitter)
        self.name = name
        m = z.shape[0]
        for stat, shape in zip(_STATS, ((m, m), (m, output_dim), (), (), ())):
            self.register_buffer(stat, torch.zeros(shape, dtype=z.dtype, device=device))
        self.to(device)

    # -- streaming -----------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.Z.raw.device

    @property
    def num_inducing(self) -> int:
        return self.Z.shape[0]

    @property
    def output_dimension(self) -> int:
        return self.r_w.shape[1]

    def _input_reference(self) -> torch.Tensor:
        """Numpy inputs take Z's dtype and device (there is no X)."""
        return self.Z.raw

    def _batch_stats(self, x_b, y_b):
        x_b = as_array(x_b if isinstance(x_b, torch.Tensor) else np.asarray(x_b), dtype=self.Z.dtype,
                       device=self.device)
        y_b = as_array(y_b if isinstance(y_b, torch.Tensor) else np.asarray(y_b), dtype=self.r_w.dtype,
                       device=self.device)
        if x_b.ndim == 1:
            x_b = x_b[:, None]
        if y_b.ndim == 1:
            y_b = y_b[:, None]
        err = y_b - self.mean_function(x_b)
        z = self.Z.value
        L = cholesky(kuu_with_jitter(self.kernel, z, self.jitter), blocked=False)
        a_b = trtrs(self.kernel.K(z, x_b), L)  # L⁻¹ Kuf
        nb = torch.full((), x_b.shape[0], dtype=self.n_seen.dtype, device=self.device)
        return a_b @ a_b.T, a_b @ err, torch.sum(torch.square(err)), torch.sum(self.kernel.Kdiag(x_b)), nb

    def _with_stats(self, stats):
        """A model sharing this one's kernel, likelihood, mean function and Z,
        with the statistic tensors ``stats`` (in ``_STATS`` order)."""
        out = copy.copy(self)
        out._parameters, out._modules, out._buffers = dict(self._parameters), dict(self._modules), dict(self._buffers)
        out._buffers.update(zip(_STATS, stats))
        return out

    def update(self, x_b, y_b) -> "StreamingVFE":
        """Absorb a batch: a new model whose posterior and bound are exactly
        the batch VFE's over all data seen so far; this one is unchanged."""
        batch = self._batch_stats(x_b, y_b)
        return self._with_stats([getattr(self, s) + b for s, b in zip(_STATS, batch)])

    def downdate(self, x_b, y_b) -> "StreamingVFE":
        """Forget a previously absorbed batch (sliding windows): the exact
        inverse of :meth:`update` with the same (x_b, y_b)."""
        batch = self._batch_stats(x_b, y_b)
        return self._with_stats([getattr(self, s) - b for s, b in zip(_STATS, batch)])

    @torch.no_grad()
    def observe(self, x_b, y_b) -> "StreamingVFE":
        """:meth:`update` in place; returns ``self``."""
        for s, b in zip(_STATS, self._batch_stats(x_b, y_b)):
            getattr(self, s).add_(b)
        return self

    # -- bound ------------------------------------------------------------------

    def _factors(self):
        """(L, LB, β) with B = I + βΦ̃ (Φ̃ already whitened)."""
        beta = 1.0 / self.likelihood.variance.value.reshape(())
        L = cholesky(kuu_with_jitter(self.kernel, self.Z.value, self.jitter), blocked=False)
        B = beta * self.phi_w + torch.eye(self.num_inducing, dtype=L.dtype, device=L.device)
        return L, cholesky(B, blocked=False), beta

    def log_likelihood(self):
        """The collapsed VFE bound over everything seen, from the statistics
        alone (batch ``VFE.log_likelihood`` on the concatenated stream):

            log N(y | m(X), Qff + σ²I) − β/2 Σᵢ(kᵢᵢ − qᵢᵢ)

        by Woodbury: (Qff+σ²I)⁻¹ = βI − β² Kfu L⁻ᵀB⁻¹L⁻¹ Kuf and
        log det = n log σ² + log det B."""
        p = self.output_dimension
        _, LB, beta = self._factors()
        c = trtrs(self.r_w, LB)  # LB⁻¹ r̃
        quad = beta * self.yy - beta ** 2 * torch.sum(torch.square(c))
        logdet = p * (self.n_seen * torch.log(2.0 * torch.pi / beta) + 2.0 * torch.sum(torch.log(torch.diagonal(LB))))
        trace = p * beta * (self.kdiag_sum - torch.sum(torch.diagonal(self.phi_w)))
        return -0.5 * (logdet + quad + trace)

    def loss(self):
        return -self.log_likelihood()

    # -- prediction -------------------------------------------------------------

    def _uncertain_wG(self):
        """w = βL⁻ᵀB⁻¹r̃, G = Kuu⁻¹ − L⁻ᵀB⁻¹L⁻¹ (the batch VFE's conditional,
        from the streamed statistics)."""
        L, LB, beta = self._factors()
        linv = trtrs(torch.eye(self.num_inducing, dtype=L.dtype, device=L.device), L)
        lbinv_linv = trtrs(linv, LB)
        w = beta * lbinv_linv.T @ trtrs(self.r_w, LB)
        return w, linv.T @ linv - lbinv_linv.T @ lbinv_linv

    def _predict(self, x_new, diag=True):
        ref = self._input_reference()  # any array-like, cast to Z's dtype as in the JAX package
        x_new = torch.as_tensor(x_new, dtype=ref.dtype, device=ref.device)
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        w, G = self._uncertain_wG()
        ksu = self.kernel.K(x_new, self.Z.value)
        mean = ksu @ w + self.mean_function(x_new)
        if diag:
            var = self.kernel.Kdiag(x_new) - torch.einsum("sk,kl,sl->s", ksu, G, ksu)
            # after many batches the float32 cancellation kxx − kᵀGk rounds
            # slightly negative where the posterior is tightest
            return mean, torch.clamp(var, min=0.0)[:, None].expand(mean.shape)
        return mean, self.kernel.K(x_new) - ksu @ G @ ksu.T

    @_coerce_io
    def predict_uncertain(self, x_mean, x_var):
        """Moment-matched prediction at uncertain inputs x* ~ N(x_mean, x_var)
        (needs a ψ-statistics kernel; see the batch models)."""
        from ..ekernels import uncertain_predict

        w, G = self._uncertain_wG()
        return uncertain_predict(self.kernel, self.mean_function, self.Z.value, w, G, x_mean, x_var)

    def __repr__(self):
        return f"StreamingVFE(m={self.num_inducing}, n_seen={float(self.n_seen):.0f})"
