"""Heteroscedastic GP regression: input-dependent noise via a second
latent GP.

Counterpart of ``gptorch_tpu/models/heteroscedastic.py``:

    y(x) = f(x) + ε(x),   ε(x) ~ N(0, exp(g(x)))
    f ~ GP(0, k_f),       g ~ GP(μ₀, k_g)

with sparse-variational inference over both latents (shared inducing
inputs Z, independent Gaussians q(u_f), q(u_g)): SVGP's single-latent
identities (:func:`~gptorch_tpu_torch.models.sparse_gpr.latent_marginals`)
once per latent.  With marginals q(f_i) = N(μ_fi, s_fi), q(g_i) =
N(μ_gi, s_gi) and E[e^{-g}] = e^{-μ_g + s_g/2}, the expected
log-likelihood is closed form,

    E[log N(y | f, e^g)] = -½log 2π - ½μ_g - ½ e^{-μ_g + s_g/2} ((y - μ_f)² + s_f),

so the ELBO minibatches like SVGP's.  Predictions: E[y*] = μ_f,
Var[y*] = s_f + e^{μ_g + s_g/2}; the held-out log density integrates g
out by 1-D Gauss-Hermite over log N(y; μ_f, s_f + e^g).

On the card, Kuu and Kuf of each latent with an
:class:`~gptorch_tpu_torch.kernels.Rbf` kernel are launches of the Gram
kernel (``csrc/rbf_gram.cu``).
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import numpy as np
import torch

from .. import sampling as _sampling
from .. import settings
from ..bijectors import LowerCholesky
from ..functions import cholesky
from ..likelihoods import Gaussian
from ..param import Param
from ..util import as_array
from .base import GPModel, _coerce_io
from .sparse_gpr import draw_minibatch, init_inducing_points, kuu_with_jitter, latent_marginals

#: Soft overflow guard for the ELBO's e^{-μ_g + s_g/2} factor: beyond t = 30
#: the exponential is continued linearly, e³⁰·(1 + t − 30), which keeps the
#: value finite in float32 and the gradient pushing t back down (the JAX
#: package's cap).  Exact wherever t ≤ 30.
_EXP_LIN_CAP = 30.0


def _exp_lin(t):
    """e^t for t ≤ 30, e³⁰·(1 + t − 30) above; at t = 30 the gradient is
    ½e³⁰, as ``jnp.minimum`` gives it in the JAX package (torch.minimum
    splits a tie's gradient the same way)."""
    capped = torch.minimum(t, torch.full_like(t, _EXP_LIN_CAP))
    return torch.where(
        t > _EXP_LIN_CAP,
        math.exp(_EXP_LIN_CAP) * (1.0 + (t - _EXP_LIN_CAP)),
        torch.exp(capped),
    )


class HeteroscedasticSVGP(GPModel):
    """Sparse-variational GP with input-dependent (log-GP) noise.

    :param x: (n, d) inputs.  :param y: (n, 1) outputs (single output).
    :param kernel: kernel of the mean latent f.
    :param noise_kernel: kernel of the log-noise latent g (default: a copy
        of ``kernel``).
    :param noise_mean_init: initial constant mean μ₀ of g (a log variance);
        default log(0.1·var(y)).
    :param device: see :class:`~gptorch_tpu_torch.models.base.GPModel`.

    ``log_likelihood`` draws its minibatch (``batch_size``) from an explicit
    ``generator``, as SVGP does.
    """

    def __init__(
        self,
        x,
        y,
        kernel,
        noise_kernel=None,
        num_inducing_points: Optional[int] = None,
        inducing_points=None,
        batch_size: Optional[int] = None,
        jitter: float = 1e-6,
        noise_mean_init: Optional[float] = None,
        name: str = "hetsvgp",
        device=None,
    ):
        if noise_kernel is None:
            noise_kernel = copy.deepcopy(kernel)
        # the observation model is the second latent: a Gaussian frozen at 0
        # fills the likelihood slot so that nothing adds its noise
        placeholder = Gaussian(variance=1.0)
        placeholder.variance = Param(torch.zeros(()), trainable=False)
        super().__init__(x, y, kernel, placeholder, None, name, device=device)
        if self.output_dimension != 1:
            raise ValueError("HeteroscedasticSVGP supports a single output")
        self.noise_kernel = noise_kernel.to(self.device)
        self.jitter = float(jitter)
        self.batch_size = batch_size

        host_x = self.X.cpu().numpy() if inducing_points is None else None
        z = init_inducing_points(host_x, num_inducing_points, inducing_points)
        self.Z = Param(as_array(z if isinstance(z, torch.Tensor) else np.asarray(z), device=self.device))
        m = self.Z.shape[0]

        if noise_mean_init is None:
            noise_mean_init = float(np.log(0.1 * self.Y.detach().cpu().numpy().var() + 1e-12))
        self.noise_mean = Param(as_array(noise_mean_init, device=self.device))

        # q(u_f), q(u_g) start prior-matched (m = 0, S = Kuu), so KL = 0
        self.qf_mu = Param(torch.zeros((m, 1), dtype=self.Z.dtype, device=self.device))
        self.qg_mu = Param(torch.zeros((m, 1), dtype=self.Z.dtype, device=self.device))
        with torch.no_grad():
            z = self.Z.value
            self.qf_chol = Param(cholesky(self._kuu(z, self.kernel), blocked=False), transform=LowerCholesky())
            self.qg_chol = Param(cholesky(self._kuu(z, self.noise_kernel), blocked=False), transform=LowerCholesky())
        # the two Gaussian variational distributions, for training.natgrad
        self.variational_groups = (("qf_mu", "qf_chol"), ("qg_mu", "qg_chol"))

    @property
    def num_inducing(self) -> int:
        return self.Z.shape[0]

    def _kuu(self, z, k):
        return kuu_with_jitter(k, z, self.jitter)

    def _latent(self, x_new, k, q_mu, q_chol, diag=True):
        """SVGP moments and KL of one latent."""
        return latent_marginals(k, self.Z.value, q_mu.value, q_chol.value, x_new, self.jitter, diag=diag)

    def _latent_f(self, x_new, diag=True):
        return self._latent(x_new, self.kernel, self.qf_mu, self.qf_chol, diag)

    def _latent_g(self, x_new, diag=True):
        mu, s, kl = self._latent(x_new, self.noise_kernel, self.qg_mu, self.qg_chol, diag)
        return mu + self.noise_mean.value.reshape(()), s, kl

    def _moments(self, x_new):
        mu_f, s_f, kl_f = self._latent_f(x_new)
        mu_g, s_g, kl_g = self._latent_g(x_new)
        return mu_f, s_f, mu_g, s_g, kl_f + kl_g

    def log_likelihood(self, x=None, y=None, generator=None):
        """The closed-form heteroscedastic ELBO on (x, y), scaled to the full
        data.  Without ``x`` and with ``batch_size`` set, a batch is drawn
        without replacement from ``generator`` (default: a fresh one from
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

        mu_f, s_f, mu_g, s_g, kl = self._moments(x)
        resid2 = torch.square(y[:, 0] - mu_f) + s_f
        ell = -0.5 * (math.log(2.0 * math.pi) + mu_g + _exp_lin(-mu_g + 0.5 * s_g) * resid2)
        return torch.sum(ell) * (self.num_data / x.shape[0]) - kl

    def _predict(self, x_new, diag=True):
        """Moments of the latent f: (n*, 1) mean and variance, or the full
        (n*, n*) covariance; g is not evaluated."""
        mu_f, s_f, _ = self._latent_f(x_new, diag=diag)
        return mu_f[:, None], s_f[:, None] if diag else s_f

    @_coerce_io
    def predict_noise(self, x_new):
        """Moments of the log-noise latent g at x_new: (mean, var), each
        (n*,); exp(mean + var/2) is the expected noise variance."""
        mu_g, s_g, _ = self._latent_g(x_new)
        return mu_g, s_g

    def _sample(self, input_new, n_samples, generator, observed):
        """Joint draws: f and g with their full latent covariances (f's
        normals drawn first, then g's, then ε); observed draws are
        y = f + e^{g/2}·ε.  The placeholder likelihood adds nothing."""
        if generator is None:
            generator = settings.next_default_generator(self.device)
        mu_f, Cf, _ = self._latent_f(input_new, diag=False)
        n = mu_f.shape[0]
        f = mu_f[None, :] + (cholesky(Cf) @ _sampling.standard_normal(generator, (n_samples, n, 1), mu_f))[..., 0]
        if not observed:
            return f[:, :, None]
        mu_g, Cg, _ = self._latent_g(input_new, diag=False)
        g = mu_g[None, :] + (cholesky(Cg) @ _sampling.standard_normal(generator, (n_samples, n, 1), mu_f))[..., 0]
        eps = _sampling.standard_normal(generator, (n_samples, n), mu_f)
        return (f + torch.exp(0.5 * g) * eps)[:, :, None]

    @_coerce_io
    def predict_y(self, input_new, diag=True):
        """E[y*] = μ_f, Var[y*] = s_f + e^{μ_g + s_g/2}; ``diag=False``:
        the full latent covariance of f plus diag(e^{μ_g + s_g/2}) (the
        noise is independent across points given g)."""
        if not diag:
            mu_f, S_f, _ = self._latent_f(input_new, diag=False)
            mu_g, s_g, _ = self._latent_g(input_new)
            return mu_f[:, None], S_f + torch.diag(torch.exp(mu_g + 0.5 * s_g))
        mu_f, s_f, mu_g, s_g, _ = self._moments(input_new)
        return mu_f[:, None], (s_f + torch.exp(mu_g + 0.5 * s_g))[:, None]

    @_coerce_io
    def predict_log_density(self, input_new, y_new, order: int = 32):
        """log p(y*) = log ∫ N(y*; μ_f, s_f + e^g) N(g; μ_g, s_g) dg by 1-D
        Gauss-Hermite over g (f integrated in closed form); (n*, 1)."""
        from ..quadrature import gauss_hermite_log

        mu_f, s_f, mu_g, s_g, _ = self._moments(input_new)
        y_new = torch.as_tensor(y_new, dtype=mu_f.dtype, device=mu_f.device).reshape(-1)

        def log_norm(g):
            v = s_f[None, :] + torch.exp(g)
            return -0.5 * (math.log(2.0 * math.pi) + torch.log(v) + torch.square(y_new[None, :] - mu_f[None, :]) / v)

        return gauss_hermite_log(log_norm, mu_g, s_g, order)[:, None]
