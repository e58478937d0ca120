"""Exact GP regression on 1-D inputs in O(n): the state-space model.

Counterpart of ``gptorch_tpu/models/statespace.py``.  ``StateSpaceGPR``
computes the same marginal likelihood and posterior as
:class:`~gptorch_tpu_torch.models.GPR` for Matérn-family kernels on 1-D
inputs, through the kernels' exact SDE form: Kalman filtering and RTS
smoothing over a latent state of s ≤ 3 entries a term, as parallel prefix
scans of log depth (:mod:`gptorch_tpu_torch.ops.ssm`).  n = 10⁶ points is a
few MB of state, not an n² Gram.

Eligibility, checked at construction: 1-D inputs; ``Exp``/``Matern12``,
``Matern32``, ``Matern52`` or ``Sum``s of those; a Gaussian likelihood; any
mean function (the residual is filtered).

The data are stored sorted by x (stable sort on the host); losses and
predictions do not depend on the order.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import likelihoods as _likelihoods
from .. import sampling as _sampling
from .. import settings
from ..ops import ssm as _ssm
from ..util import as_array
from .base import GPModel


class StateSpaceGPR(GPModel):
    """Exact 1-D GP regression by parallel Kalman scans (O(n), exact)."""

    def __init__(self, x, y, kernel, likelihood=None, mean_function=None, name: str = "ssgp", device=None):
        super().__init__(x, y, kernel, likelihood, mean_function, name=name, device=device)
        if self.X.shape[1] != 1:
            raise ValueError(
                "StateSpaceGPR requires 1-D inputs; got "
                f"d={self.X.shape[1]}.  Use GPR (dense) or "
                "GPR(solver='iterative') for d > 1."
            )
        if not isinstance(self.likelihood, _likelihoods.Gaussian):
            raise ValueError(
                "StateSpaceGPR requires a Gaussian likelihood (exact "
                "conjugate filter updates); got "
                f"{type(self.likelihood).__name__}."
            )
        # fail fast on unsupported kernels (ValueError with the supported list)
        with torch.no_grad():
            _ssm._sde_from_kernel(self.kernel, self.X.dtype)
        order = np.argsort(self.X[:, 0].detach().cpu().numpy(), kind="stable")
        order = torch.as_tensor(order, device=self.device)
        self.X = self.X[order]
        self.Y = self.Y[order]

    def _reads_jitter_policy(self) -> bool:
        return False  # no Cholesky: closed-form small inverses only

    @property
    def _scan_chunk(self):
        """Chunk of the three-phase scan for very long series: 65536 above
        n = 131072, else None (one scan); ``GPTORCH_TPU_SSM_CHUNK``
        overrides it (0 = never chunk)."""
        env = os.environ.get("GPTORCH_TPU_SSM_CHUNK")
        if env is not None:
            c = int(env)
            return c if c > 0 else None
        return 65536 if self.X.shape[0] > 131072 else None

    def _noise(self):
        return self.likelihood.variance.value.reshape(())

    def log_likelihood(self, x=None, y=None, generator=None):
        """Exact log p(Y | X, θ), equal to the dense GPR's.  Minibatch
        overrides are rejected: the recursion is exact only over the full
        ordered series."""
        if x is not None or y is not None:
            raise ValueError(
                "StateSpaceGPR computes the exact full-data likelihood; "
                "minibatch loss is not defined for it (use SVGP for "
                "stochastic training)."
            )
        resid = self.Y - self.mean_function(self.X)
        return -_ssm.ssm_nlml(self.kernel, self._noise(), self.X[:, 0], resid, chunk=self._scan_chunk)

    def _augmented(self, x_new):
        """The training data with the queries interleaved as masked steps,
        sorted on the device (stable), and the permutation that undoes the
        sort."""
        n, m = self.X.shape[0], x_new.shape[0]
        resid = self.Y - self.mean_function(self.X)
        xa = torch.cat([self.X[:, 0], x_new[:, 0]])
        ya = torch.cat([resid, resid.new_zeros((m, resid.shape[1]))])
        mask = torch.cat([torch.ones(n, dtype=torch.bool, device=self.device),
                          torch.zeros(m, dtype=torch.bool, device=self.device)])
        order = torch.argsort(xa, stable=True)
        return xa[order], ya[order], mask[order], torch.argsort(order, stable=True)

    def _as_queries(self, x_new):
        x_new = as_array(x_new, dtype=self.X.dtype, device=self.device)
        return x_new[:, None] if x_new.ndim == 1 else x_new

    def _predict(self, x_new, diag=True):
        if not diag:
            raise NotImplementedError(
                "StateSpaceGPR predicts marginal (diag) moments; the "
                "full n*×n* posterior covariance requires the smoother's "
                "cross-covariances (use GPR if you need joint draws)."
            )
        x_new = self._as_queries(x_new)
        n = self.X.shape[0]
        xs, ys, mask, inv = self._augmented(x_new)
        mean_s, var_s = _ssm.ssm_posterior(self.kernel, self._noise(), xs, ys, mask)
        mean = mean_s[inv][n:] + self.mean_function(x_new)
        var = var_s[inv][n:]
        return mean, var[:, None].expand(mean.shape)

    def _sample(self, input_new, n_samples, generator, observed):
        """Joint posterior draws by the simulation smoother
        (:func:`~gptorch_tpu_torch.ops.ssm.ssm_sample_posterior`): the exact
        joint covariance in O(n) work.  The prior states' normals, the
        observation noise's and (``observed``) the added y-noise's are three
        separate draws from ``generator``: reusing the prior's stream for
        the added noise would anticorrelate it with the posterior residual."""
        if generator is None:
            generator = settings.next_default_generator(self.device)
        input_new = self._as_queries(input_new)
        n = self.X.shape[0]
        xs, ys, mask, inv = self._augmented(input_new)
        samples = _ssm.ssm_sample_posterior(self.kernel, self._noise(), xs, ys, mask, generator, n_samples)
        samples = samples[:, inv][:, n:] + self.mean_function(input_new)[None]
        if observed:
            samples = samples + torch.sqrt(self._noise()) * _sampling.standard_normal(
                generator, samples.shape, samples
            )
        return samples

    def filter_moments(self):
        """Causal (filtered, not smoothed) latent moments at the training
        inputs, E[f(x_k) | y_1..k]: (mean (n, dy), var (n,))."""
        resid = self.Y - self.mean_function(self.X)
        A, Q, H, _ = _ssm.assemble_sde(self.kernel, self.X[:, 0])
        means, covs = _ssm.parallel_filter(A, Q, H, self._noise(), resid)
        f_mean = torch.matmul(H[None], means)[:, 0, :] + self.mean_function(self.X)
        f_var = torch.matmul(H[None], torch.matmul(covs, H.T[None]))[:, 0, 0]
        return f_mean, f_var
