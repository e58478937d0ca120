"""GPModel: the base class of the GP models.

Counterpart of ``gptorch_tpu/models/base.py``: data + kernel + likelihood +
mean function on one explicit device, the default-noise heuristic, the loss
(at the model's own values or, through ``params=``, at given ones),
training (``optimize``/``fit_scan``, in place) and numpy-in/numpy-out
prediction and sampling.  The JAX package's PRNG ``key`` arguments become
``generator=`` (a ``torch.Generator`` on the model's device), which a
minibatched model draws its batch from, the samplers draw their normals
from, and every other model ignores.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import likelihoods as _likelihoods
from .. import mean_functions as _means
from .. import sampling as _sampling
from .. import settings
from ..functions import cholesky
from ..module import Module, call_with_trainable
from ..training import fit as _fit
from ..util import _coerce_io, as_array


class Predictive(Module):
    """``predict_f`` / ``predict_y`` / ``predict_log_density`` on top of a
    subclass's ``_predict(x_new, diag)`` and ``likelihood``; shared by the
    models and their cached posteriors."""

    def _predict(self, x_new, diag=True):
        raise NotImplementedError

    def _input_reference(self) -> torch.Tensor:
        """A tensor whose dtype and device numpy inputs are cast to."""
        return self.X if hasattr(self, "X") else self.Z

    def _predict_y(self, x_new, diag=True):
        mean_f, cov_f = self._predict(x_new, diag=diag)
        if diag:
            return self.likelihood.predict_mean_variance(mean_f, cov_f)
        return self.likelihood.predict_mean_covariance(mean_f, cov_f)

    @_coerce_io
    def predict_f(self, input_new, diag=True):
        """Latent-function posterior moments at input_new."""
        return self._predict(input_new, diag=diag)

    @_coerce_io
    def predict_y(self, input_new, diag=True):
        """Observation posterior moments (adds the likelihood noise)."""
        return self._predict_y(input_new, diag=diag)

    @_coerce_io
    def predict_log_density(self, input_new, y_new):
        """Pointwise held-out log predictive density at (input_new, y_new),
        shape [n*, dy]."""
        mean_f, var_f = self._predict(input_new, diag=True)
        y_new = torch.as_tensor(y_new, dtype=mean_f.dtype, device=mean_f.device)
        if y_new.ndim == 1:
            y_new = y_new[:, None]
        return self.likelihood.predict_log_density(mean_f, var_f, y_new)


class GPModel(Predictive):
    """Base GP model: data + kernel + likelihood + mean function.

    :param device: where the model lives; ``None`` takes
        ``settings.config.device`` (the card by default).  With no card
        present a CUDA device raises -- pass ``device="cpu"`` to run on the
        CPU.  The kernel, likelihood and mean function are moved there.
    """

    def __init__(self, x, y, kernel, likelihood=None, mean_function=None, name: str = "gp", device=None):
        super().__init__()
        device = settings.resolve_device(device)
        x = as_array(x if isinstance(x, torch.Tensor) else np.asarray(x), device=device)
        y = as_array(y if isinstance(y, torch.Tensor) else np.asarray(y), device=device)
        if x.ndim == 1:
            x = x[:, None]
        if y.ndim == 1:
            y = y[:, None]
        self.kernel = kernel
        self.likelihood = likelihood if likelihood is not None else GPModel._init_gaussian_likelihood(y)
        if isinstance(self.likelihood, _likelihoods.FixedNoiseGaussian) and not self._supports_fixed_noise:
            # every other model reads one scalar σ² and would drop the
            # per-observation part silently
            raise ValueError(
                f"FixedNoiseGaussian is supported by the exact GPR only, not {type(self).__name__}"
            )
        self.mean_function = (
            _means.as_mean_function(mean_function) if mean_function is not None else _means.Zero(y.shape[1])
        )
        self.register_buffer("X", x)
        self.register_buffer("Y", y)
        self.name = name
        self.to(device)

    #: Whether the model reads a :class:`~gptorch_tpu_torch.likelihoods.FixedNoiseGaussian`'s
    #: per-observation noise (the exact GPR does).
    _supports_fixed_noise = False

    @property
    def device(self) -> torch.device:
        return self.X.device

    @property
    def num_data(self) -> int:
        return self.Y.shape[0]

    @property
    def input_dimension(self) -> int:
        return self.X.shape[1]

    @property
    def output_dimension(self) -> int:
        return self.Y.shape[1]

    @staticmethod
    def _init_gaussian_likelihood(y):
        """Default-noise heuristic: σ² = 0.001·var(y), the population
        variance (numpy's ddof=0, not torch's unbiased default)."""
        return _likelihoods.Gaussian(variance=float(0.001 * y.detach().cpu().numpy().var()))

    def log_likelihood(self, x=None, y=None, generator=None):
        raise NotImplementedError

    def _reads_jitter_policy(self) -> bool:
        """Whether the training loss factors through
        :func:`~gptorch_tpu_torch.functions.cholesky` and so reads
        ``settings.config.jitter_policy`` (whose ``adaptive`` probe is a
        host loop that a captured CUDA graph cannot hold)."""
        return True

    def _capturable(self) -> bool:
        """Whether a training step of this model can be captured as a CUDA
        graph whatever the jitter policy (no host read of its own)."""
        return True

    def _loss(self, x=None, y=None, generator=None):
        """-(log_likelihood + log_prior)."""
        return -(self.log_likelihood(x=x, y=y, generator=generator) + self.log_prior())

    def loss(self, x=None, y=None, generator=None, params=None):
        """Public loss: X and Y must agree on the number of data, and a
        non-finite loss raises ``FloatingPointError``.

        :param params: optional dict of raw trainable values keyed by path
            (see :func:`~gptorch_tpu_torch.module.get_trainable`); the loss
            is then evaluated at those values through
            ``torch.func.functional_call``, differentiable in the given
            tensors, and the model does not change.
        """
        if x is not None or y is not None:
            xs = x if x is not None else self.X
            ys = y if y is not None else self.Y
            if xs.shape[0] != ys.shape[0]:
                raise ValueError("X and Y must have same # data.")
        if params is not None:
            out = call_with_trainable(self, params, "_loss", x=x, y=y, generator=generator)
        else:
            out = self._loss(x=x, y=y, generator=generator)
        if not bool(torch.isfinite(out)):
            raise _fit._nonfinite_loss_error()
        return out

    def optimize(
        self,
        method: str = "Adam",
        max_iter: int = 2000,
        verbose: bool = True,
        learning_rate: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        callback=None,
    ):
        """Fit the hyperparameters by minimizing the loss, in place.

        First-order methods (Adam, SGD, RMSprop, Adagrad, Adadelta, Adamax)
        and LBFGS (optax's rule and zoom line search) run
        :func:`~gptorch_tpu_torch.training.fit.fit_torch` and return
        (losses, wall seconds); scipy methods (L-BFGS-B, BFGS, CG, ...) run
        :func:`~gptorch_tpu_torch.training.fit.fit_scipy` and return its
        OptimizeResult.
        """
        if method in _fit.SCIPY_METHODS:
            if verbose:
                print("Scipy.optimize.minimize...")
            _, result = _fit.fit_scipy(self, method=method, max_iter=max_iter, disp=verbose)
            return result
        if verbose:
            print(f"{self.name}: Start optimizing via {method}")
        _, losses, wall = _fit.fit_torch(
            self, method=method, max_iter=max_iter, learning_rate=learning_rate,
            generator=generator, verbose=verbose, callback=callback,
        )
        if verbose:
            print(f"Optimization time taken: {wall} s")
            print(f"Optimization method: {method}")
        return losses, wall

    def fit_scan(
        self,
        method: str = "Adam",
        max_iter: int = 2000,
        learning_rate: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
    ):
        """Train in place with no host read per step (on the card a
        first-order method replays a captured CUDA graph; see
        :func:`~gptorch_tpu_torch.training.fit.fit_scan`); returns the
        losses as a tensor on the model's device."""
        return _fit.fit_scan(
            self, method=method, max_iter=max_iter, learning_rate=learning_rate, generator=generator
        )[1]

    @_coerce_io
    def predict_f_samples(self, input_new, n_samples: int = 1, generator: Optional[torch.Generator] = None):
        """(n_samples, n*, dy) joint draws from the latent posterior at
        ``input_new``; the normals come from ``generator`` (default:
        :func:`~gptorch_tpu_torch.settings.next_default_generator` on the
        model's device)."""
        return self._sample(input_new, n_samples, generator, observed=False)

    @_coerce_io
    def predict_y_samples(self, input_new, n_samples: int = 1, generator: Optional[torch.Generator] = None):
        """(n_samples, n*, dy) joint draws from the observation posterior
        (the latent one plus the likelihood's noise)."""
        return self._sample(input_new, n_samples, generator, observed=True)

    def _sample(self, input_new, n_samples, generator, observed):
        """μ + chol(Σ)·ε with μ, Σ the full posterior moments and ε standard
        normals of shape (n_samples,) + μ.shape."""
        if generator is None:
            generator = settings.next_default_generator(self.device)
        mu, sigma = self._predict(input_new, diag=False)
        if observed:
            mu, sigma = self.likelihood.predict_mean_covariance(mu, sigma)
        chol_s = cholesky(sigma)
        eps = _sampling.standard_normal(generator, (n_samples,) + tuple(mu.shape), mu)
        return mu + chol_s[None, :, :] @ eps
