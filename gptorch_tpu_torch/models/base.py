"""GPModel: the base class of the GP models.

Counterpart of ``gptorch_tpu/models/base.py``: data + kernel + likelihood +
mean function on one explicit device, the default-noise heuristic, the loss,
and numpy-in/numpy-out prediction.  Training (``optimize``/``fit_scan``) is
not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import likelihoods as _likelihoods
from .. import mean_functions as _means
from .. import settings
from ..module import Module
from ..util import as_array


def _coerce_io(predict_func):
    """numpy in -> numpy out; tensor in -> tensor out.

    A numpy input is cast to the training inputs' dtype and device and run
    under ``torch.no_grad()``: its numpy output carries no graph anyway."""

    @functools.wraps(predict_func)
    def predict(self, input_new, *args, **kwargs):
        if not isinstance(input_new, np.ndarray):
            return predict_func(self, input_new, *args, **kwargs)
        input_new = as_array(input_new, dtype=self.X.dtype, device=self.X.device)
        with torch.no_grad():
            out = predict_func(self, input_new, *args, **kwargs)
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy() for o in out)
        return out.cpu().numpy()

    return predict


class Predictive(Module):
    """``predict_f`` / ``predict_y`` / ``predict_log_density`` on top of a
    subclass's ``_predict(x_new, diag)`` and ``likelihood``; shared by the
    models and their cached posteriors."""

    def _predict(self, x_new, diag=True):
        raise NotImplementedError

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
        self.mean_function = (
            _means.as_mean_function(mean_function) if mean_function is not None else _means.Zero(y.shape[1])
        )
        self.register_buffer("X", x)
        self.register_buffer("Y", y)
        self.name = name
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.X.device

    @staticmethod
    def _init_gaussian_likelihood(y):
        """Default-noise heuristic: σ² = 0.001·var(y), the population
        variance (numpy's ddof=0, not torch's unbiased default)."""
        return _likelihoods.Gaussian(variance=float(0.001 * y.detach().cpu().numpy().var()))

    def log_likelihood(self, x=None, y=None):
        raise NotImplementedError

    def _loss(self, x=None, y=None):
        """-(log_likelihood + log_prior)."""
        return -(self.log_likelihood(x=x, y=y) + self.log_prior())

    def loss(self, x=None, y=None):
        """Public loss: X and Y must agree on the number of data, and a
        non-finite loss raises ``FloatingPointError``."""
        if x is not None or y is not None:
            xs = x if x is not None else self.X
            ys = y if y is not None else self.Y
            if xs.shape[0] != ys.shape[0]:
                raise ValueError("X and Y must have same # data.")
        out = self._loss(x=x, y=y)
        if not bool(torch.isfinite(out)):
            raise FloatingPointError(
                "Loss is non-finite: the noise variance may sit below the "
                "factorization's floor; raise it or the jitter."
            )
        return out
