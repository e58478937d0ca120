"""Active learning and experimental design over cached posteriors.

Counterpart of ``gptorch_tpu/design.py``: where should the next
(expensive) measurements go to reduce the model's uncertainty (sensor
placement, surrogate refinement, adaptive sampling)?  Everything works on
a cached :class:`~gptorch_tpu_torch.models.posterior.GPRPosterior`, and
the greedy batch selector uses a Gaussian fact: the posterior variance
after observing a point does not depend on the observed value, so a
sequential design is exact through ``condition_on`` with fantasy means.

Criteria (closed form, batched over candidates; tensors in the
posterior's dtype, on its device):

* ``variance``: Var[f(x)] -- uncertainty sampling.
* ``entropy``: ½log(2πe(Var[f(x)] + σ²)).
* ``alc`` (Active Learning Cohn, integrated variance reduction): the
  expected decrease of Σ_r Var[f(x_r)] over a reference set when x is
  observed,

      ALC(x) = Σ_r Cov[f(x_r), f(x)]² / (Var[f(x)] + σ²).

On the card an Rbf posterior's cross Grams K(X, x_cand), K(X, x_ref) and
K(x_ref, x_cand) are launches of the Gram kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .functions import trtrs
from .util import as_array

__all__ = [
    "variance_acquisition",
    "entropy_acquisition",
    "alc_acquisition",
    "suggest_batch",
]


def _inputs(post, x):
    """``x`` as a tensor of the posterior's input dtype, on its device."""
    return as_array(x if isinstance(x, torch.Tensor) else np.asarray(x), dtype=post.X.dtype, device=post.X.device)


def variance_acquisition(post, x_cand):
    """(n_cand,) posterior variance of f at each candidate."""
    _, var = post.predict_f(_inputs(post, x_cand), diag=True)
    return var[:, 0]


def entropy_acquisition(post, x_cand):
    """(n_cand,) predictive-observation entropy ½log(2πe(var_f + σ²))."""
    var = variance_acquisition(post, x_cand)
    sigma2 = post.likelihood.variance.value.reshape(())
    return 0.5 * torch.log(2.0 * math.pi * math.e * (var + sigma2))


def alc_acquisition(post, x_cand, x_ref):
    """(n_cand,) integrated variance reduction over ``x_ref`` for each
    candidate (Cohn 1996), from the cached factor:
    Cov[f_r, f_x] = k(r, x) − A_rᵀA_x with A = L⁻¹K(X, ·) -- one cross Gram
    and one triangular solve per set, one product for every
    candidate-reference covariance."""
    x_cand, x_ref = _inputs(post, x_cand), _inputs(post, x_ref)
    a_c = trtrs(post.kernel.K(post.X, x_cand), post.L)  # (n, c)
    a_r = trtrs(post.kernel.K(post.X, x_ref), post.L)  # (n, r)
    cov_rc = post.kernel.K(x_ref, x_cand) - a_r.T @ a_c  # (r, c)
    var_c = post.kernel.Kdiag(x_cand) - torch.sum(torch.square(a_c), dim=0)
    sigma2 = post.likelihood.variance.value.reshape(())
    return torch.sum(torch.square(cov_rc), dim=0) / (var_c + sigma2)


ACQUISITIONS = {
    "variance": variance_acquisition,
    "entropy": entropy_acquisition,
    "alc": alc_acquisition,
}


def suggest_batch(post, x_cand, q=1, strategy="alc", x_ref=None):
    """Greedily pick ``q`` candidate rows that most reduce uncertainty.

    Exact sequential design at fixed hyperparameters: after each pick the
    posterior is ``condition_on``-ed with the fantasy mean (the
    variance-reduction objective does not depend on y), so later picks see
    the earlier ones' effect.  One host read per pick (the argmax).

    :param post: a :class:`GPRPosterior` (``model.posterior()``).
    :param x_cand: (n_cand, d) candidate inputs.
    :param strategy: "variance", "entropy", or "alc" (needs ``x_ref``,
        default: the candidates themselves).
    :return: (indices (q,) into x_cand as numpy, the conditioned posterior).
    """
    if strategy not in ACQUISITIONS:
        raise ValueError(f"unknown strategy {strategy!r}; pick from {sorted(ACQUISITIONS)}")
    x_cand = _inputs(post, x_cand)
    if strategy == "alc":
        x_ref = x_cand if x_ref is None else _inputs(post, x_ref)

    chosen: list[int] = []
    with torch.no_grad():
        for _ in range(int(q)):
            if strategy == "alc":
                scores = alc_acquisition(post, x_cand, x_ref)
            else:
                scores = ACQUISITIONS[strategy](post, x_cand)
            if chosen:
                scores[torch.as_tensor(chosen, device=scores.device)] = -math.inf
            idx = int(torch.argmax(scores))
            chosen.append(idx)
            # condition on the fantasy mean: the variances do not depend on it
            xq = x_cand[idx : idx + 1]
            mu, _ = post.predict_f(xq, diag=True)
            post = post.condition_on(xq, mu[:, : post.V.shape[1]])
    return np.asarray(chosen), post
