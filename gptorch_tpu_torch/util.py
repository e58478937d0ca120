"""Utilities: tensor coercion, numpy-in/numpy-out prediction, pairwise
squared distances, k-means centres and PCA.

Counterpart of ``gptorch_tpu/util.py`` (``as_array``, ``squared_distance``,
``kmeans_centers``, ``PCA``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import settings


def as_array(x, dtype=None, device=None) -> torch.Tensor:
    """Convert numpy / scalar / list / tensor input to a tensor in the
    library default float dtype.

    A Python scalar becomes shape ``(1,)``, not ``()`` -- the JAX package's
    rule, which every scalar parameter's shape follows.
    """
    if dtype is None:
        dtype = settings.default_float()
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, dtype=dtype, device=device)
    if isinstance(x, (float, int)):
        return torch.tensor([x], dtype=dtype, device=device)
    if isinstance(x, (list, tuple)):
        return torch.tensor(x, dtype=dtype, device=device)
    raise TypeError(f"Unsupported type {type(x)}")


def _coerce_io(predict_func):
    """numpy in -> numpy out; tensor in -> tensor out.

    Wraps a method of a model or posterior, or a function whose first
    argument is one (the pathwise samplers).  A numpy input is cast to the
    dtype and device of ``self._input_reference()`` (the training inputs; a
    sparse posterior's inducing points) and run under ``torch.no_grad()``:
    its numpy output carries no graph anyway.  Where ``self`` sets
    ``_accepts_array_like`` (the posteriors, whose JAX counterparts pass a
    query through ``jnp.asarray`` and answer with JAX arrays), any other
    array-like (a list) becomes a tensor of that dtype on that device and
    is answered with tensors."""

    @functools.wraps(predict_func)
    def predict(self, input_new, *args, **kwargs):
        if not isinstance(input_new, (np.ndarray, torch.Tensor)) and getattr(self, "_accepts_array_like", False):
            ref = self._input_reference()
            input_new = torch.as_tensor(input_new, dtype=ref.dtype, device=ref.device)
        if not isinstance(input_new, np.ndarray):
            return predict_func(self, input_new, *args, **kwargs)
        ref = self._input_reference()
        input_new = as_array(input_new, dtype=ref.dtype, device=ref.device)
        with torch.no_grad():
            out = predict_func(self, input_new, *args, **kwargs)
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy() for o in out)
        return out.cpu().numpy()

    return predict


def squared_distance(x1, x2=None):
    """Pairwise squared Euclidean distances: out[i, j] = ||x1[i] - x2[j]||².

    Built as ||a||² + ||b||² − 2 a·b, like the JAX package, with its
    gradient-safe clamp ``r2 - (r2.clamp(max=0)).detach()``: it zeroes the
    small negatives that cancellation leaves without changing first or
    second derivatives (the subtracted term is a constant).

    In the one-argument (self) case the diagonal is set to exactly 0: the
    identity leaves ±O(eps·||x||²) there, which kernels with a √r² kink
    (Exp/Matern12) would amplify to √eps.
    """
    x1s = torch.sum(x1 * x1, dim=-1, keepdim=True)
    if x2 is None:
        r2 = x1s + x1s.transpose(-1, -2) - 2.0 * (x1 @ x1.transpose(-1, -2))
        r2.diagonal(dim1=-2, dim2=-1).zero_()
    else:
        x2s = torch.sum(x2 * x2, dim=-1, keepdim=True)
        r2 = x1s + x2s.transpose(-1, -2) - 2.0 * (x1 @ x2.transpose(-1, -2))
    return r2 - r2.clamp(max=0.0).detach()


def kmeans_centers(x: np.ndarray, k: int, perturb_if_fail: bool = False, seed: int = 0) -> np.ndarray:
    """K-means cluster centres for inducing-point initialization, on the host.

    The JAX package's algorithm and seeding: scipy's ``kmeans2`` with
    k-means++ initialization (``minit="++"``: the default random init can
    leave clusters empty, giving duplicated centres and a singular Kuu) and
    a ``np.random.RandomState(seed)``, so both packages give the same
    centres.  On a ``LinAlgError`` it retries once with inputs perturbed by
    1e-4 of each column's standard deviation when ``perturb_if_fail``.
    """
    from scipy.cluster.vq import kmeans2

    x = np.asarray(x)
    rng = np.random.RandomState(seed)
    try:
        centers = kmeans2(x, k, minit="++", seed=rng)[0]
    except np.linalg.LinAlgError:
        if not perturb_if_fail:
            raise
        x_scale = x.std(axis=0)
        x_perturbed = x + 1.0e-4 * x_scale * rng.randn(*x.shape)
        centers = kmeans2(x_perturbed, k, minit="++", seed=rng)[0]
    return centers


def PCA(X: np.ndarray, q: int) -> np.ndarray:
    """Project X (n, p) onto its top-q principal directions (the GPLVM's
    latent initialization), on the host in numpy."""
    X = np.asarray(X)
    if q > X.shape[1]:
        raise ValueError("Cannot have more latent dimensions than observed")
    evals, evecs = np.linalg.eigh(np.cov(X.T))
    W = evecs[:, np.argsort(evals)[::-1][:q]]
    return (X - X.mean(0)).dot(W)
