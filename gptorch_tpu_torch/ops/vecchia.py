"""Batched Vecchia-approximation kernels.

Counterpart of ``gptorch_tpu/ops/vecchia.py``.  The Vecchia approximation
factors the (noisy) marginal likelihood by the chain rule and truncates each
conditioning set to the m nearest previous points under some ordering:

    log p(y) = Σᵢ log N(yᵢ | E[yᵢ | y_{c(i)}], Var[yᵢ | y_{c(i)}]),
    c(i) ⊆ {1..i−1}, |c(i)| ≤ m

(Vecchia 1988; Katzfuss & Guinness 2021).  With c(i) = {1..i−1} (full
history) the truncation is exact: the dense GPR NLML by the chain rule.

Every conditional is an independent (m, m) solve, so one chunk of rows is
a gather of its neighbours, their (c, m, m) Gram, one batched
``torch.linalg.cholesky_ex`` and batched triangular solves; chunks are a
Python loop over rows (c ≤ ``chunk``), which bounds memory at (chunk, m, m)
per temporary.  The neighbour Grams (:func:`batched_gram`) are one
batched launch of the Gram kernel for an
:class:`~gptorch_tpu_torch.kernels.Rbf`, whose ``K`` takes the chunk's
batch axis; any other kernel's ``K`` is mapped over the chunk with
``torch.func.vmap``, as the JAX package maps every kernel's.  The
ordering and the neighbour search run once on the host in numpy and
``scipy.spatial.cKDTree`` (copies of the JAX package's functions).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels as _k
from ..functions import _chol_raw


def batched_gram(kernel, a, b=None):
    """``kernel.K`` over a leading batch dimension: (c, m, d) [, (c, m2, d)]
    -> (c, m, m2).  An Rbf's ``K`` takes the batch itself (one batched
    launch of its Gram kernel on the card); every other kernel's is mapped
    by ``torch.func.vmap``.  For an Rbf the map's own cost on the host, per
    call, outweighs the launch it makes (``chip_smoke.py``'s vecchia
    yardstick times both routes on the card; PERF.md)."""
    if isinstance(kernel, _k.Rbf):
        return kernel.K(a, b)
    if b is None:
        return torch.func.vmap(kernel.K)(a)
    return torch.func.vmap(kernel.K)(a, b)


def masked_system(kernel, noise, xnn, mask, x_i):
    """The conditionals' systems for one chunk: (Knn + noise·I with masked
    slots as identity rows and columns (c, m, m), k masked (c, m), kxx
    (c,)).  A masked slot's zero k and r make the solves return zeros
    there."""
    m = xnn.shape[1]
    knn = batched_gram(kernel, xnn)  # (c, m, m)
    k_i = batched_gram(kernel, xnn, x_i[:, None, :])[..., 0]  # (c, m)
    kxx = kernel.Kdiag(x_i)  # (c,)
    mask2 = mask[:, :, None] * mask[:, None, :]
    eye = torch.eye(m, dtype=xnn.dtype, device=xnn.device)
    knn = mask2 * (knn + noise * eye) + (1.0 - mask2) * eye
    return knn, mask * k_i, kxx


def conditional_solves(L, k_i, rnn, kxx, noise):
    """(mu (c, p), var (c,)) from L = chol(Knn) (c, m, m): a = L⁻¹k,
    b = L⁻¹r, mu = aᵀb, var = kxx + noise − ‖a‖², floored at noise·1e-6
    (float32's cancellation floor: the true variance is ≥ noise)."""
    a = torch.linalg.solve_triangular(L, k_i[..., None], upper=False)[..., 0]  # (c, m)
    b = torch.linalg.solve_triangular(L, rnn, upper=False)  # (c, m, p)
    mu = (a[:, None, :] @ b)[:, 0, :]
    var = kxx + noise - torch.sum(torch.square(a), dim=1)
    return mu, torch.maximum(var, noise * 1e-6)


def _conditional_moments(kernel, noise, xnn, rnn, mask, x_i):
    """Batched noisy-GP conditionals for one chunk.

    :param xnn: (c, m, d) neighbour inputs.  :param rnn: (c, m, p)
        neighbour residuals.  :param mask: (c, m) 1 = real neighbour.
    :param x_i: (c, d) target inputs.
    :return: (mu (c, p), var (c,)) -- moments of the noisy y conditional.
    """
    knn, k_i, kxx = masked_system(kernel, noise, xnn, mask, x_i)
    L = _chol_raw(knn, blocked=False)  # batched; NaN where a factor failed
    return conditional_solves(L, k_i, mask[:, :, None] * rnn, kxx, noise)


def vecchia_nlml_rows(kernel, noise, x, resid, nn_idx, nn_mask, rows, chunk: int = 4096):
    """Vecchia log-likelihood of a subset of conditionals.

    :param x: (n, d) full inputs in Vecchia order (gather source).
    :param resid: (n, p) full residuals.
    :param nn_idx: (r, m) int64 neighbour row indices for these rows.
    :param nn_mask: (r, m) float mask, 1 = real neighbour.
    :param rows: (r,) int64 target row indices into x/resid.
    :param chunk: conditionals per step of the loop.
    :return: scalar Σ over these rows of log N(residᵢ | conditional).
    """
    r = rows.shape[0]
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device).reshape(())
    chunk = int(min(chunk, r))
    total = None
    for lo in range(0, r, chunk):
        tgt, idx, msk = rows[lo : lo + chunk], nn_idx[lo : lo + chunk], nn_mask[lo : lo + chunk]
        ri = resid[tgt]
        mu, var = _conditional_moments(kernel, noise, x[idx], resid[idx], msk, x[tgt])
        lp = -0.5 * (torch.log(2.0 * torch.pi * var)[:, None] + torch.square(ri - mu) / var[:, None])
        part = torch.sum(lp)
        total = part if total is None else total + part
    return total


def vecchia_nlml(kernel, noise, x, resid, nn_idx, nn_mask, chunk: int = 4096):
    """Vecchia log-likelihood of the residuals (y − mean), chunk-batched.

    :param x: (n, d) inputs in Vecchia order.
    :param resid: (n, p) residuals in the same order.
    :param nn_idx: (n, m) int64 neighbour row indices (< i for row i;
        arbitrary where masked).
    :param nn_mask: (n, m) float mask, 1 = real neighbour.
    :param chunk: rows per step ((chunk, m, m) live memory per temporary).
    :return: scalar Σᵢ log N(residᵢ | conditional) (log-likelihood).
    """
    rows = torch.arange(resid.shape[0], device=x.device)
    return vecchia_nlml_rows(kernel, noise, x, resid, nn_idx, nn_mask, rows, chunk=chunk)


def vecchia_predict(kernel, noise, x, resid, nn_idx, x_new, chunk: int = 4096):
    """Batched conditional prediction at x_new from its m nearest training
    points (indices found on the host).

    :return: (mean (n*, p) of f (add the mean function outside), var (n*,)
        of f, without observation noise).
    """
    noise = torch.as_tensor(noise, dtype=x.dtype, device=x.device).reshape(())
    chunk = int(min(chunk, x_new.shape[0]))
    mus, variances = [], []
    for lo in range(0, x_new.shape[0], chunk):
        xi, idx = x_new[lo : lo + chunk], nn_idx[lo : lo + chunk]
        mask = torch.ones(idx.shape, dtype=x.dtype, device=x.device)
        mu, var_y = _conditional_moments(kernel, noise, x[idx], resid[idx], mask, xi)
        mus.append(mu)
        variances.append(var_y - noise)  # back out the observation noise
    return torch.cat(mus), torch.cat(variances)


# -- host-side ordering and neighbour search (data-dependent index
#    computations, done once at model construction) --------------------------


def maxmin_ordering(x: np.ndarray) -> np.ndarray:
    """Max-min ordering: start from the point closest to the centroid, then
    repeatedly append the point whose minimum distance to the chosen set is
    largest.  O(n²) time, O(n) memory."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    center = x.mean(axis=0)
    first = int(np.argmin(((x - center) ** 2).sum(axis=1)))
    mind = ((x - x[first]) ** 2).sum(axis=1)
    order = np.empty(n, dtype=np.int64)
    order[0] = first
    mind[first] = -np.inf
    for i in range(1, n):
        nxt = int(np.argmax(mind))
        order[i] = nxt
        d = ((x - x[nxt]) ** 2).sum(axis=1)
        np.minimum(mind, d, out=mind)
        mind[nxt] = -np.inf
    return order


def coordinate_ordering(x: np.ndarray) -> np.ndarray:
    """Sort along the first principal component (power iteration): O(n log n),
    the large-n ordering."""
    x = np.asarray(x, dtype=np.float64)
    xc = x - x.mean(axis=0)
    v = np.ones(x.shape[1]) / np.sqrt(x.shape[1])
    for _ in range(20):
        v = xc.T @ (xc @ v)
        v /= np.linalg.norm(v) + 1e-30
    return np.argsort(xc @ v, kind="stable")


def previous_neighbors(x_ordered: np.ndarray, m: int, oversample: int = 4) -> tuple[np.ndarray, np.ndarray]:
    """(nn_idx (n, m) int64, nn_mask (n, m)) -- for each i, up to m nearest
    points among rows < i of ``x_ordered``.

    A cKDTree over all points is queried for ``oversample·m`` candidates,
    filtered to previous rows; rows the filter leaves short are topped up
    by brute force against their full prefix (exact)."""
    from scipy.spatial import cKDTree

    x = np.asarray(x_ordered, dtype=np.float64)
    n = x.shape[0]
    nn_idx = np.zeros((n, m), dtype=np.int64)
    nn_mask = np.zeros((n, m), dtype=np.float64)
    kq = min(n, oversample * m + 1)
    _, cand = cKDTree(x).query(x, k=kq)  # (n, kq), includes self
    for i in range(1, n):
        prev = cand[i][cand[i] < i][:m]
        if len(prev) < min(m, i):  # top up exactly
            d = ((x[:i] - x[i]) ** 2).sum(axis=1)
            prev = np.argsort(d, kind="stable")[:m]
        k = len(prev)
        nn_idx[i, :k] = prev
        nn_mask[i, :k] = 1.0
    return nn_idx, nn_mask


def test_point_neighbors(x_train: np.ndarray, x_new: np.ndarray, m: int) -> np.ndarray:
    """(n*, m) indices of each test point's m nearest training points."""
    from scipy.spatial import cKDTree

    tree = cKDTree(np.asarray(x_train, dtype=np.float64))
    return query_point_neighbors(tree, np.asarray(x_new, dtype=np.float64), m, len(x_train))


def query_point_neighbors(tree, x_new, m: int, n_train: int) -> np.ndarray:
    """As :func:`test_point_neighbors` against a prebuilt cKDTree."""
    _, idx = tree.query(np.asarray(x_new, dtype=np.float64), k=min(m, n_train))
    idx = np.asarray(idx).reshape(len(x_new), -1)  # k = 1 squeezes to (n*,)
    # n_train < m: pad with the nearest index; the duplicated Gram rows
    # stay positive definite through the +noise diagonal
    if idx.shape[1] < m:
        idx = np.pad(idx, ((0, 0), (0, m - idx.shape[1])), mode="edge")
    return idx.astype(np.int64)
