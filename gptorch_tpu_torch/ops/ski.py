"""Structured kernel interpolation (SKI / KISS-GP) primitives.

Counterpart of ``gptorch_tpu/ops/ski.py`` (Wilson & Nickisch 2015): a
product-form stationary kernel matrix is approximated as

    K  ≈  W K_g Wᵀ

where ``K_g`` is the kernel on a regular product grid, a Kronecker product
of symmetric Toeplitz factors (one per input dimension), and ``W`` a
sparse cubic-interpolation matrix (4 weights per dimension, 4ᵈ per row).
A product costs O(n·4ᵈ + G log G): the Toeplitz factors by circulant
embedding and ``torch.fft``, the n-side a gather (W) and a sum into the
grid (Wᵀ).

Wᵀ is deterministic.  The JAX package sums into the grid by a scatter-add
(``.at[].add``); ``index_add_`` on a CUDA tensor sums by atomics in any
order, so two identical calls could return different bits, and mBCG's
coefficients amplify such differences step after step.  Here the stencil's
entries are sorted once by grid node (stable, so each node sums its
entries in the data's order, as a sequential scatter-add does) and each
node's segment is summed by ``torch.segment_reduce``, whose order is fixed:
see :func:`transpose_plan`.  The products carry their own gradients (the
gather's is this sum, the sum's is the gather), so no autograd scatter runs
either.
"""

from __future__ import annotations

from typing import Sequence

import torch

__all__ = [
    "cubic_interp",
    "combine_dims",
    "interp_matvec",
    "interp_rmatvec",
    "toeplitz_matvec",
    "kron_toeplitz_matvec",
    "make_grid",
    "transpose_plan",
]


def make_grid(x, grid_shape, margin_cells: int = 3):
    """Per-dimension regular grids covering the data range.

    :param x: (n, d) inputs.
    :param grid_shape: ``d`` grid sizes (each ≥ 8).
    :param margin_cells: cells of padding beyond the data range on each
        side, so every point has 4 in-range neighbours (cubic stencil).
    :returns: (lows (d,), spacings (d,)).
    """
    lo = torch.amin(x, dim=0)
    hi = torch.amax(x, dim=0)
    sizes = torch.as_tensor(grid_shape, dtype=x.dtype, device=x.device)
    span = torch.clamp(hi - lo, min=1e-12)
    h = span / (sizes - 1 - 2 * margin_cells)
    return lo - margin_cells * h, h


def cubic_interp(t, g: int):
    """Cubic-convolution (Keys 1981, a = −1/2) interpolation stencil.

    :param t: (n,) grid-normalized coordinates (node index space).
    :param g: number of grid nodes on this axis.
    :returns: (idx (n, 4) int64 clamped to [0, g−1], w (n, 4)); the weights
        sum to 1 and reproduce polynomials up to degree 2 exactly.
    """
    j = torch.clamp(torch.floor(t).to(torch.int64), 0, g - 2)
    s = t - j.to(t.dtype)

    def u_near(r):  # |r| <= 1
        return (1.5 * r - 2.5) * r * r + 1.0

    def u_far(r):  # 1 < |r| < 2
        return ((-0.5 * r + 2.5) * r - 4.0) * r + 2.0

    w = torch.stack([u_far(1.0 + s), u_near(s), u_near(1.0 - s), u_far(2.0 - s)], dim=-1)
    offsets = torch.arange(-1, 3, dtype=torch.int64, device=t.device)
    idx = torch.clamp(j[:, None] + offsets[None, :], 0, g - 1)  # margin cells make clamping a no-op
    return idx, w


def combine_dims(per_dim, grid_shape):
    """Per-dimension stencils combined into flat-grid row stencils.

    :param per_dim: list of (idx (n, 4), w (n, 4)) per dimension.
    :param grid_shape: grid sizes (row-major flattening).
    :returns: (flat_idx (n, 4ᵈ) int64, w (n, 4ᵈ)).
    """
    idx, w = per_dim[0]
    for (idx_k, w_k), g_k in zip(per_dim[1:], grid_shape[1:]):
        idx = (idx[..., :, None] * g_k + idx_k[..., None, :]).reshape(idx.shape[0], -1)
        w = (w[..., :, None] * w_k[..., None, :]).reshape(w.shape[0], -1)
    return idx, w


def transpose_plan(flat_idx, w, num_grid: int):
    """Wᵀ's fixed summation order, built once for a stencil: the data row of
    each stencil entry and its weight, sorted by grid node (a stable sort,
    so each node keeps its entries in the data's order), and the number of
    entries of each node (G,).  Deterministic: the same stencil gives the
    same plan."""
    flat = flat_idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    rows = torch.div(order, flat_idx.shape[1], rounding_mode="floor")
    nodes = torch.arange(num_grid + 1, dtype=flat.dtype, device=flat.device)
    lengths = torch.diff(torch.searchsorted(flat[order], nodes))
    return rows, w.reshape(-1)[order], lengths


def _gather(flat_idx, w, v_grid):
    if v_grid.ndim == 1:
        return torch.sum(v_grid[flat_idx] * w, dim=1)
    return torch.sum(v_grid[flat_idx] * w[..., None], dim=1)


def _segment_sum(plan, u):
    rows, w_sorted, lengths = plan
    vals = u[rows] * (w_sorted if u.ndim == 1 else w_sorted[:, None])
    return torch.segment_reduce(vals, "sum", lengths=lengths, axis=0)


class _Interp(torch.autograd.Function):
    """W·v (a gather) whose gradient is Wᵀ·g by the plan's fixed order."""

    @staticmethod
    def forward(ctx, v_grid, flat_idx, w, plan):
        ctx.plan = plan
        return _gather(flat_idx, w, v_grid)

    @staticmethod
    def backward(ctx, g):
        return _segment_sum(ctx.plan, g), None, None, None


class _InterpT(torch.autograd.Function):
    """Wᵀ·u by the plan's fixed order, whose gradient is W·g (a gather)."""

    @staticmethod
    def forward(ctx, u, flat_idx, w, plan):
        ctx.save_for_backward(flat_idx, w)
        return _segment_sum(plan, u)

    @staticmethod
    def backward(ctx, g):
        flat_idx, w = ctx.saved_tensors
        return _gather(flat_idx, w, g), None, None, None


def interp_matvec(flat_idx, w, v_grid, plan=None):
    """``W v``: grid values interpolated to the data points.

    :param v_grid: (G,) or (G, t).
    :param plan: :func:`transpose_plan` of the stencil, for the gradient in
        ``v_grid`` (built when needed and not given).
    :returns: (n,) or (n, t).
    """
    if not v_grid.requires_grad:
        return _gather(flat_idx, w, v_grid)
    if plan is None:
        plan = transpose_plan(flat_idx, w, v_grid.shape[0])
    return _Interp.apply(v_grid, flat_idx, w, plan)


def interp_rmatvec(flat_idx, w, u, num_grid: int, plan=None):
    """``Wᵀ u``: data values summed back onto the grid, each node's entries
    in a fixed order (:func:`transpose_plan`, built when not given).

    :param u: (n,) or (n, t).
    :returns: (G,) or (G, t).
    """
    if plan is None:
        plan = transpose_plan(flat_idx, w, num_grid)
    return _InterpT.apply(u, flat_idx, w, plan)


def toeplitz_matvec(first_row, v):
    """Symmetric-Toeplitz product by circulant embedding and the FFT.

    :param first_row: (g,) first row (= first column) of T.
    :param v: (g,) or (g, t).
    :returns: T v, shaped like ``v``.
    """
    g = first_row.shape[0]
    # [r0..r_{g-1}, 0, r_{g-1}..r_1]  (length 2g)
    circ = torch.cat([first_row, first_row.new_zeros(1), torch.flip(first_row[1:], (0,))])
    fc = torch.fft.rfft(circ)
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    fv = torch.fft.rfft(torch.cat([v, torch.zeros_like(v)], dim=0), dim=0)
    out = torch.fft.irfft(fc[:, None] * fv, n=2 * g, dim=0)[:g].to(v.dtype)
    return out[:, 0] if squeeze else out


def kron_toeplitz_matvec(rows: Sequence[torch.Tensor], v, grid_shape):
    """``(T_1 ⊗ … ⊗ T_d) v`` for symmetric Toeplitz factors.

    :param rows: per-axis first rows ((g_k,) each).
    :param v: (G,) or (G, t), G = Π grid_shape, row-major.
    :returns: shaped like ``v``.
    """
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    t = v.shape[1]
    tensor = v.reshape(tuple(grid_shape) + (t,))
    for k, r in enumerate(rows):
        moved = torch.movedim(tensor, k, 0)
        flat = toeplitz_matvec(r, moved.reshape(grid_shape[k], -1))
        tensor = torch.movedim(flat.reshape(moved.shape), 0, k)
    out = tensor.reshape(-1, t)
    return out[:, 0] if squeeze else out
