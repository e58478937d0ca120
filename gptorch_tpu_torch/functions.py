"""Robust linear algebra primitives.

Counterpart of ``gptorch_tpu/functions.py``.  A failed factorization gives
a factor full of NaN, as in the JAX package; :func:`cholesky_or_raise`
turns that into an exception.

Jitter policies (see :mod:`gptorch_tpu_torch.settings`):

* ``adaptive`` -- the reference gptorch's escalation: the bare matrix first,
  then absolute jitters ``10**(-max_jitter_tries+i)``.  The JAX package
  picks the level with an on-device NaN probe, ``vmap``ped over a batch;
  here a host loop over the same schedule probes with one batched
  ``torch.linalg.cholesky_ex`` per level on a detached copy, only the
  matrices that failed going on to the next level, and picks the same
  level for each matrix (one host read per level tried, whatever the
  batch).  Under ``torch.func.vmap`` the probe runs on the whole mapped
  batch (:class:`_AdaptiveJitter`).  The differentiated factorization then
  runs once, each matrix at its level: a matrix that needed none is
  factored bare, so its factor is differentiated only through the branch
  it took, as in the JAX package.
* ``fixed`` -- one relative jitter ``fixed_jitter * mean(diag(A))``, detached.
* ``none`` -- factor as is.
"""

from __future__ import annotations

import torch

from . import settings


def add_diag(a, s):
    """``a + s·I`` without materializing an identity.

    ``s`` is told apart by NDIM, as in the JAX package:

    * ``s.ndim == 0``          -- one scalar on every diagonal;
    * ``s.ndim == a.ndim - 2`` -- one scalar per matrix (``a.shape[:-2]``);
    * ``s.ndim == a.ndim - 1`` -- a per-diagonal vector, ``a.shape[:-2] + (n,)``.
    """
    s = torch.as_tensor(s, dtype=a.dtype, device=a.device)
    if s.ndim == a.ndim - 1:
        pass  # per-diagonal vector: s[..., i] lands at (i, i)
    elif s.ndim == a.ndim - 2:
        s = s[..., None]  # per-matrix scalar
    elif s.ndim != 0:
        raise ValueError(
            f"add_diag: s.ndim {s.ndim} must be 0, a.ndim-2, or a.ndim-1 (a.ndim {a.ndim})"
        )
    out = a.clone()
    out.diagonal(dim1=-2, dim2=-1).add_(s)
    return out


def _jitter_schedule(dtype, device):
    """Absolute jitters tried after the bare attempt:
    10**(-max_tries+i), i = 0..max_tries-1."""
    n = settings.config.max_jitter_tries
    return torch.tensor([10.0 ** (-n + i) for i in range(n)], dtype=dtype, device=device)


#: From this n on, ``cholesky(..., blocked=True)`` of one matrix takes the
#: blocked factorization (the JAX package's threshold).
_BLOCKED_MIN_N = 4096


def _chol_raw(a, blocked: bool = True):
    """Lower Cholesky factor; NaN wherever the factorization failed.

    One matrix of n ≥ ``_BLOCKED_MIN_N`` with ``blocked`` takes
    :func:`~gptorch_tpu_torch.ops.blocked.cholesky_blocked` (panel
    factorization, closed-form adjoint), as in the JAX package; anything
    else, or ``blocked=False``, takes ``torch.linalg.cholesky_ex``
    (cuSOLVER on the card)."""
    if blocked and a.ndim == 2 and a.shape[0] >= _BLOCKED_MIN_N:
        from .ops.blocked import cholesky_blocked

        return cholesky_blocked(a)
    L, info = torch.linalg.cholesky_ex(a)
    return L.masked_fill((info != 0)[..., None, None], float("nan"))


def _jitter_levels(a):
    """The smallest jitter (0, or a level of the schedule) that gives a
    finite factor of each matrix of the detached ``a`` (..., n, n); the
    largest level where none does.  Returns (jitters of shape
    ``a.shape[:-2]``, whether any matrix needs one).  One batched
    ``cholesky_ex`` and one host read per level tried: the bare attempt,
    then each level for the matrices still failing."""
    a = a.detach()
    batch = a.shape[:-2]
    flat = a.reshape((-1,) + tuple(a.shape[-2:]))

    def failing(m):
        L, info = torch.linalg.cholesky_ex(m)
        return (info != 0) | ~torch.isfinite(L).all(dim=-1).all(dim=-1)

    todo = torch.nonzero(failing(flat)).flatten().cpu()
    jitter = torch.zeros(flat.shape[0], dtype=a.dtype, device=a.device)
    if todo.numel() == 0:
        return jitter.reshape(batch), False
    schedule = _jitter_schedule(a.dtype, a.device)
    for level in schedule:
        rows = todo.to(a.device)
        still = failing(add_diag(flat[rows], level)).cpu()
        jitter[rows[~still.to(a.device)]] = level
        todo = todo[still]
        if todo.numel() == 0:
            break
    jitter[todo.to(a.device)] = schedule[-1]
    return jitter.reshape(batch), True


def _select_jitter(a):
    """:func:`_jitter_levels`'s jitters alone: 0 for a matrix that factors
    bare."""
    return _jitter_levels(a)[0]


class _AdaptiveJitter(torch.autograd.Function):
    """:func:`_select_jitter` as a non-differentiable function,
    whose ``vmap`` rule probes the whole mapped batch at once (the host
    loop cannot run on one mapped matrix)."""

    @staticmethod
    def forward(a):
        return _select_jitter(a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def vmap(info, in_dims, a):
        return _AdaptiveJitter.apply(a.movedim(in_dims[0], 0)), 0


def cholesky(a, policy: str | None = None, blocked: bool = True):
    """Lower-triangular Cholesky factor with configurable jitter robustness.

    ``a`` may carry leading batch axes.  ``blocked=False`` forces
    ``torch.linalg.cholesky_ex`` at every n (see :func:`_chol_raw`): on the
    card cuSOLVER factors the n = 32768 Gram faster than the blocked route,
    so the port's one-time factorizations pass it."""
    a = torch.as_tensor(a)
    policy = policy if policy is not None else settings.config.jitter_policy
    if policy == "none":
        return _chol_raw(a, blocked)
    if policy == "fixed":
        scale = torch.mean(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1)
        return _chol_raw(add_diag(a, settings.config.fixed_jitter * scale.detach()), blocked)
    if policy == "adaptive":
        if torch._C._functorch.is_batchedtensor(a):
            return _chol_raw(add_diag(a, _AdaptiveJitter.apply(a.detach())), blocked)
        jitter, needed = _jitter_levels(a)
        return _chol_raw(add_diag(a, jitter) if needed else a, blocked)
    raise ValueError(f"Unknown jitter policy {policy!r}")


def trtrs(b, a, lower: bool = True):
    """Solve ``a x = b`` with triangular ``a``; argument order (b, a) as in
    the reference gptorch."""
    return torch.linalg.solve_triangular(a, b, upper=not lower)


def lt_log_determinant(L):
    """log|L| for lower-triangular L = sum(log diag L)."""
    return torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def cholesky_inverse(L, upper: bool = False):
    """Inverse of A from its Cholesky factor."""
    return torch.cholesky_inverse(L, upper=upper)


def inverse(a):
    """Matrix inverse; unless the policy is ``none``, a matrix whose inverse
    is not finite is inverted again with the relative jitter
    ``fixed_jitter * mean(|diag(a)|)``."""
    a = torch.as_tensor(a)
    if settings.config.jitter_policy == "none":
        return torch.linalg.inv(a)
    probe, info = torch.linalg.inv_ex(a.detach())
    if bool((info == 0).all()) and bool(torch.isfinite(probe).all()):
        return torch.linalg.inv(a)
    jitter = settings.config.fixed_jitter * torch.mean(
        torch.abs(torch.diagonal(a, dim1=-2, dim2=-1))
    ).detach()
    return torch.linalg.inv(add_diag(a, jitter))


def cholesky_or_raise(a, policy: str | None = None):
    """:func:`cholesky` that raises when even the largest jitter fails."""
    L = cholesky(a, policy=policy, blocked=False)
    if not bool(torch.isfinite(L).all()):
        raise RuntimeError("Max tries exceeded.")
    return L
