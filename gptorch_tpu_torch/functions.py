"""Robust linear algebra primitives.

Counterpart of ``gptorch_tpu/functions.py``.  A failed factorization gives
a factor full of NaN, as in the JAX package; :func:`cholesky_or_raise`
turns that into an exception.

Jitter policies (see :mod:`gptorch_tpu_torch.settings`):

* ``adaptive`` -- the reference gptorch's escalation: the bare matrix first,
  then absolute jitters ``10**(-max_jitter_tries+i)``.  The JAX package
  picks the level with an on-device NaN probe; here a host loop over the
  same schedule probes with ``torch.linalg.cholesky_ex`` on a detached copy
  and picks the same level.  The differentiated factorization then runs
  once, at that level.
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


def _factors(a) -> bool:
    """Whether ``a`` has a finite Cholesky factor (the NaN probe)."""
    L, info = torch.linalg.cholesky_ex(a)
    return bool(info == 0) and bool(torch.isfinite(L).all())


def _select_jitter(a):
    """The smallest jitter (0, or a level of the schedule) that gives a
    finite factor of the detached ``a``; the largest level if none does."""
    a = a.detach()
    if _factors(a):
        return None
    schedule = _jitter_schedule(a.dtype, a.device)
    for jitter in schedule:
        if _factors(add_diag(a, jitter)):
            return jitter
    return schedule[-1]


def cholesky(a, policy: str | None = None, blocked: bool = True):
    """Lower-triangular Cholesky factor with configurable jitter robustness.

    ``blocked=False`` forces ``torch.linalg.cholesky_ex`` at every n (see
    :func:`_chol_raw`): on the card cuSOLVER factors the n = 32768 Gram
    faster than the blocked route, so the port's one-time factorizations
    pass it."""
    a = torch.as_tensor(a)
    policy = policy if policy is not None else settings.config.jitter_policy
    if policy == "none":
        return _chol_raw(a, blocked)
    if policy == "fixed":
        scale = torch.mean(torch.diagonal(a, dim1=-2, dim2=-1), dim=-1)
        return _chol_raw(add_diag(a, settings.config.fixed_jitter * scale.detach()), blocked)
    if policy == "adaptive":
        if a.ndim != 2:
            flat = a.reshape((-1,) + tuple(a.shape[-2:]))
            return torch.stack([cholesky(m, policy="adaptive", blocked=blocked) for m in flat]).reshape(a.shape)
        jitter = _select_jitter(a)
        return _chol_raw(a if jitter is None else add_diag(a, jitter), blocked)
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
