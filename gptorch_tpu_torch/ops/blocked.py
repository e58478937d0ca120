"""Blocked triangular inverse.

Counterpart of ``blocked_trtri`` and its triangular multiplies in
``gptorch_tpu/ops/blocked.py``: divide and conquer whose leaves are
``torch.linalg.solve_triangular`` against the identity and whose corrections
are ``torch.matmul`` products that skip the zero upper blocks.
"""

from __future__ import annotations

import torch


def _trmm_lower_dense(T, D, nb: int):
    """T @ D with T (m, m) lower-triangular and D (m, k) dense, skipping T's
    zero upper blocks: block-row i is T[i·nb:, :hi] @ D[:hi] (m²k flops
    instead of 2m²k)."""
    m = T.shape[0]
    if m <= nb:
        return T @ D
    return torch.cat([T[lo : lo + nb, : lo + nb] @ D[: lo + nb] for lo in range(0, m, nb)], dim=0)


def _trmm_dense_lower(D, T, nb: int):
    """D @ T with D (k, m) dense and T (m, m) lower-triangular, skipping T's
    zero upper blocks: block-column j is D[:, lo:] @ T[lo:, lo:hi]."""
    m = T.shape[0]
    if m <= nb:
        return D @ T
    return torch.cat([D[:, lo:] @ T[lo:, lo : lo + nb] for lo in range(0, m, nb)], dim=1)


def blocked_trtri(L, nb: int = 1024):
    """Inverse of a lower-triangular matrix by divide and conquer:

        [[A, 0], [B, C]]⁻¹ = [[A⁻¹, 0], [−C⁻¹ B A⁻¹, C⁻¹]]

    with triangle-aware block products, n³/3 flops in all."""
    n = L.shape[0]
    if n <= nb:
        eye = torch.eye(n, dtype=L.dtype, device=L.device)
        return torch.linalg.solve_triangular(L, eye, upper=False)
    m = ((n // 2) // nb) * nb or nb  # split at a multiple of nb near the middle
    Ai = blocked_trtri(L[:m, :m], nb)
    Ci = blocked_trtri(L[m:, m:], nb)
    lower_left = -_trmm_lower_dense(Ci, _trmm_dense_lower(L[m:, :m], Ai, nb), nb)
    out = torch.zeros_like(L)
    out[:m, :m] = Ai
    out[m:, :m] = lower_left
    out[m:, m:] = Ci
    return out
