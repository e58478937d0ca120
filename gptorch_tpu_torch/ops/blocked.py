"""Blocked dense linear algebra.

Counterpart of ``gptorch_tpu/ops/blocked.py``, with its names, signatures and
algorithms: the blocked and divide-and-conquer Cholesky factorizations, the
divide-and-conquer left triangular solve, the triangular inverse and the
LᵀL products.  Leaves go to ``torch.linalg.cholesky_ex`` and
``torch.linalg.solve_triangular``; products go to ``torch.matmul``, as the
JAX package leaves them to XLA.

* **In place.** The JAX loops' ``.at[].set/.add`` become in-place slice
  updates on a buffer the function owns.  The public functions never write
  into the caller's tensor; only :func:`_cholesky_into`, which
  :mod:`~gptorch_tpu_torch.ops.gpr_fast` and
  :mod:`~gptorch_tpu_torch.ops.gpr_general` call on the Gram they built
  themselves, factors its argument in place.
* **precision.** Kept for signature parity and mapped to nothing: TF32 is
  pinned off on the card (:func:`~gptorch_tpu_torch.settings.resolve_device`),
  so every float32 product is already a full float32 product.
* **Failed leaves.** A leaf Cholesky that fails gives NaN, as
  ``lax.linalg.cholesky`` does, and no host synchronisation: the NaN
  reaches the loss, where the training loops catch it.
"""

from __future__ import annotations

import torch


def _solve_lower(L, b):
    """L⁻¹ b, reading only L's lower triangle."""
    return torch.linalg.solve_triangular(L, b, upper=False)


def _solve_lower_t(L, b):
    """L⁻ᵀ b, reading only L's lower triangle."""
    return torch.linalg.solve_triangular(L.mT, b, upper=True)


def _rsolve_lower_t(L, a):
    """a L⁻ᵀ (solve X Lᵀ = a), reading only L's lower triangle."""
    return torch.linalg.solve_triangular(L.mT, a, upper=True, left=False)


def _chol_leaf(a):
    """Lower Cholesky factor of a leaf block (its lower triangle is read),
    zeros above the diagonal; all NaN if the factorization failed."""
    L, info = torch.linalg.cholesky_ex(a)
    return L.masked_fill(info != 0, float("nan"))


def _pad_to(a, n_pad):
    """``a`` itself if it is n_pad wide, else a new (n_pad, n_pad) buffer
    with ``a`` in the corner and the identity on the padded diagonal, so the
    factorizations stay well posed."""
    n = a.shape[0]
    if n == n_pad:
        return a
    out = a.new_zeros((n_pad, n_pad))
    out[:n, :n] = a
    out.diagonal()[n:] = 1.0
    return out


def _panel_trsm(lkk, a_panel, nb2: int):
    """L_panel = A_panel · L_kk⁻ᵀ as a blocked forward substitution over
    nb2-wide column blocks:

        X[:, j] = (A[:, j] − X[:, :j] @ L[j, :j]ᵀ) · L[j, j]⁻ᵀ

    (LAPACK's blocked TRSM: the r·nb² off-diagonal flops become GEMMs)."""
    nb = lkk.shape[0]
    if nb2 <= 0 or nb <= nb2 or nb % nb2 != 0:
        return _rsolve_lower_t(lkk, a_panel)
    out = torch.empty_like(a_panel)
    for lo in range(0, nb, nb2):
        hi = lo + nb2
        rhs = a_panel[:, lo:hi]
        if lo:
            rhs = rhs - out[:, :lo] @ lkk[lo:hi, :lo].mT
        out[:, lo:hi] = _rsolve_lower_t(lkk[lo:hi, lo:hi], rhs)
    return out


def _rtrsm(lkk, a_panel, leaf: int = 128, precision=None):
    """Recursive right-side TRSM, X = A·L⁻ᵀ: the substitution of
    :func:`_panel_trsm` split in halves, so the products are large and
    square; only the ``leaf``-wide solves run at the triangular-solve rate.
    ``precision`` maps to nothing (module docstring)."""
    m = lkk.shape[0]
    if m <= leaf:
        return _rsolve_lower_t(lkk, a_panel)
    h = m // 2
    X1 = _rtrsm(lkk[:h, :h], a_panel[:, :h], leaf, precision)
    A2 = a_panel[:, h:] - X1 @ lkk[h:, :h].mT
    X2 = _rtrsm(lkk[h:, h:], A2, leaf, precision)
    return torch.cat([X1, X2], dim=1)


def blocked_ltrsm(L, b, leaf: int = 4096, trans: int = 0, precision=None):
    """Divide-and-conquer left triangular solve: x = L⁻¹ b (trans=0) or
    x = L⁻ᵀ b (trans=1), b (n, nrhs), reading only L's lower triangle.
    Only the leaf solves run at the triangular-solve rate; the rest is two
    products per level:

        trans=0:  x₁ = L₁₁⁻¹ b₁;  x₂ = L₂₂⁻¹ (b₂ − L₂₁ x₁)
        trans=1:  x₂ = L₂₂⁻ᵀ b₂;  x₁ = L₁₁⁻ᵀ (b₁ − L₂₁ᵀ x₂)
    """
    n = L.shape[0]
    if n <= leaf:
        return _solve_lower_t(L, b) if trans else _solve_lower(L, b)
    h = n // 2
    L11, L21, L22 = L[:h, :h], L[h:, :h], L[h:, h:]
    if trans == 0:
        x1 = blocked_ltrsm(L11, b[:h], leaf, 0, precision)
        x2 = blocked_ltrsm(L22, b[h:] - L21 @ x1, leaf, 0, precision)
    else:
        x2 = blocked_ltrsm(L22, b[h:], leaf, 1, precision)
        x1 = blocked_ltrsm(L11, b[:h] - L21.mT @ x2, leaf, 1, precision)
    return torch.cat([x1, x2], dim=0)


#: Largest n the divide-and-conquer Cholesky assembles by concatenation;
#: above it the outer levels split in place on the master buffer, and
#: :func:`blocked_cholesky` takes the flat right-looking loop (the JAX
#: package's choice, kept so both packages run the same algorithm).
_DC_CONCAT_MAX = 16384


def _chol_dc_concat(a, leaf: int, solve_block: int, precision):
    """Divide-and-conquer Cholesky of a block ≤ ``_DC_CONCAT_MAX``, into a
    new buffer with exact zeros in the strict upper triangle."""
    n = a.shape[0]
    if n <= leaf:
        return _chol_leaf(a)
    h = n // 2
    out = a.new_zeros((n, n))
    out[:h, :h] = LA = _chol_dc_concat(a[:h, :h], leaf, solve_block, precision)
    out[h:, :h] = LB = _rtrsm(LA, a[h:, :h], solve_block, precision)
    S = a[h:, h:] - LB @ LB.mT
    out[h:, h:] = _chol_dc_concat(S, leaf, solve_block, precision)
    return out


def _chol_dc_big(K, lo, m, leaf: int, solve_block: int, precision):
    """In-place outer levels for blocks > ``_DC_CONCAT_MAX`` of ``K``:
    factor the block K[lo:lo+m, lo:lo+m], delegating blocks ≤
    ``_DC_CONCAT_MAX`` to :func:`_chol_dc_concat`.  The strict upper
    blocks keep leftovers of ``K``."""
    if m <= _DC_CONCAT_MAX:
        blk = K[lo : lo + m, lo : lo + m]
        blk.copy_(_chol_dc_concat(blk, leaf, solve_block, precision))
        return
    h = m // 2
    _chol_dc_big(K, lo, h, leaf, solve_block, precision)
    LA = K[lo : lo + h, lo : lo + h]
    LB = _rtrsm(LA, K[lo + h : lo + m, lo : lo + h], solve_block, precision)
    K[lo + h : lo + m, lo : lo + h] = LB
    K[lo + h : lo + m, lo + h : lo + m].addmm_(LB, LB.mT, alpha=-1.0)
    _chol_dc_big(K, lo + h, m - h, leaf, solve_block, precision)


def _chol_dc(a, leaf: int = 1024, solve_block: int = 128, precision=None,
             lower_only: bool = False):
    """Divide-and-conquer Cholesky (stock Cholesky only at ``leaf``-sized
    leaves):

        chol([[A, 0], [B, C]]) = [[L_A, 0], [B·L_A⁻ᵀ, chol(C − L_B L_Bᵀ)]]

    Above ``_DC_CONCAT_MAX`` it factors ``a`` in place (callers pass a
    buffer they own); with ``lower_only=True`` the strict upper triangle
    then holds leftovers of ``a``."""
    n = a.shape[0]
    if n <= leaf:
        return _chol_leaf(a)
    if n <= _DC_CONCAT_MAX:
        return _chol_dc_concat(a, leaf, solve_block, precision)
    _chol_dc_big(a, 0, n, leaf, solve_block, precision)
    return a if lower_only else a.tril_()


def _cholesky_into(K, nb: int = 1024, lower_only: bool = False, solve_block: int = 128,
                   precision=None, algo: str = "dc"):
    """:func:`blocked_cholesky` that may overwrite ``K`` with its factor
    (the right-looking loop and the in-place d&c levels do; the returned
    factor is then ``K`` or a view of it)."""
    n = K.shape[0]
    if algo == "dc" and nb < n <= _DC_CONCAT_MAX:
        return _chol_dc(K, nb, solve_block or 128, precision, lower_only)
    if n <= nb:
        if n > 1024:
            return _chol_dc(K, 1024, solve_block or 128, precision, lower_only)
        return _chol_leaf(K)
    p = -(-n // nb)
    K = _pad_to(K, p * nb)
    for k in range(p):
        lo = k * nb
        hi = lo + nb
        akk = K[lo:hi, lo:hi]
        if nb > 1024:
            lkk = _chol_dc_concat(akk, 1024, solve_block or 128, precision)
        else:
            lkk = _chol_leaf(akk)
        akk.copy_(lkk)
        if hi < K.shape[0]:
            a_panel = K[hi:, lo:hi]
            if nb > 1024:
                l_panel = _rtrsm(lkk, a_panel, solve_block or 128, precision)
            else:
                l_panel = _panel_trsm(lkk, a_panel, solve_block)
            a_panel.copy_(l_panel)
            # Trailing update A22 -= L_panel L_panelᵀ on the lower blocks
            # only: row block i updates its columns k+1..i.
            for i in range(k + 1, p):
                ilo = i * nb
                width = ilo + nb - hi
                K[ilo : ilo + nb, hi : hi + width].addmm_(
                    l_panel[ilo - hi : ilo - hi + nb], l_panel[:width].mT, alpha=-1.0
                )
    K = K[:n, :n]
    return K if lower_only else torch.tril(K)


def blocked_cholesky(
    a, nb: int = 1024, lower_only: bool = False, solve_block: int = 128,
    precision=None, algo: str = "dc",
):
    """Lower Cholesky factor by blocks; ``a`` is not modified.

    ``algo="dc"`` (default): divide and conquer (:func:`_chol_dc`, with
    ``nb`` as the leaf size and ``solve_block`` as the recursive-TRSM leaf)
    for nb < n ≤ ``_DC_CONCAT_MAX``.  ``algo="right"``, and every n above
    ``_DC_CONCAT_MAX``: the flat right-looking panel loop, in place on a
    copy.

    ``lower_only=True`` skips the final ``tril``: the strict upper triangle
    may then hold leftovers of ``a``.  Safe when every consumer reads only
    the lower triangle, as ``torch.linalg.solve_triangular(upper=False)``,
    :func:`blocked_ltrsm`, :func:`blocked_trtri` and diagonal reductions do.

    ``solve_block`` is the TRSM sub-block width (0 = one solve per panel);
    ``precision`` maps to nothing (module docstring).
    """
    return _cholesky_into(a.clone(), nb, lower_only, solve_block, precision, algo)


class _CholeskyBlocked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, nb):
        L = blocked_cholesky(a, nb, lower_only=False)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        M = L.mT @ Lbar
        Phi = torch.tril(M)
        Phi.diagonal().mul_(0.5)
        S = 0.5 * (Phi + Phi.mT)
        tmp = _solve_lower_t(L, S)
        return _solve_lower_t(L, tmp.mT).mT, None


def cholesky_blocked(a, nb: int = 1024):
    """:func:`blocked_cholesky` with a closed-form adjoint (Murray 2016):

        Ā = ½ L⁻ᵀ (Φ(LᵀL̄) + Φ(LᵀL̄)ᵀ) L⁻¹,   Φ = tril with halved diagonal

    two triangular solves and one product, instead of autograd through the
    panel loop."""
    return _CholeskyBlocked.apply(a, nb)


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
    """Inverse of a lower-triangular matrix by divide and conquer, reading
    only L's lower triangle:

        [[A, 0], [B, C]]⁻¹ = [[A⁻¹, 0], [−C⁻¹ B A⁻¹, C⁻¹]]

    with triangle-aware block products, n³/3 flops in all."""
    n = L.shape[0]
    if n <= nb:
        eye = torch.eye(n, dtype=L.dtype, device=L.device)
        return _solve_lower(L, eye)
    m = ((n // 2) // nb) * nb or nb  # split at a multiple of nb near the middle
    out = torch.zeros_like(L)
    out[:m, :m] = Ai = blocked_trtri(L[:m, :m], nb)
    out[m:, m:] = Ci = blocked_trtri(L[m:, m:], nb)
    out[m:, :m] = -_trmm_lower_dense(Ci, _trmm_dense_lower(L[m:, :m], Ai, nb), nb)
    return out


def _syrk_lower(B, nb: int):
    """Lower triangle of BᵀB for dense B (k, m), block column by block
    column: column block j multiplies only against columns ≥ j (half the
    dense flops); the strict upper blocks are left zero."""
    m = B.shape[1]
    if m <= nb:
        return B.mT @ B
    out = B.new_zeros((m, m))
    for lo in range(0, m, nb):
        hi = min(m, lo + nb)
        out[lo:, lo:hi] = B[:, lo:].mT @ B[:, lo:hi]
    return out


def tril_square_rec(Linv, nb: int = 512, leaf: int = 4096):
    """LᵀL for lower-triangular L by divide and conquer (LAUUM-style):

        [[A,0],[B,C]]ᵀ[[A,0],[B,C]] = [[AᵀA + BᵀB, BᵀC], [CᵀB, CᵀC]]

    the diagonal blocks recurse, BᵀB is a half-flop syrk, BᵀC a
    triangle-aware product; n³/3 flops.  Returns the full symmetric
    matrix."""
    n = Linv.shape[0]
    if n <= leaf or n <= nb:
        return tril_square(Linv, nb)
    m = ((n // 2) // nb) * nb or nb
    B = Linv[m:, :m]
    out = Linv.new_empty((n, n))
    out[:m, :m] = tril_square_rec(Linv[:m, :m], nb, leaf)
    BtB = torch.tril(_syrk_lower(B, nb))  # diagonal blocks carry upper halves:
    BtB += torch.tril(BtB, -1).mT  # keep the lower triangle, then mirror
    out[:m, :m] += BtB
    del BtB
    TR = _trmm_dense_lower(B.mT, Linv[m:, m:], nb)  # (m, n-m) = Bᵀ C
    out[:m, m:] = TR
    out[m:, :m] = TR.mT
    del TR
    out[m:, m:] = tril_square_rec(Linv[m:, m:], nb, leaf)
    return out


def tril_square_dc(Linv, leaf: int = 2048, precision=None):
    """LᵀL for lower-triangular L with full square products per level
    (2× the flops of :func:`tril_square_rec`'s strips, in larger GEMMs).
    Returns the full symmetric matrix; ``precision`` maps to nothing."""
    n = Linv.shape[0]
    if n <= leaf:
        return tril_square(Linv, min(leaf, 1024))
    m = n // 2
    B = Linv[m:, :m]
    out = Linv.new_empty((n, n))
    out[:m, :m] = tril_square_dc(Linv[:m, :m], leaf, precision) + B.mT @ B
    out[m:, m:] = tril_square_dc(Linv[m:, m:], leaf, precision)
    TR = B.mT @ Linv[m:, m:]
    out[:m, m:] = TR
    out[m:, :m] = TR.mT
    return out


def tril_square(Linv, nb: int = 1024):
    """Linvᵀ Linv for lower-triangular Linv: block (j, i ≤ j) sums only
    over k ≥ j,

        out[j, i] = Σ_{k ≥ j} Linv[k, j]ᵀ Linv[k, i],

    about n³/3 flops instead of 2n³; each block row is written with its
    mirror."""
    n = Linv.shape[0]
    if n <= nb:
        return Linv.mT @ Linv
    p = -(-n // nb)
    n_pad = p * nb
    if n == n_pad:
        Lp = Linv
    else:
        Lp = Linv.new_zeros((n_pad, n_pad))
        Lp[:n, :n] = Linv
    out = Linv.new_empty((n_pad, n_pad))
    for j in range(p):
        lo = j * nb
        row = Lp[lo:, lo : lo + nb].mT @ Lp[lo:, : lo + nb]
        out[lo : lo + nb, : lo + nb] = row
        if lo:
            out[:lo, lo : lo + nb] = row[:, :lo].mT
    return out[:n, :n]
