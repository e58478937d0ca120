"""State-space (Markovian) GP inference by parallel Kalman scans.

Counterpart of ``gptorch_tpu/ops/ssm.py``.  Matérn kernels on 1-D inputs
are the stationary solutions of linear SDEs (Hartikainen & Särkkä 2010), so
the dense-Gram NLML and posterior of
:class:`~gptorch_tpu_torch.models.GPR` follow from Kalman filtering and RTS
smoothing over a latent state of s ≤ 3 entries a term; both recursions are
associative (Särkkä & García-Fernández 2020), so they run as a parallel
prefix of log depth over batched (s, s) arithmetic: O(n) work, no n² Gram,
no iteration count.

Kernel → SDE (state (f, f', ...); H picks f):

    Matern12   s=1  λ=1/ℓ     P∞ = σ²
    Matern32   s=2  λ=√3/ℓ    P∞ = diag(σ², σ²λ²)
    Matern52   s=3  λ=√5/ℓ    P∞ = [[σ², 0, -κ], [0, κ, 0], [-κ, 0, σ²λ⁴]],
                                κ = σ²λ²/3

F is the companion matrix of (z+λ)ˢ, so N = F + λI is nilpotent and the
transition over a gap Δ is A(Δ) = e^{-λΔ} Σ_{j<s} (NΔ)ʲ/j!; the process
noise is Q(Δ) = P∞ − A P∞ Aᵀ.  Sums of eligible kernels stack
block-diagonally.

Eager torch has no ``lax.associative_scan``: :func:`associative_scan` is
the same recursion (combine adjacent pairs, recurse on the half, combine
the odd prefixes with the even elements, interleave), step for step, so
the port rounds in the JAX package's order.  Each of its ~2·log₂n levels
is one combine, a few dozen elementwise launches on (s, s, n/2ᵏ) tensors;
nothing loops over n.  The combines carry the batch axis last (matrices
(s, s, ·), vectors (s, dy, ·)), as the JAX package does, so one tiny
product is one broadcast multiply and one reduction over s.  With s ≤ 3
every inverse is a closed-form adjugate; the s > 3 states of Sum kernels
take ``torch.linalg.inv_ex``, which checks nothing on the host, so a
training step holds no host read and ``fit_scan`` can capture it.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "associative_scan",
    "matern_sde",
    "stack_sde",
    "discretize",
    "discretize_blocks",
    "filter_elements",
    "parallel_filter",
    "filter_nlml",
    "parallel_smoother",
    "assemble_sde",
    "ssm_nlml",
    "ssm_posterior",
    "sample_prior_states",
    "ssm_sample_posterior",
]


# -- small-matrix helpers ----------------------------------------------------


def _inv_small(D):
    """Batched closed-form inverse of (..., s, s), s ∈ {1, 2, 3} (adjugate
    over determinant: elementwise arithmetic only); larger s by
    ``torch.linalg.inv_ex``, which raises nothing on the host."""
    s = D.shape[-1]
    if s == 1:
        return 1.0 / D
    if s == 2:
        a, b = D[..., 0, 0], D[..., 0, 1]
        c, d = D[..., 1, 0], D[..., 1, 1]
        det = a * d - b * c
        adj = torch.stack([torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2)
        return adj / det[..., None, None]
    if s == 3:
        a, b, c = D[..., 0, 0], D[..., 0, 1], D[..., 0, 2]
        d, e, f = D[..., 1, 0], D[..., 1, 1], D[..., 1, 2]
        g, h, i = D[..., 2, 0], D[..., 2, 1], D[..., 2, 2]
        A = e * i - f * h
        B = -(d * i - f * g)
        C = d * h - e * g
        det = a * A + b * B + c * C
        adj = torch.stack(
            [
                torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
                torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
                torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
            ],
            dim=-2,
        )
        return adj / det[..., None, None]
    return torch.linalg.inv_ex(D).inverse


def _chol_small(Q):
    """Batched closed-form lower Cholesky of (..., s, s), s ∈ {1, 2, 3}.

    Q is PSD up to rounding (P∞ − A P∞ Aᵀ cancels for tiny gaps): negative
    pivots are clamped to 0, and a zero pivot (tied inputs) gives a zero
    row instead of NaN."""
    s = Q.shape[-1]

    def _div(num, den):
        pos = den > 0.0
        return torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)), torch.zeros_like(num))

    if s == 1:
        return torch.sqrt(torch.clamp(Q, min=0.0))
    if s == 2:
        a = torch.sqrt(torch.clamp(Q[..., 0, 0], min=0.0))
        b = _div(Q[..., 1, 0], a)
        c = torch.sqrt(torch.clamp(Q[..., 1, 1] - b * b, min=0.0))
        z = torch.zeros_like(a)
        return torch.stack([torch.stack([a, z], -1), torch.stack([b, c], -1)], dim=-2)
    if s == 3:
        l11 = torch.sqrt(torch.clamp(Q[..., 0, 0], min=0.0))
        l21 = _div(Q[..., 1, 0], l11)
        l31 = _div(Q[..., 2, 0], l11)
        l22 = torch.sqrt(torch.clamp(Q[..., 1, 1] - l21 * l21, min=0.0))
        l32 = _div(Q[..., 2, 1] - l31 * l21, l22)
        l33 = torch.sqrt(torch.clamp(Q[..., 2, 2] - l31 * l31 - l32 * l32, min=0.0))
        z = torch.zeros_like(l11)
        return torch.stack(
            [torch.stack([l11, z, z], -1), torch.stack([l21, l22, z], -1), torch.stack([l31, l32, l33], -1)],
            dim=-2,
        )
    return torch.linalg.cholesky(Q)


# -- kernel -> SDE coefficients ---------------------------------------------


def matern_sde(nu_twice: int, ell, var, dtype=None):
    """(F, Pinf, H) of Matérn-ν, ``nu_twice`` = 2ν ∈ {1, 3, 5}; ``ell`` and
    ``var`` are tensors with one element (gradients flow through them)."""
    ell = ell.reshape(()) if dtype is None else ell.to(dtype).reshape(())
    var = var.reshape(()).to(ell.dtype)
    z, o = torch.zeros_like(ell), torch.ones_like(ell)
    if nu_twice == 1:
        lam = 1.0 / ell
        return (-lam).reshape(1, 1), var.reshape(1, 1), o.reshape(1, 1)
    if nu_twice == 3:
        lam = math.sqrt(3.0) / ell
        F = torch.stack([torch.stack([z, o]), torch.stack([-(lam * lam), -2.0 * lam])])
        Pinf = torch.diag(torch.stack([var, var * lam * lam]))
        return F, Pinf, torch.stack([o, z]).reshape(1, 2)
    if nu_twice == 5:
        lam = math.sqrt(5.0) / ell
        F = torch.stack([torch.stack([z, o, z]), torch.stack([z, z, o]),
                         torch.stack([-(lam ** 3), -3.0 * lam * lam, -3.0 * lam])])
        kappa = var * lam * lam / 3.0
        Pinf = torch.stack([torch.stack([var, z, -kappa]), torch.stack([z, kappa, z]),
                            torch.stack([-kappa, z, var * lam ** 4])])
        return F, Pinf, torch.stack([o, z, z]).reshape(1, 3)
    raise ValueError(f"no closed-form SDE for 2ν={nu_twice}")


def _block_diag(blocks):
    """Block-diagonal (…, s, s) from (…, k, k) blocks with the same leading
    axes, assembled by zero padding (no in-place writes)."""
    s = sum(b.shape[-1] for b in blocks)
    rows, lo = [], 0
    for b in blocks:
        k = b.shape[-1]
        rows.append(torch.nn.functional.pad(b, (lo, s - lo - k)))
        lo += k
    return torch.cat(rows, dim=-2)


def stack_sde(blocks):
    """Block-diagonal sum of (F, Pinf, H) triples (kernel sums)."""
    Fs, Ps, Hs = zip(*blocks)
    return _block_diag(Fs), _block_diag(Ps), torch.cat(Hs, dim=1)


def discretize(F, Pinf, dts, lam_sum=None):
    """Transitions and process noises over sorted gaps.

    A(Δ) = expm(FΔ) by the nilpotent decomposition (F has the single
    eigenvalue −λ, inferred from the trace unless ``lam_sum`` is given);
    for block-diagonal sums discretize each block (:func:`discretize_blocks`).
    Q(Δ) = P∞ − A P∞ Aᵀ.

    :param dts: (n,) gaps; dts[0] is ignored: the first step starts from the
        stationary prior (A[0] = 0, Q[0] = P∞).
    :return: A (n, s, s), Q (n, s, s).
    """
    s = F.shape[0]
    # the diagonal's sum, not torch.trace, whose backward reads the host (no capture)
    lam = -torch.diagonal(F).sum() / s if lam_sum is None else lam_sum
    eye = torch.eye(s, dtype=F.dtype, device=F.device)
    N = F + lam * eye
    d = dts[:, None, None]
    term = eye.expand(dts.shape[0], s, s)
    A = term
    fact = 1.0
    for j in range(1, s):
        fact *= j
        term = torch.matmul(term, N) * d
        A = A + term / fact
    A = A * torch.exp(-lam * dts)[:, None, None]
    Q = Pinf[None] - torch.matmul(torch.matmul(A, Pinf[None]), A.transpose(1, 2))
    # first step: the transition from the stationary prior at mean 0
    A = torch.cat([torch.zeros_like(A[:1]), A[1:]])
    Q = torch.cat([Pinf[None], Q[1:]])
    return A, Q


def discretize_blocks(blocks, dts):
    """Per-block :func:`discretize` for a sum kernel, stacked block-diagonally."""
    pairs = [discretize(F, Pinf, dts) for F, Pinf, _H in blocks]
    return _block_diag([a for a, _ in pairs]), _block_diag([q for _, q in pairs])


# -- the parallel prefix -------------------------------------------------------


def _slice(x, dim, start, stop=None, step=1):
    index = [slice(None)] * x.ndim
    index[dim] = slice(start, stop, step)
    return x[tuple(index)]


def _interleave(a, b, dim):
    """a[0], b[0], a[1], b[1], ... along ``dim``; ``a`` may hold one more."""
    m = b.shape[dim]
    out = torch.stack([_slice(a, dim, 0, m), b], dim=dim + 1).flatten(dim, dim + 1)
    if a.shape[dim] > m:
        out = torch.cat([out, _slice(a, dim, m)], dim=dim)
    return out


def associative_scan(fn, elems, dim, reverse=False):
    """All prefixes ``elems[0] ⊗ … ⊗ elems[k]`` along ``dim`` of a tuple of
    tensors, for an associative ``fn(earlier, later)``: the recursion of
    ``jax.lax.associative_scan`` step for step (adjacent pairs combined, the
    half scanned recursively, the odd prefixes combined with the even
    elements, the two interleaved).  ``reverse`` scans from the end, as
    lax does: the inputs are flipped, scanned and flipped back."""
    elems = tuple(elems)
    dim = dim % elems[0].ndim
    if reverse:
        elems = tuple(torch.flip(e, (dim,)) for e in elems)

    def scan(elems):
        n = elems[0].shape[dim]
        if n < 2:
            return elems
        reduced = fn(tuple(_slice(e, dim, 0, n - 1, 2) for e in elems),
                     tuple(_slice(e, dim, 1, None, 2) for e in elems))
        odd = scan(tuple(reduced))
        later = tuple(_slice(e, dim, 2, None, 2) for e in elems)
        if n % 2 == 0:
            even = fn(tuple(_slice(e, dim, 0, -1) for e in odd), later)
        else:
            even = fn(odd, later)
        even = tuple(torch.cat([_slice(e, dim, 0, 1), r], dim=dim) for e, r in zip(elems, even))
        return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))

    out = scan(elems)
    if reverse:
        out = tuple(torch.flip(e, (dim,)) for e in out)
    return out


# -- trailing-batch tiny-matrix algebra --------------------------------------
#
# Matrices are (s, s, *batch), vectors (s, dy, *batch): each tiny product is
# one broadcast multiply and one sum over s, batched over the trailing axes
# (one for the monolithic scan, (chunks, chunk) for the chunked one).


def _tb(M):
    """(n, s, q) -> (s, q, n)."""
    return torch.movedim(M, 0, -1)


def _untb(M):
    return torch.movedim(M, -1, 0)


def _t(X):
    return X.transpose(0, 1)


def _mm(X, Y):
    """Z[i, j, ...] = Σ_k X[i, k, ...] Y[k, j, ...]."""
    return torch.sum(X[:, :, None] * Y[None], dim=1)


_mv = _mm  # the same contraction with a (s, dy, ...) right operand


def _add_eye(X):
    s = X.shape[0]
    return X + torch.eye(s, dtype=X.dtype, device=X.device).reshape((s, s) + (1,) * (X.ndim - 2))


def _inv_tb(D):
    """:func:`_inv_small` of (s, s, ...) matrices (the same elementwise
    arithmetic, on a view with the batch axes first)."""
    return torch.movedim(_inv_small(torch.movedim(D, (0, 1), (-2, -1))), (-2, -1), (0, 1))


# -- parallel Kalman filter --------------------------------------------------


def _filter_combine(elem_a, elem_b):
    """Associative combination of filtering elements (S&GF 2020, eq. 10):
    (A, b, C, η, J) parameterizes p(x_k | y, x_prev) ∝ N(A x_prev + b, C)
    with an information-form tail (η, J); ``elem_a`` is earlier in time."""
    A1, b1, C1, e1, J1 = elem_a
    A2, b2, C2, e2, J2 = elem_b
    Dinv = _inv_tb(_add_eye(_mm(C1, J2)))
    DTinv = _inv_tb(_add_eye(_mm(J2, C1)))
    A2D = _mm(A2, Dinv)
    A = _mm(A2D, A1)
    b = _mv(A2D, b1 + _mv(C1, e2)) + b2
    C = _mm(_mm(A2D, C1), _t(A2)) + C2
    A1T = _t(A1)
    e = _mv(A1T, _mv(DTinv, e2 - _mv(J2, b1))) + e1
    J = _mm(A1T, _mm(_mm(DTinv, J2), A1)) + J1
    return A, b, C, e, J


def _identity_elem(s, dy, dtype, device, ndim=3):
    """The neutral element of :func:`_filter_combine` (A = I, the rest 0),
    with unit trailing axes for broadcasting against (s, ·, *batch)."""
    ones = (1,) * (ndim - 2)
    return (
        torch.eye(s, dtype=dtype, device=device).reshape((s, s) + ones),
        torch.zeros((s, dy) + ones, dtype=dtype, device=device),
        torch.zeros((s, s) + ones, dtype=dtype, device=device),
        torch.zeros((s, dy) + ones, dtype=dtype, device=device),
        torch.zeros((s, s) + ones, dtype=dtype, device=device),
    )


def _scan_prefix(elems, chunk=None):
    """All-prefixes combine of trailing-batch filtering elements.

    ``chunk=None``: one :func:`associative_scan` over the whole length.
    With ``chunk``, the three-phase parallel prefix of the JAX package
    (whose phase 1 is a ``vmap`` of the scan):

      1. the all-prefix scans inside each chunk, as one scan batched over
         the (s, ·, chunks, chunk) view;
      2. the exclusive prefix of the chunk totals (chunks − 1 combines);
      3. each chunk's exclusive prefix folded into its local prefixes by
         one broadcast combine.

    The tail is padded with identity elements, which cannot perturb the
    prefixes at real positions; associativity makes the result the
    monolithic scan's.
    """
    n = elems[0].shape[2]
    if chunk is None or n <= chunk:
        return associative_scan(_filter_combine, elems, dim=2)
    s, dy, dtype, device = elems[0].shape[0], elems[1].shape[1], elems[0].dtype, elems[0].device
    ident = _identity_elem(s, dy, dtype, device)
    pad = (-n) % chunk
    if pad:
        elems = tuple(torch.cat([e, i.expand(i.shape[:2] + (pad,))], dim=2) for e, i in zip(elems, ident))
    nc = elems[0].shape[2] // chunk
    parts = tuple(a.reshape(a.shape[0], a.shape[1], nc, chunk) for a in elems)
    local = associative_scan(_filter_combine, parts, dim=3)  # phase 1
    totals = tuple(a[..., -1:] for a in local)  # (s, ·, nc, 1)
    pres = [ident]
    for i in range(nc - 1):  # phase 2
        pres.append(_filter_combine(pres[-1], tuple(t[:, :, i] for t in totals)))
    pre = tuple(torch.stack([p[j] for p in pres], dim=2) for j in range(len(ident)))  # (s, ·, nc, 1)
    out = _filter_combine(pre, local)  # phase 3
    return tuple(a.reshape(a.shape[0], a.shape[1], nc * chunk)[..., :n] for a in out)


def filter_elements(A, Q, H, R, y, mask=None):
    """The per-step filtering elements (A, b, C, η, J) of
    :func:`_filter_combine`, built batched over n and returned in the
    trailing-batch layout (matrices (s, s, n), vectors (s, dy, n)); masked
    steps (mask False) are pure predictions."""
    n, s = A.shape[0], A.shape[1]
    QH = torch.matmul(Q, H.T[None])  # (n, s, 1)
    S = torch.matmul(H[None], QH)[:, 0, 0] + R  # (n,)
    K = QH / S[:, None, None]
    eye = torch.eye(s, dtype=A.dtype, device=A.device)
    ImKH = eye[None] - torch.matmul(K, H[None].expand(n, 1, s))
    A_e = torch.matmul(ImKH, A)
    b_e = K * y[:, None, :]  # (n, s, dy)
    C_e = torch.matmul(ImKH, Q)
    HtSinv = H.T[None] / S[:, None, None]
    AT = A.transpose(1, 2)
    e_e = torch.matmul(AT, HtSinv) * y[:, None, :]
    J_e = torch.matmul(torch.matmul(AT, torch.matmul(H.T[None], H[None]) / S[:, None, None]), A)
    if mask is not None:
        m = mask[:, None, None]
        A_e = torch.where(m, A_e, A)
        b_e = torch.where(m, b_e, torch.zeros_like(b_e))
        C_e = torch.where(m, C_e, Q)
        e_e = torch.where(m, e_e, torch.zeros_like(e_e))
        J_e = torch.where(m, J_e, torch.zeros_like(J_e))
    return _tb(A_e), _tb(b_e), _tb(C_e), _tb(e_e), _tb(J_e)


def parallel_filter(A, Q, H, R, y, mask=None, chunk=None):
    """Kalman filter over all n steps as one associative scan.

    :param A: (n, s, s) transitions (A[0] = 0: stationary-prior start).
    :param Q: (n, s, s) process noises (Q[0] = P∞).
    :param H: (1, s) observation row.
    :param R: 0-d observation noise variance.
    :param y: (n, dy) observations.
    :param mask: optional (n,) bool; masked steps (False) are pure
        predictions (interleaved test points).
    :param chunk: optional chunk of the three-phase scan
        (:func:`_scan_prefix`); None scans the whole length at once.
    :return: filtered means (n, s, dy), covariances (n, s, s).
    """
    _, b_f, C_f, _, _ = _scan_prefix(filter_elements(A, Q, H, R, y, mask), chunk)
    return _untb(b_f), _untb(C_f)


def filter_nlml(A, Q, H, R, y, means, covs, mask=None):
    """Exact log marginal likelihood from the filtered moments (the sign of
    the JAX package's function: it returns log p(y)).

    One-step predictives m⁻_k = A_k m_{k−1}, P⁻_k = A_k P_{k−1} A_kᵀ + Q_k
    (m₀ = 0 by A[0] = 0):

        log p(y) = −Σ_k Σ_d ½[log 2πS_k + (y_kd − H m⁻_k)² / S_k],
        S_k = H P⁻_k Hᵀ + R.

    Masked steps contribute nothing.
    """
    m_prev = torch.cat([torch.zeros_like(means[:1]), means[:-1]])
    P_prev = torch.cat([torch.zeros_like(covs[:1]), covs[:-1]])
    m_pred = torch.matmul(A, m_prev)
    P_pred = torch.matmul(torch.matmul(A, P_prev), A.transpose(1, 2)) + Q
    mu = torch.matmul(H[None], m_pred)[:, 0, :]
    S = torch.matmul(H[None], torch.matmul(P_pred, H.T[None]))[:, 0, 0] + R
    ll_k = -0.5 * (math.log(2.0 * math.pi) + torch.log(S)[:, None] + (y - mu) ** 2 / S[:, None])
    if mask is not None:
        ll_k = torch.where(mask[:, None], ll_k, torch.zeros_like(ll_k))
    return torch.sum(ll_k)


# -- parallel RTS smoother ---------------------------------------------------


def _smoother_combine(elem_a, elem_b):
    """(E₁,g₁,L₁) ⊗ (E₂,g₂,L₂) = (E₁E₂, E₁g₂+g₁, E₁L₂E₁ᵀ+L₁), ``elem_a``
    earlier in time (S&GF 2020, eq. 13)."""
    E1, g1, L1 = elem_a
    E2, g2, L2 = elem_b
    return _mm(E1, E2), _mv(E1, g2) + g1, _mm(_mm(E1, L2), _t(E1)) + L1


def parallel_smoother(A, Q, means, covs):
    """RTS smoothing of the filtered moments as one reverse scan.

    Element k < n: with P⁻ = A_{k+1} P_k A_{k+1}ᵀ + Q_{k+1},
    E_k = P_k A_{k+1}ᵀ (P⁻)⁻¹, g_k = m_k − E_k A_{k+1} m_k,
    L_k = P_k − E_k P⁻ E_kᵀ; element n: (0, m_n, P_n).

    :return: smoothed means (n, s, dy), covariances (n, s, s).
    """
    A_nxt, Q_nxt, P_k = A[1:], Q[1:], covs[:-1]
    P_pred = torch.matmul(torch.matmul(A_nxt, P_k), A_nxt.transpose(1, 2)) + Q_nxt
    E = torch.matmul(torch.matmul(P_k, A_nxt.transpose(1, 2)), _inv_small(P_pred))
    g = means[:-1] - torch.matmul(E, torch.matmul(A_nxt, means[:-1]))
    L = P_k - torch.matmul(torch.matmul(E, P_pred), E.transpose(1, 2))
    E = torch.cat([E, torch.zeros_like(covs[:1])])
    g = torch.cat([g, means[-1:]])
    L = torch.cat([L, covs[-1:]])
    # a reverse scan composes elems[n-1] ⊗ … ⊗ elems[i]; swapping the
    # operator's arguments keeps "earlier in time" first (still associative)
    _, g_s, L_s = associative_scan(lambda a, b: _smoother_combine(b, a), (_tb(E), _tb(g), _tb(L)), dim=2,
                                   reverse=True)
    return _untb(g_s), _untb(L_s)


# -- assembled entry points --------------------------------------------------


def _sde_from_kernel(kernel, dtype):
    """Kernel -> list of (F, Pinf, H) blocks; raises ``ValueError`` for a
    kernel with no exact state-space form."""
    from .. import kernels as _k

    if isinstance(kernel, _k.Sum):
        return _sde_from_kernel(kernel.kern1, dtype) + _sde_from_kernel(kernel.kern2, dtype)
    ell = getattr(kernel, "length_scales", None)
    var = getattr(kernel, "variance", None)
    if ell is not None:
        ellv = ell.value.reshape(-1)
        if ellv.shape[0] != 1:
            raise ValueError("state-space GP supports 1-D inputs only")
        ellv = ellv[0]
    # Matern12 subclasses Exp: the order of the checks matters
    if isinstance(kernel, _k.Exp):
        return [matern_sde(1, ellv, var.value, dtype)]
    if isinstance(kernel, _k.Matern32):
        return [matern_sde(3, ellv, var.value, dtype)]
    if isinstance(kernel, _k.Matern52):
        return [matern_sde(5, ellv, var.value, dtype)]
    raise ValueError(
        f"kernel {type(kernel).__name__} has no exact state-space form "
        "(supported: Exp/Matern12, Matern32, Matern52, and Sums of those)"
    )


def assemble_sde(kernel, x_sorted):
    """Kernel → discretized SSM at the sorted inputs: (A, Q, H, blocks).

    The one place that encodes the A[0] = 0 / Q[0] = P∞ stationary start
    (dts[0] = 0) and the single- against Sum-kernel routing, so the NLML,
    posterior, sampler and filter all discretize alike."""
    blocks = _sde_from_kernel(kernel, x_sorted.dtype)
    dts = torch.cat([torch.zeros_like(x_sorted[:1]), torch.diff(x_sorted)])
    if len(blocks) == 1:
        F, Pinf, H = blocks[0]
        A, Q = discretize(F, Pinf, dts)
    else:
        _, _, H = stack_sde(blocks)
        A, Q = discretize_blocks(blocks, dts)
    return A, Q, H, blocks


def ssm_nlml(kernel, noise, x_sorted, y_sorted, mask=None, chunk=None):
    """Negative log marginal likelihood, equal to the dense GPR's for the
    same kernel, noise and data, in O(n) work and O(log n) depth.

    :param x_sorted: (n,) ascending inputs.
    :param y_sorted: (n, dy) observations in the same order.
    :param chunk: optional chunk of the three-phase scan for very long
        series (:func:`_scan_prefix`).
    """
    A, Q, H, _ = assemble_sde(kernel, x_sorted)
    R = noise.reshape(()).to(x_sorted.dtype)
    means, covs = parallel_filter(A, Q, H, R, y_sorted, mask, chunk=chunk)
    return -filter_nlml(A, Q, H, R, y_sorted, means, covs, mask)


def ssm_posterior(kernel, noise, x_sorted, y_sorted, mask):
    """Smoothed latent moments at every sorted input; masked entries
    (False) are prediction sites whose y is ignored.  :return: (mean
    (n, dy), var (n,))."""
    A, Q, H, _ = assemble_sde(kernel, x_sorted)
    R = noise.reshape(()).to(x_sorted.dtype)
    means, covs = parallel_filter(A, Q, H, R, y_sorted, mask)
    m_s, P_s = parallel_smoother(A, Q, means, covs)
    f_mean = torch.matmul(H[None], m_s)[:, 0, :]
    f_var = torch.matmul(H[None], torch.matmul(P_s, H.T[None]))[:, 0, 0]
    return f_mean, f_var


# -- joint posterior sampling (simulation smoother) --------------------------


def _prior_combine(elem_a, elem_b):
    """The prefix of x_k = A_k x_{k−1} + w_k:
    (A₁,b₁) ⊗ (A₂,b₂) = (A₂A₁, A₂b₁ + b₂)."""
    A1, b1 = elem_a
    A2, b2 = elem_b
    return _mm(A2, A1), _mv(A2, b1) + b2


def sample_prior_states(A, Q, generator, n_samples, block_sizes=None):
    """Joint prior state trajectories, (n, s, n_samples): every process
    noise w_k ~ N(0, Q_k) at once (closed-form small Cholesky; per block
    for Sum kernels, whose Q is block-diagonal and rounds slightly
    indefinite at tiny gaps), then the linear recurrence as one
    associative scan.  The normals come from ``generator``."""
    n, s = A.shape[0], A.shape[1]
    if block_sizes is not None and len(block_sizes) > 1:
        factors, lo = [], 0
        for k in block_sizes:
            factors.append(_chol_small(Q[:, lo:lo + k, lo:lo + k]))
            lo += k
        Lq = _block_diag(factors)
    else:
        Lq = _chol_small(Q)
    eps = torch.randn((n, s, n_samples), generator=generator, dtype=A.dtype, device=A.device)
    w = torch.matmul(Lq, eps)
    _, x = associative_scan(_prior_combine, (_tb(A), _tb(w)), dim=2)
    return _untb(x)


def ssm_sample_posterior(kernel, noise, x_sorted, y_sorted, mask, generator, n_samples):
    """Joint posterior samples of f at every sorted input, (n_samples, n,
    dy), by the simulation smoother (Durbin & Koopman 2002):
    f_post = f_prior + E[f | Y − Y_prior], with (f_prior, Y_prior) a joint
    draw from the prior SSM with observation noise.  Smoothing is linear in
    y, so every sample and output goes through one filter and smoother as
    stacked columns.  The prior states' normals and the observation
    noise's are two separate draws from ``generator``."""
    n, dy = y_sorted.shape
    A, Q, H, blocks = assemble_sde(kernel, x_sorted)
    R = noise.reshape(()).to(x_sorted.dtype)
    xprior = sample_prior_states(A, Q, generator, n_samples, block_sizes=[F.shape[0] for F, _, _ in blocks])
    f_prior = torch.matmul(H[None], xprior)[:, 0, :]  # (n, S)
    y_prior = f_prior + torch.sqrt(R) * torch.randn(
        f_prior.shape, generator=generator, dtype=f_prior.dtype, device=f_prior.device
    )
    resid = (y_sorted[:, None, :] - y_prior[:, :, None]).reshape(n, n_samples * dy)
    means, covs = parallel_filter(A, Q, H, R, resid, mask)
    m_s, _ = parallel_smoother(A, Q, means, covs)
    delta = torch.matmul(H[None], m_s)[:, 0, :].reshape(n, n_samples, dy)
    return torch.movedim(f_prior[:, :, None] + delta, 1, 0)
