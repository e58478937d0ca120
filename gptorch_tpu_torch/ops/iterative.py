"""Matrix-free iterative exact-GP inference (BBMM).

Counterpart of ``gptorch_tpu/ops/iterative.py`` (Gardner et al. 2018,
"GPyTorch: Blackbox Matrix-Matrix Gaussian Process Inference",
arXiv:1809.11165): exact-GP training as batched preconditioned conjugate
gradients plus stochastic Lanczos quadrature, with the kernel matrix never
stored.

* (K̂ = K + σ²I) acts on blocks of vectors through :func:`radial_mvm`,
  whose product is the hand-written kernel K3 on the card
  (:mod:`~gptorch_tpu_torch.ops.mvm`): O(n·(t + dy)) memory, so one
  card fits n far past the dense factorization's n² buffers.
* mBCG: all right-hand sides ([y | probes]) are solved in one batched CG of
  exactly ``max_iters`` steps with converged columns masked on the device,
  as the JAX package's ``lax.scan`` does (no early exit: that would need a
  host read per step); its per-column Lanczos coefficients give the
  tridiagonal T of each probe.
* logdet by preconditioned SLQ with the rank-k pivoted-Cholesky
  preconditioner P = L Lᵀ + σ²I, whose logdet and inverse are closed-form
  (Woodbury):  logdet K̂ = logdet P + E_z[‖z̃‖²·e₁ᵀ log(T(z)) e₁].
* the gradient is the closed-form low-rank adjoint: with uᵢ = K̂⁻¹zᵢ and
  vᵢ = P⁻¹zᵢ,  ∂NLML/∂θ = ½⟨(dy/t)·Σ uᵢvᵢᵀ − ααᵀ, ∂K/∂θ⟩, one pass of the
  hand-written kernel K4 over recomputed Gram tiles
  (:mod:`~gptorch_tpu_torch.ops.lowrank_contract`).

Every function keeps the JAX package's name and signature (tensors for
arrays).  Loops run in Python with no host read (argmax, masks and
coefficients stay on the device); ``torch.linalg.eigh`` in the SLQ and the
Lanczos factor's Cholesky check their status on the host, once per call.
"""

from __future__ import annotations

import math

import torch

from .gpr_fast import _RADIALS_X, _radial_maps, _scaled
from .lowrank_contract import lowrank_contractions
from .mvm import gram_mvm

__all__ = [
    "radial_mvm",
    "pivoted_cholesky",
    "woodbury_solve",
    "woodbury_logdet",
    "mbcg",
    "lanczos_root_inverse",
    "radial_nlml_iterative",
    "radial_slq_diagnostics",
]


def _reduce_ell(grad_full, log_ell, d):
    """The gradient of ``log_ell`` from the per-coordinate one: summed for a
    scalar length scale (0-d, or (1,) on d > 1 inputs), else as it is."""
    if log_ell.ndim == 0:
        return torch.sum(grad_full)
    if log_ell.shape[0] == 1 and d != 1:
        return torch.sum(grad_full, dim=0, keepdim=True)
    return grad_full


# -- matrix-free MVM -------------------------------------------------------------


class _RadialMVM(torch.autograd.Function):
    """K̂·V with its gradient: ∂/∂V = K̂·g (K3 again), ∂/∂(log ℓ, log σ²,
    log α) from one K4 pass with W = g·Vᵀ, ∂/∂log σ_n² = σ_n²·⟨g, V⟩.  The
    inputs x are data (no gradient)."""

    @staticmethod
    def forward(ctx, kind, log_ell, log_var, log_noise, x, V, jitter, slab, log_extra):
        xs = _scaled(x, log_ell)
        noise = torch.exp(log_noise) + jitter
        ctx.kind, ctx.slab, ctx.jitter = kind, slab, jitter
        ctx.save_for_backward(log_ell, log_var, log_noise, x, V, log_extra)
        return gram_mvm(kind, xs, log_var, noise, V, slab, log_extra)

    @staticmethod
    def backward(ctx, g):
        log_ell, log_var, log_noise, x, V, log_extra = ctx.saved_tensors
        kind, slab = ctx.kind, ctx.slab
        g = g.contiguous()
        xs = _scaled(x, log_ell)
        d_V = None
        if ctx.needs_input_grad[5]:
            d_V = gram_mvm(kind, xs, log_var, torch.exp(log_noise) + ctx.jitter, g, slab, log_extra)
        svar, grad_ell, sextra = lowrank_contractions(kind, xs, torch.exp(log_var), g, V, slab, log_extra)
        d_log_extra = None
        if log_extra is not None:
            d_log_extra = sextra.expand(log_extra.shape).to(log_extra.dtype)
        return (
            None,
            _reduce_ell(grad_ell, log_ell, x.shape[1]),
            svar.reshape(log_var.shape),
            (torch.exp(log_noise) * torch.sum(g * V)).reshape(log_noise.shape),
            None,
            d_V,
            None,
            None,
            d_log_extra,
        )


def radial_mvm(kind, log_ell, log_var, log_noise, x, V, jitter=0.0, slab=2048, log_extra=None):
    """(K + (σ_n² + jitter)·I) @ V without storing K, differentiable in the
    log hyperparameters and V.

    :param V: (n, k) block of vectors.
    :param slab: the plain route's row-slab size (the CPU's; the card's
        kernel streams the whole Gram in tiles of its own).
    :param log_extra: extra scalar hyperparameter for kinds in
        ``_RADIALS_X`` (rq: log α, shape (1,)); omit for classic kinds.
    :return: (n, k).
    """
    return _RadialMVM.apply(kind, log_ell, log_var, log_noise, x, V, jitter, slab, log_extra)


# -- pivoted Cholesky preconditioner ---------------------------------------------


def pivoted_cholesky(kind, log_ell, log_var, x, rank: int, log_extra=None):
    """Rank-``rank`` pivoted (greedy max-diagonal) Cholesky of the NOISELESS
    Gram, matrix-free: one kernel column per step (Harbrecht et al. 2012;
    the GPyTorch preconditioner).  The pivot is chosen by a device-side
    ``argmax`` and gathered by ``index_select``: no host read.  Returns L
    (n, rank) with K ≈ L Lᵀ."""
    n = x.shape[0]
    xs = _scaled(x, log_ell)
    var = torch.exp(log_var)
    xsn = torch.sum(xs * xs, dim=1)
    tiny = torch.finfo(xs.dtype).tiny
    L = xs.new_zeros((n, rank))
    diag = torch.full((n,), 1.0, dtype=xs.dtype, device=xs.device) * var  # radial kernels: diag = σ²
    for i in range(rank):
        j = torch.argmax(diag).reshape(1)
        dj = torch.clamp(diag.index_select(0, j), min=0.0)
        piv = torch.sqrt(torch.clamp(dj, min=tiny))
        xj = xs.index_select(0, j)[0]
        r2 = xsn + torch.sum(xj * xj) - 2.0 * (xs @ xj)
        col = _radial_maps(kind, torch.clamp(r2, min=0.0), var, log_extra)[0]
        newcol = (col - L @ L.index_select(0, j)[0]) / piv
        newcol = torch.where(dj > 0, newcol, 0.0)  # the pivot is exhausted: zeros
        diag = torch.clamp(diag - torch.square(newcol), min=0.0).index_fill(0, j, 0.0)
        L[:, i] = newcol
    return L


def _woodbury_factor(L, noise):
    """The Cholesky factor of noise·I_k + LᵀL (``cholesky_ex``: no host
    check of its status)."""
    k = L.shape[1]
    inner = noise * torch.eye(k, dtype=L.dtype, device=L.device) + L.mT @ L
    return torch.linalg.cholesky_ex(inner)[0]


def _woodbury_apply(L, C, noise, B):
    return (B - L @ torch.cholesky_solve(L.mT @ B, C)) / noise


def woodbury_solve(L, noise, B):
    """(L Lᵀ + noise·I)⁻¹ B via Woodbury for tall-skinny L (n, k):

    = B/noise − L (noise·I_k + LᵀL)⁻¹ (Lᵀ B) / noise
    """
    return _woodbury_apply(L, _woodbury_factor(L, noise), noise, B)


def woodbury_logdet(L, noise, n):
    """logdet(L Lᵀ + noise·I) = n·log noise + logdet(I_k + LᵀL/noise)."""
    k = L.shape[1]
    inner = torch.eye(k, dtype=L.dtype, device=L.device) + (L.mT @ L) / noise
    Lc = torch.linalg.cholesky_ex(inner)[0]
    return n * torch.log(torch.as_tensor(noise, dtype=L.dtype, device=L.device)) + 2.0 * torch.sum(
        torch.log(torch.diagonal(Lc))
    )


def _preconditioner(L, noise):
    """``B -> woodbury_solve(L, noise, B)`` with the k×k factor made once."""
    C = _woodbury_factor(L, noise)
    return lambda B: _woodbury_apply(L, C, noise, B)


# -- LOVE: cached Lanczos root-inverse for constant-time variances ----------------


def lanczos_root_inverse(mvm, q0, rank: int):
    """Rank-``rank`` Lanczos factor R (n, rank) with A⁻¹ ≈ R Rᵀ -- the LOVE
    predictive-variance cache (Pleiss et al. 2018, arXiv:1803.06058).

    Runs ``rank`` Lanczos steps on the matrix-free operator ``mvm`` from
    start vector ``q0``, with full reorthogonalization (two classical
    Gram-Schmidt passes per step, (n, rank) products).  The tridiagonal
    T = QᵀAQ is factored once and R = Q L_T⁻ᵀ returned, so a variance query
    costs one (rank, n)·(n, n*) product instead of a CG solve.  Q is filled
    in place, one column per step.  Breakdown (‖w‖ underflows) leaves zero
    columns that decouple; a tiny diagonal jitter keeps T factorizable.
    """
    n = q0.shape[0]
    dtype = q0.dtype
    tiny = torch.finfo(dtype).tiny
    q0 = q0 / torch.clamp(torch.linalg.norm(q0), min=tiny)
    # rank + 1 columns so the loop can always write v_{j+1}; the extra
    # column is dropped before building R.
    Q = q0.new_zeros((n, rank + 1))
    Q[:, 0] = q0
    alphas = q0.new_zeros((rank,))
    betas = q0.new_zeros((rank,))
    for j in range(rank):
        v = Q[:, j : j + 1]
        w = mvm(v)
        alpha = torch.sum(v * w)
        w = w - alpha * v
        # two-pass classical Gram-Schmidt against all previous vectors
        # (columns beyond j are zero, so the full-buffer product is safe)
        for _ in range(2):
            w = w - Q @ (Q.mT @ w)
        beta = torch.linalg.norm(w)
        Q[:, j + 1 : j + 2] = w / torch.clamp(beta, min=tiny)
        alphas[j] = alpha
        betas[j] = beta
    Q = Q[:, :rank]
    T = torch.diag(alphas) + torch.diag(betas[:-1], 1) + torch.diag(betas[:-1], -1)
    # tiny relative jitter: keeps dead (breakdown) trailing blocks PD without
    # biasing T⁻¹ in the small-eigenvalue (noise-floor) directions
    scale = torch.clamp(torch.max(torch.abs(alphas)), min=tiny)
    T = T + (16 * torch.finfo(dtype).eps * scale) * torch.eye(rank, dtype=dtype, device=q0.device)
    L_T = torch.linalg.cholesky(T)
    return torch.linalg.solve_triangular(L_T, Q.mT, upper=False).mT  # (n, rank)


# -- batched preconditioned CG with Lanczos coefficients --------------------------


def mbcg(mvm, precond, B, max_iters: int, tol: float = 1e-6):
    """Modified batched CG (GPyTorch alg. 2): solve A X = B column-wise with
    preconditioner ``precond`` (callable), collecting per-column Lanczos
    tridiagonal coefficients.  Exactly ``max_iters`` steps; a column stops
    moving once its relative residual is below ``tol`` (masked on the
    device, as the JAX package's ``lax.scan`` does).

    :returns: (X (n, t), alphas (max_iters, t), betas (max_iters, t),
        valid (max_iters, t) mask of iterations actually used).
    """
    t = B.shape[1]
    X = torch.zeros_like(B)
    R = B
    Z = precond(R)
    P = Z
    rz = torch.sum(R * Z, dim=0)
    b_norm = torch.clamp(torch.linalg.norm(B, dim=0), min=1e-30)
    done = torch.zeros((t,), dtype=torch.bool, device=B.device)
    alphas, betas, valid = [], [], []
    for _ in range(max_iters):
        AP = mvm(P)
        pAp = torch.sum(P * AP, dim=0)
        # masked columns keep alpha = 0 (no further updates)
        alpha = torch.where(done | (pAp <= 0), 0.0, rz / torch.where(pAp == 0, 1.0, pAp))
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        Z = precond(R)
        rz_new = torch.sum(R * Z, dim=0)
        beta = torch.where(done | (rz == 0), 0.0, rz_new / torch.where(rz == 0, 1.0, rz))
        P = Z + beta[None, :] * P
        alphas.append(alpha)
        betas.append(beta)
        valid.append(~done)
        done = done | (torch.linalg.norm(R, dim=0) / b_norm < tol)
        rz = rz_new
    return X, torch.stack(alphas), torch.stack(betas), torch.stack(valid)


def _slq_probe_values(alphas, betas, valid, probe_sqnorms):
    """Per-probe SLQ estimates ‖z‖²·e₁ᵀ log(T_i) e₁, with the Lanczos
    tridiagonal of column i

        T_jj    = 1/α_j + β_{j-1}/α_{j-1}     T_j,j+1 = √β_j / α_j

    (β_{-1} = 0); unused steps are padded with an identity block.  One
    batched ``eigh`` over the (t, m, m) stack."""
    m, t = alphas.shape
    a = torch.where(valid & (alphas != 0), alphas, 1.0)
    b = torch.where(valid, betas, 0.0)
    diag = 1.0 / a + torch.cat([a.new_zeros((1, t)), b[:-1] / a[:-1]], dim=0)
    diag = torch.where(valid, diag, 1.0)
    off = torch.sqrt(torch.clamp(b[:-1], min=0.0)) / a[:-1]
    off = torch.where(valid[:-1] & valid[1:], off, 0.0)
    T = torch.diag_embed(diag.mT) + torch.diag_embed(off.mT, 1) + torch.diag_embed(off.mT, -1)
    w, Q = torch.linalg.eigh(T)
    w = torch.clamp(w, min=torch.finfo(w.dtype).tiny)
    return probe_sqnorms * torch.sum(torch.square(Q[:, 0, :]) * torch.log(w), dim=-1)


def lanczos_logdet_quadratic(alphas, betas, valid, probe_sqnorms, n):
    """SLQ estimate of E_z[zᵀ log(Ã) z] from mBCG coefficients, where Ã is
    the preconditioned operator and z the (preconditioner-warped) probes."""
    return torch.mean(_slq_probe_values(alphas, betas, valid, probe_sqnorms))


# -- the full iterative NLML with hand-written adjoint ----------------------------


def _solve_system(kind, log_ell, log_var, log_noise, x, y, probe_seeds, jitter, slab, max_iters, precond_rank,
                  tol, log_extra):
    """The shared forward: the preconditioner, the probes z ~ N(0, P)
    (z = σ̂·s0 + L·s1), and one mBCG over [y | Z]."""
    n = y.shape[0]
    noise = torch.exp(log_noise) + jitter
    Lpc = pivoted_cholesky(kind, log_ell, log_var, x, precond_rank, log_extra)
    precond = _preconditioner(Lpc, noise)
    Z = torch.sqrt(noise) * probe_seeds[:n] + Lpc @ probe_seeds[n:]
    B = torch.cat([y, Z], dim=1)
    X, alphas, betas, valid = mbcg(
        lambda V: radial_mvm(kind, log_ell, log_var, log_noise, x, V, jitter, slab, log_extra),
        precond, B, max_iters, tol,
    )
    return Lpc, noise, precond, Z, B, X, alphas, betas, valid


def _it_fwd_impl(kind, log_ell, log_var, log_noise, x, y, probe_seeds, jitter, slab, probes, max_iters,
                 precond_rank, tol, log_extra):
    n, dy = y.shape
    Lpc, noise, precond, Z, _, X, alphas, betas, valid = _solve_system(
        kind, log_ell, log_var, log_noise, x, y, probe_seeds, jitter, slab, max_iters, precond_rank, tol, log_extra
    )
    A = X[:, :dy]  # K̂⁻¹ Y
    U = X[:, dy:]  # u_i = K̂⁻¹ z_i
    V = precond(Z)  # v_i = P⁻¹ z_i
    # SLQ logdet: logdet K̂ = logdet P + E[‖w‖² e₁ᵀ log T e₁], ‖w‖² = zᵀP⁻¹z
    probe_sqnorms = torch.sum(Z * V, dim=0)
    slq = lanczos_logdet_quadratic(alphas[:, dy:], betas[:, dy:], valid[:, dy:], probe_sqnorms, n)
    logdet = woodbury_logdet(Lpc, noise, n) + slq
    nlml = 0.5 * torch.sum(y * A) + 0.5 * dy * logdet + 0.5 * n * dy * math.log(2.0 * math.pi)
    return nlml, (A, U, V)


def _adjoint_factors(A, U, V):
    """The backward's W = dy·K̂⁻¹ − A Aᵀ ≈ (dy/t)·Σ u_i v_iᵀ − A Aᵀ as the
    factors (Wl, Wr) of W = Wl·Wrᵀ, of rank t + dy."""
    dy, t = A.shape[1], U.shape[1]
    return torch.cat([(dy / t) * U, -A], dim=1), torch.cat([V, A], dim=1)


class _IterativeNLML(torch.autograd.Function):
    """The iterative NLML; its forward runs without autograd and its
    backward is the closed-form low-rank adjoint (one K4 pass)."""

    @staticmethod
    def forward(ctx, kind, log_ell, log_var, log_noise, x, y, probe_seeds, jitter, slab, probes, max_iters,
                precond_rank, tol, log_extra):
        nlml, (A, U, V) = _it_fwd_impl(
            kind, log_ell, log_var, log_noise, x, y, probe_seeds, jitter, slab, probes, max_iters,
            precond_rank, tol, log_extra,
        )
        ctx.kind, ctx.slab = kind, slab
        ctx.save_for_backward(log_ell, log_var, log_noise, x, A, U, V, log_extra)
        return nlml

    @staticmethod
    def backward(ctx, g):
        log_ell, log_var, log_noise, x, A, U, V, log_extra = ctx.saved_tensors
        dy, t = A.shape[1], U.shape[1]
        xs = _scaled(x, log_ell)
        Wl, Wr = _adjoint_factors(A, U, V)
        svar, grad_ell_full, sextra = lowrank_contractions(
            ctx.kind, xs, torch.exp(log_var), Wl, Wr, ctx.slab, log_extra
        )
        tr_kinv = torch.sum(U * V) / t
        d_log_noise = 0.5 * torch.exp(log_noise) * (dy * tr_kinv - torch.sum(torch.square(A)))
        if log_extra.numel():
            d_log_extra = (g * 0.5 * sextra).expand(log_extra.shape).to(log_extra.dtype)
        else:
            d_log_extra = torch.zeros_like(log_extra)
        return (
            None,
            g * _reduce_ell(0.5 * grad_ell_full, log_ell, x.shape[1]),
            (g * 0.5 * svar).reshape(log_var.shape),
            (g * d_log_noise).reshape(log_noise.shape),
            None, None, None, None, None, None, None, None, None,
            d_log_extra,
        )


def radial_nlml_iterative(kind, log_ell, log_var, log_noise, x, y, probe_seeds, jitter=0.0, slab=2048, probes=10,
                          max_iters=100, precond_rank=32, tol=1e-6, log_extra=None):
    """Matrix-free NLML of exact GPR with a radial(-ARD) kernel (the model of
    :func:`~gptorch_tpu_torch.ops.gpr_fast.radial_nlml`, solved by mBCG +
    SLQ instead of a factorization: O(n·(probes + dy)) memory, no n²
    buffer), differentiable in the log hyperparameters.

    :param probe_seeds: (n + precond_rank, probes) standard-normal seeds
        (data; no gradient), warped to N(0, P) inside with the
        pivoted-Cholesky preconditioner P = L Lᵀ + σ̂²I via z = σ̂·s0 + L·s1
        (fixed seeds: a deterministic, smooth objective).
    :param log_extra: rq's log α, shape (1,); omit for classic kinds.
    :returns: 0-d NLML (logdet and trace terms are t-probe SLQ / Hutchinson
        estimates; the data-fit term is exact to CG tolerance).
    """
    if log_extra is None:
        if kind in _RADIALS_X:
            raise ValueError(
                f"kind={kind!r} carries an extra hyperparameter: pass log_extra (rq: log alpha, shape (1,))"
            )
        log_extra = x.new_zeros((0,))
    return _IterativeNLML.apply(
        kind, log_ell, log_var, log_noise, x, y, probe_seeds, jitter, slab, probes, max_iters, precond_rank, tol,
        log_extra,
    )


# -- estimator diagnostics --------------------------------------------------------


@torch.no_grad()
def radial_slq_diagnostics(kind, log_ell, log_var, log_noise, x, y, probe_seeds, jitter=0.0, slab=2048,
                           probes=10, max_iters=100, precond_rank=32, tol=1e-6, log_extra=None):
    """Estimator-quality diagnostics for the iterative NLML.  Returns a dict
    of tensors:

    * ``logdet_estimate`` -- the t-probe logdet used by the NLML,
    * ``logdet_probe_values`` -- (t,) per-probe estimates (logdet P + the
      probe's SLQ value); their spread is the estimator noise,
    * ``logdet_stderr`` -- std/√t of the probe values, the 1σ Monte-Carlo
      error of the logdet estimate,
    * ``nlml_stderr`` -- that, in NLML units (× dy/2),
    * ``cg_iters`` -- (dy + t,) CG iterations used per right-hand side,
    * ``cg_relres`` -- (dy + t,) final relative residuals ‖K̂x − b‖/‖b‖
      (exactly computed with one extra MVM).
    """
    if log_extra is None and kind in _RADIALS_X:
        raise ValueError(f"kind={kind!r} requires log_extra")
    n, dy = y.shape
    Lpc, noise, precond, Z, B, X, alphas, betas, valid = _solve_system(
        kind, log_ell, log_var, log_noise, x, y, probe_seeds, jitter, slab, max_iters, precond_rank, tol, log_extra
    )
    R = B - radial_mvm(kind, log_ell, log_var, log_noise, x, X, jitter, slab, log_extra)
    relres = torch.linalg.norm(R, dim=0) / torch.clamp(torch.linalg.norm(B, dim=0), min=1e-30)
    probe_sqnorms = torch.sum(Z * precond(Z), dim=0)
    vals = _slq_probe_values(alphas[:, dy:], betas[:, dy:], valid[:, dy:], probe_sqnorms)
    logdet_p = woodbury_logdet(Lpc, noise, n)
    stderr = torch.std(vals, correction=0) / math.sqrt(vals.shape[0])
    return {
        "logdet_estimate": logdet_p + torch.mean(vals),
        "logdet_probe_values": logdet_p + vals,
        "logdet_stderr": stderr,
        "nlml_stderr": 0.5 * dy * stderr,
        "cg_iters": torch.sum(valid, dim=0),
        "cg_relres": relres,
    }
