"""Kernel expectations (ψ-statistics) under Gaussian input uncertainty.

Counterpart of ``gptorch_tpu/ekernels.py``.  For q(x_i) = N(μ_i, S_i), with
S_i diagonal (n, q) or full (n, q, q):

    ψ₀ = <K_xx>        (eKxx,     per-datum values)
    ψ₁ = <K_xz>        (eKxz,     n × m)
    ψ₂ = <K_zx K_xz>   (eKzxKxz,  m × m summed over data, or n × m × m)

and the moment-matched prediction of a sparse or exact GP at uncertain
inputs (:func:`uncertain_conditional`, :func:`uncertain_predict`).

The JAX package sums ψ₂ over data by a ``lax.scan`` of one (m, m) term per
datum.  Eager torch would pay a dozen launches per datum for that, so here
the per-datum terms are built for row chunks at once, (c, m, m) at a time,
and each chunk's sum is added to the total: memory stays at one chunk's
temporaries, and the sum's order differs from the scan's only by rounding.
``sum=False`` and :func:`uncertain_conditional` take the same row chunks.
:class:`Rbf` subclasses the port's :class:`~gptorch_tpu_torch.kernels.Rbf`,
so its ``K`` is the hand-written Gram kernel on the card; the expectations
are plain torch on every device, as they are plain XLA in the JAX package.
"""

from __future__ import annotations

import math

import torch

from . import kernels as _kernels
from . import mean_functions as _means
from .functions import _chol_raw
from .util import as_array

#: Most elements of one (c, m, m) chunk of ψ₂'s per-datum terms (2²⁶:
#: 256 MB in float32), on every device.
_CHUNK_ELEMENTS = 2 ** 26


def _row_chunks(n, m):
    """Row ranges (lo, hi) covering n data with at most one chunk's worth
    of (m, m) terms each."""
    rows = max(1, _CHUNK_ELEMENTS // max(m * m, 1))
    return [(lo, min(lo + rows, n)) for lo in range(0, n, rows)]


def _cov_value(Xcov, like):
    """A Param's value, or an array-like as a tensor of ``like``'s dtype
    and device (the reference passes Xcov as a Param)."""
    if hasattr(Xcov, "value"):
        return Xcov.value
    return as_array(Xcov, dtype=like.dtype, device=like.device)


def _chunked_sum(per_rows, n, m, total):
    """Σ over row chunks of ``per_rows(lo, hi)`` ((c, m, m) terms) when
    ``total``, else the (n, m, m) terms."""
    chunks = _row_chunks(n, m)
    if total:
        out = None
        for lo, hi in chunks:
            part = per_rows(lo, hi).sum(dim=0)
            out = part if out is None else out + part
        return out
    parts = [per_rows(lo, hi) for lo, hi in chunks]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _scaled_sqdist(Z1):
    """(m, m) squared distances between the rows of Z1 by the norm identity,
    as the JAX package forms them."""
    z1_2 = torch.sum(torch.square(Z1), dim=1)
    return z1_2[:, None] + z1_2[None, :] - 2.0 * (Z1 @ Z1.T)


class Rbf(_kernels.Rbf):
    """RBF kernel with closed-form ψ-statistics.

    Shapes: Z (m, q), Xmean (n, q), Xcov (n, q) diagonal or (n, q, q) full
    covariances."""

    def eKxx(self, X, Xcov=None, requires_transform=False):
        """ψ₀ per datum = σ² (independent of Xcov, which is accepted so
        that every ψ-kernel takes the same arguments)."""
        return self.Kdiag(X)

    def eKxz(self, Z, Xmean, Xcov, requires_transform=False):
        """ψ₁ = <K_xz>_q(X), shape (n, m).

        Diagonal Xcov (n, q):

            ψ₁[i,k] = σ² Π_q (1 + s_iq/ℓ_q²)^(-½)
                         exp(-½ Σ_q (μ_iq - z_kq)² / (ℓ_q² + s_iq))

        Full Xcov (n, q, q), by batched Cholesky factors of Λ + S_i:

            ψ₁[i,k] = σ² (|Λ| / |Λ + S_i|)^(½)
                         exp(-½ (μ_i - z_k)ᵀ (Λ + S_i)⁻¹ (μ_i - z_k))
        """
        Xcov = _cov_value(Xcov, Xmean)
        ell2 = torch.square(self.length_scales.value)
        variance = self.variance.value.reshape(())

        if Xcov.ndim == 3:
            q = Xmean.shape[1]
            lam = ell2.expand(q)
            half_logdet_lam = 0.5 * torch.sum(torch.log(lam))
            W = _chol_raw(Xcov + torch.diag_embed(lam), blocked=False)  # (n, q, q)
            diff = (Z[None, :, :] - Xmean[:, None, :]).transpose(-1, -2)  # (n, q, m)
            b = torch.linalg.solve_triangular(W, diff, upper=False)
            quad = torch.sum(torch.square(b), dim=-2)  # (n, m)
            half_logdet_c = torch.sum(torch.log(torch.diagonal(W, dim1=-2, dim2=-1)), dim=-1)
            return variance * torch.exp(-0.5 * quad + half_logdet_lam - half_logdet_c[:, None])

        denom = ell2 + Xcov  # (n, q)
        diff2 = torch.square(Xmean[:, None, :] - Z[None, :, :])  # (n, m, q)
        expo = -0.5 * torch.sum(diff2 / denom[:, None, :], dim=-1)
        half_logdet = 0.5 * torch.sum(torch.log1p(Xcov / ell2), dim=-1)  # (n,)
        return variance * torch.exp(expo - half_logdet[:, None])

    eKxz_parallel = eKxz

    def eKzxKxz(self, Z, Xmean, Xcov, requires_transform=False, sum=True):
        """ψ₂ = <K_zx K_xz>_q(X).

        With z̄ = (z_k + z_l)/2 and d_iq = ℓ_q² + 2 s_iq:

        ψ₂[i,k,l] = σ⁴ Π_q (1 + 2 s_iq/ℓ_q²)^(-½)
                       exp(-Σ_q (z_kq - z_lq)²/(4 ℓ_q²)
                           -Σ_q (μ_iq - z̄_q)² / d_iq)

        Full Xcov (n, q, q), with C_i = S_i + Λ/2:

        ψ₂[i,k,l] = σ⁴ (|Λ| / (2^q |C_i|))^(½)
                       exp(-(z_k - z_l)ᵀΛ⁻¹(z_k - z_l)/4
                           -½ (z̄ - μ_i)ᵀ C_i⁻¹ (z̄ - μ_i))

        Returns (m, m) summed over data if ``sum`` else (n, m, m); either
        way the per-datum terms are formed one row chunk at a time.
        """
        Xcov = _cov_value(Xcov, Xmean)
        if Xcov.ndim == 3:
            return self._eKzxKxz_general(Z, Xmean, Xcov, sum=sum)
        ell = self.length_scales.value
        ell2 = torch.square(ell)
        var2 = torch.square(self.variance.value.reshape(()))
        shared = _scaled_sqdist(Z / ell)  # (m, m): scaled squared distances between inducing points

        def per_rows(lo, hi):
            mu, s = Xmean[lo:hi], Xcov[lo:hi]
            root = torch.sqrt(ell2 + 2.0 * s)  # (c, q)
            mu_t = mu / root
            Zi = Z[None, :, :] / root[:, None, :]  # (c, m, q)
            zi_2 = torch.sum(torch.square(Zi), dim=-1)  # (c, m)
            G = Zi @ Zi.transpose(-1, -2)  # (c, m, m)
            mz = (Zi @ mu_t[:, :, None])[..., 0]  # (c, m)
            logdet = torch.sum(torch.log1p(2.0 * s / ell2), dim=-1)  # (c,)
            expo = (
                -0.25 * shared
                - torch.sum(torch.square(mu_t), dim=-1)[:, None, None]
                - 0.25 * (zi_2[:, :, None] + zi_2[:, None, :] + 2.0 * G)
                + mz[:, :, None]
                + mz[:, None, :]
                - 0.5 * logdet[:, None, None]
            )
            return torch.exp(expo) * var2

        return _chunked_sum(per_rows, Xmean.shape[0], Z.shape[0], sum)

    def _eKzxKxz_general(self, Z, Xmean, Xcov, sum=True):
        """ψ₂ for full per-datum covariances S_i (n, q, q); see eKzxKxz."""
        q = Xmean.shape[1]
        ell2 = torch.square(self.length_scales.value).expand(q)
        var2 = torch.square(self.variance.value.reshape(()))
        shared = 0.25 * _scaled_sqdist(Z / torch.sqrt(ell2))  # (z_k - z_l)ᵀ Λ⁻¹ (z_k - z_l) / 4
        half_logdet_lam = 0.5 * torch.sum(torch.log(ell2))
        half_q_log2 = 0.5 * q * math.log(2.0)
        half_lam = torch.diag_embed(0.5 * ell2)

        def per_rows(lo, hi):
            W = _chol_raw(Xcov[lo:hi] + half_lam, blocked=False)  # (c, q, q)
            diff = (Z[None, :, :] - Xmean[lo:hi, None, :]).transpose(-1, -2)  # (c, q, m)
            b = torch.linalg.solve_triangular(W, diff, upper=False)  # W⁻¹(z_k - μ)
            bn = torch.sum(torch.square(b), dim=-2)  # (c, m)
            G = b.transpose(-1, -2) @ b  # (c, m, m)
            # ‖(b_k + b_l)/2‖² = (bn_k + bn_l + 2 G_kl)/4
            quad = 0.25 * (bn[:, :, None] + bn[:, None, :] + 2.0 * G)
            half_logdet_c = torch.sum(torch.log(torch.diagonal(W, dim1=-2, dim2=-1)), dim=-1)
            return var2 * torch.exp(
                -shared - 0.5 * quad + (half_logdet_lam - half_q_log2 - half_logdet_c)[:, None, None]
            )

        return _chunked_sum(per_rows, Xmean.shape[0], Z.shape[0], sum)


class Linear(_kernels.Linear):
    """Linear kernel ψ-statistics for k(x, x') = Σ_q v_q x_q x'_q."""

    def eKxx(self, Xmean, Xcov=None, requires_transform=False):
        """<k(x,x)> = Σ_q v_q (μ_q² + s_q), shape (n,).  Full Xcov
        (n, q, q): s_q = diag(S_i)."""
        v = self.variance.value
        if Xcov is None:
            return torch.sum(torch.square(Xmean) * v, dim=-1)
        Xcov = _cov_value(Xcov, Xmean)
        if Xcov.ndim == 3:
            Xcov = torch.diagonal(Xcov, dim1=-2, dim2=-1)
        return torch.sum((torch.square(Xmean) + Xcov) * v, dim=-1)

    def eKxz(self, Z, Xmean, Xcov=None, requires_transform=False):
        """<K_xz> = μ diag(v) Zᵀ, shape (n, m) -- independent of Xcov."""
        return (Xmean * self.variance.value) @ Z.T

    def eKzxKxz(self, Z, Xmean, Xcov, requires_transform=False, sum=True):
        """<K_zx K_xz>[i] = Z diag(v) (μ_i μ_iᵀ + S_i) diag(v) Zᵀ.

        Xcov diagonal (n, q) or full (n, q, q)."""
        Xcov = _cov_value(Xcov, Xmean)
        Zv = Z * self.variance.value  # (m, q)
        A = Xmean @ Zv.T  # (n, m): μ_iᵀ diag(v) z_k
        full = Xcov.ndim == 3
        if sum:
            # Σ_i [A_i A_iᵀ + Zv S_i Zvᵀ]
            second = Zv @ Xcov.sum(dim=0) @ Zv.T if full else (Zv * Xcov.sum(dim=0)) @ Zv.T
            return A.T @ A + second
        outer = A[:, :, None] * A[:, None, :]
        if full:
            return outer + Zv @ Xcov @ Zv.T
        return outer + (Zv[None, :, :] * Xcov[:, None, :]) @ Zv.T


def uncertain_conditional(kernel, z, w, G, x_mean, x_var):
    """Moment-matched posterior of a sparse GP at uncertain inputs
    x* ~ N(x_mean, x_var) (Girard et al. 2003).

    Every inducing-point posterior conditions as

        f*(x) | data  ~  N(k(x, Z) w,  k(x, x) - k(x, Z) G k(Z, x))

    for a weight matrix ``w`` (m, p) and a symmetric ``G`` (m, m) (the
    models' ``_uncertain_wG``).  Integrating the moments over x* needs only
    the kernel's ψ-statistics:

        mean_j = ψ₁ w_j
        var_j  = ψ₀ - tr(G Ψ₂) + w_jᵀ Ψ₂ w_j - mean_j²

    Ψ₂ (n*, m, m) is formed one row chunk at a time and contracted there,
    ``((Ψ₂ w) ⊙ w)`` summed over m, so no (n*, m, m, p) temporary and no
    whole (n*, m, m) tensor exists.

    :param x_var: (n*, q) diagonal or (n*, q, q) full input covariances.
    :return: (mean (n*, p), var (n*, p)).
    """
    if not hasattr(kernel, "eKxz"):
        raise TypeError(
            "uncertain-input prediction needs a kernel with ψ-statistics "
            "(gptorch_tpu_torch.ekernels.Rbf / .Linear); got "
            f"{type(kernel).__module__}.{type(kernel).__name__}"
        )
    x_mean = as_array(x_mean, dtype=z.dtype, device=z.device)
    x_var = as_array(x_var, dtype=z.dtype, device=z.device)
    psi0 = kernel.eKxx(x_mean, x_var)
    mean = kernel.eKxz(z, x_mean, x_var) @ w  # (n*, p)

    tr_terms, seconds = [], []
    for lo, hi in _row_chunks(x_mean.shape[0], z.shape[0]):
        psi2 = kernel.eKzxKxz(z, x_mean[lo:hi], x_var[lo:hi], sum=False)  # (c, m, m)
        tr_terms.append(torch.sum(psi2 * G, dim=(-2, -1)))
        seconds.append(torch.sum((psi2 @ w) * w, dim=-2))
    tr_term, second = torch.cat(tr_terms), torch.cat(seconds)
    var = psi0[:, None] - tr_term[:, None] + second - torch.square(mean)
    return mean, var


def uncertain_predict(kernel, mean_function, z, w, G, x_mean, x_var):
    """:func:`uncertain_conditional` plus the mean function's part: Zero
    adds nothing, Constant shifts the mean, anything else has no closed
    form under input uncertainty and raises."""
    mean, var = uncertain_conditional(kernel, z, w, G, x_mean, x_var)
    if not isinstance(mean_function, _means.Zero):
        if type(mean_function) is _means.Constant:
            mean = mean + mean_function(as_array(x_mean, dtype=z.dtype, device=z.device))
        else:
            raise NotImplementedError(
                "predict_uncertain supports Zero/Constant mean functions "
                "(E[m(x*)] has no closed form for "
                f"{type(mean_function).__name__} under input uncertainty)"
            )
    return mean, var
