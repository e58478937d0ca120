"""Fused exact-GPR NLML with a closed-form backward for any kernel.

Counterpart of ``gptorch_tpu/ops/gpr_general.py``: the memory discipline of
:mod:`~gptorch_tpu_torch.ops.gpr_fast` for any kernel (composites such as
``Linear + Rbf + Constant``, Sum/Product algebra) and any trainable mean
function.  The hand-derived radial contraction is replaced by
``torch.autograd.grad`` of ``kernel.K`` over row chunks:

    forward:  K   = kernel.K(X) + (σ_n² + jitter + rel)·I
              L   = blocked_cholesky(K),  r = Y − mean(X),  α = L⁻¹ r
              NLML = ½‖α‖² + dy·Σ log diag L + ½·n·dy·log 2π

    backward: A    = L⁻ᵀ α = K⁻¹ r,  K⁻¹ = tril_square_rec(blocked_trtri(L))
              W    = dy·K⁻¹ − A Aᵀ
              ∂NLML/∂θ_kernel = ½⟨W, ∂K/∂θ⟩, summed over row chunks R: the
                  (cs, n) rows K(X_R, X) are rebuilt per chunk and
                  differentiated against the cotangent ½·W_R, with cs
                  sized by the kernel's saved temporaries (:func:`chunk_rows`)
              ∂NLML/∂mean(X)  = −A
              ∂NLML/∂σ_n²     = ½(dy·tr K⁻¹ − ‖A‖²)

The noise enters as the constrained variance and the kernel and mean as
modules, so their bijectors differentiate outside this function.  On the
card an ``Rbf`` term goes through the hand-written Gram kernel and its
backward (:mod:`~gptorch_tpu_torch.ops.gram`).

The backward reads the kernel's and the mean's parameters as they were in
the forward (the tensors a ``functional_call`` stood in, say), and may run
more than once (``retain_graph``, ``gradcheck``): a second run refactors K,
since the first drops L.

Restriction, as in the JAX package: no :class:`~gptorch_tpu_torch.kernels.White`
component (its cross-covariance K(X_R, X) is zeros, so the row rebuild would
drop its diagonal); :class:`~gptorch_tpu_torch.models.gpr.GPR` routes such
kernels to autograd.  ``jitter`` and the relative floor
``rel_jitter·mean(Kdiag(X))`` are constants in the adjoint; x and y get no
gradient.
"""

from __future__ import annotations

import math

import torch

from ..module import call_with_parameters, trainable_parameters
from .blocked import _cholesky_into, _solve_lower, _solve_lower_t, blocked_trtri, tril_square_rec


def _chunk_bounds(n: int, target: int = 4096):
    """(lo, hi) row-chunk bounds covering [0, n)."""
    return [(lo, min(n, lo + target)) for lo in range(0, n, target)]


#: Rows of one probe of :func:`chunk_rows`.
_PROBE_ROWS = 8


def chunk_rows(kernel, x) -> int:
    """Rows per chunk of the backward's rebuild of K(X_R, X), sized by the
    kernel: autograd keeps a kernel's temporaries for the VJP (one or two
    (rows, n) tensors for a radial kernel, several per mixture component
    and input dimension for SpectralMixture), so the bytes it saves for a
    probe of ``_PROBE_ROWS`` rows set the chunk.  A chunk saves at most
    max(2·n²·itemsize, 256 MiB) -- two n² buffers, beside the K⁻¹ the
    backward holds -- and has between 1 and 4096 rows (the JAX package's
    chunk)."""
    n = x.shape[0]
    saved = 0

    def pack(t):
        nonlocal saved
        saved += t.numel() * t.element_size()
        return t

    with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        kernel.K(x[:_PROBE_ROWS], x)
    per_row = saved / min(n, _PROBE_ROWS)
    budget = max(2 * n * n * x.element_size(), 2 ** 28)
    return int(min(4096, max(1, budget // max(per_row, 1.0))))


def _fwd_impl(kernel, mean, noise, x, y, jitter, nb, rel_jitter, precision):
    n, dy = y.shape
    rel = rel_jitter * torch.mean(kernel.Kdiag(x)) if rel_jitter else 0.0
    K = kernel.K(x).contiguous()  # a buffer of our own, factored in place
    K.diagonal().add_(noise + jitter + rel)
    L = _cholesky_into(K, nb, lower_only=True, precision=precision)
    alpha = _solve_lower(L, y - mean(x))
    nlml = (
        0.5 * torch.sum(torch.square(alpha))
        + dy * torch.sum(torch.log(torch.diagonal(L)))
        + 0.5 * n * dy * math.log(2.0 * math.pi)
    )
    return nlml, L, alpha


class _ModuleAt:
    """A kernel or mean function evaluated at given parameter tensors:
    ``K``/``Kdiag`` (a kernel) or a call (a mean) through
    :func:`~gptorch_tpu_torch.module.call_with_parameters`."""

    def __init__(self, module, tensors):
        self.module, self.tensors = module, tensors

    def __call__(self, x):
        return call_with_parameters(self.module, self.tensors, "forward", x)

    def K(self, *args):
        return call_with_parameters(self.module, self.tensors, "K", *args)

    def Kdiag(self, *args):
        return call_with_parameters(self.module, self.tensors, "Kdiag", *args)


class _GeneralNLMLCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, mean, jitter, nb, rel_jitter, precision, noise, x, y, *params):
        nlml, L, alpha = _fwd_impl(kernel, mean, noise, x, y, jitter, nb, rel_jitter, precision)
        ctx.config = (jitter, rel_jitter, precision)
        ctx.nb = nb
        # the modules with the parameter tensors this forward read
        ctx.kernel = (kernel, dict(kernel.named_parameters()))
        ctx.mean = (mean, dict(mean.named_parameters()))
        ctx.params = params  # identify the leaves that kernel.K and mean read
        ctx.L = L  # an intermediate, dropped by the backward before K⁻¹ exists
        ctx.save_for_backward(noise, x, y, alpha)
        return nlml

    @staticmethod
    def backward(ctx, g):
        noise, x, y, alpha = ctx.saved_tensors
        params, nb = ctx.params, ctx.nb
        kernel, mean = _ModuleAt(*ctx.kernel), _ModuleAt(*ctx.mean)
        L, ctx.L = ctx.L, None
        if L is None:  # a second backward: refactor
            jitter, rel_jitter, precision = ctx.config
            _, L, _ = _fwd_impl(kernel, mean, noise, x, y, jitter, nb, rel_jitter, precision)
        n, dy = y.shape
        A = _solve_lower_t(L, alpha)  # K⁻¹ (Y − m(X))
        Linv = blocked_trtri(L, min(nb, 1024))
        del L
        Kinv = tril_square_rec(Linv, min(nb, 512), 4096)
        del Linv

        grads = [torch.zeros_like(p) for p in params]

        def accumulate(out, cotangent):
            if not out.requires_grad:
                return
            found = torch.autograd.grad(out, params, grad_outputs=cotangent, allow_unused=True)
            for acc, gp in zip(grads, found):
                if gp is not None:
                    acc.add_(gp)

        with torch.enable_grad():
            accumulate(mean(x), -g * A)
            for lo, hi in _chunk_bounds(n, chunk_rows(kernel, x)):
                W_c = dy * Kinv[lo:hi] - A[lo:hi] @ A.mT
                accumulate(kernel.K(x[lo:hi], x), (0.5 * g) * W_c)
        tr_W = dy * torch.trace(Kinv) - torch.sum(torch.square(A))
        d_noise = (g * 0.5 * tr_W).reshape(noise.shape).to(noise.dtype)
        return (None,) * 6 + (d_noise, None, None, *grads)


def general_nlml(kernel, mean, noise, x, y, jitter=0.0, nb=1024, rel_jitter=0.0,
                 precision="highest"):
    """Negative log marginal likelihood of exact GPR for any kernel module
    and mean-function module, with the streamed closed-form adjoint.

    :param kernel: a :class:`~gptorch_tpu_torch.kernels.Kernel` (no White
        component -- see the module docstring).
    :param mean: mean-function module, called as ``mean(x) -> (n, dy)``.
    :param noise: constrained Gaussian noise variance, 0-d.
    :param x: (n, d) inputs.  :param y: (n, dy) targets (neither gets a
        gradient).
    :param jitter: absolute diagonal jitter.
    :param nb: panel size of the blocked factorizations.
    :param rel_jitter: relative jitter, scaled by ``mean(Kdiag(x))``.
    :param precision: "highest" or "default"; kept for signature parity and
        mapped to nothing (TF32 is pinned off on the card, so every
        float32 product is a full float32 product).
    """
    if precision not in ("highest", "default"):
        raise ValueError("precision must be 'highest' or 'default'")
    return _GeneralNLMLCore.apply(
        kernel, mean, jitter, nb, rel_jitter, precision, noise, x, y, *trainable_parameters(kernel, mean)
    )
