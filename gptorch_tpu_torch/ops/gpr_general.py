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
since the first drops L.  Both evaluate the modules at the parameter
tensors the autograd function is given, so under ``torch.func.vmap`` its
rule runs the mapped members one after the other, as
:mod:`~gptorch_tpu_torch.ops.gpr_fast`'s does.

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

from ..module import call_with_parameters
from .blocked import _cholesky_into, _solve_lower, _solve_lower_t, blocked_trtri, tril_square_rec
from .gpr_fast import _Held, _member


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


def _parameter_slots(kernel, mean):
    """Every parameter tensor of ``kernel`` and ``mean`` once (one shared by
    two names or modules counts once), and for each module the (name,
    index) of its parameters in that list: how the autograd functions below
    stand the tensors they are given in for the modules' parameters."""
    tensors, index, slots = [], {}, []
    for module in (kernel, mean):
        own = []
        for name, t in module.named_parameters():
            if id(t) not in index:
                index[id(t)] = len(tensors)
                tensors.append(t)
            own.append((name, index[id(t)]))
        slots.append(tuple(own))
    return tensors, tuple(slots)


def _modules_at(kernel, mean, slots, params):
    """``kernel`` and ``mean`` evaluated at ``params`` (see
    :func:`_parameter_slots`)."""
    return tuple(_ModuleAt(m, {name: params[i] for name, i in own}) for m, own in zip((kernel, mean), slots))


def _general_backward(ctx, g):
    """The streamed adjoint (module docstring) of either autograd function
    below: gradients of the noise and of the parameter tensors, those that
    require a gradient."""
    noise, x, y, *params = ctx.saved_tensors
    nb, alpha = ctx.nb, ctx.alpha
    kernel, mean = _modules_at(*ctx.modules, params)
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

    wanted = [i for i, p in enumerate(params) if p.requires_grad]
    grads = [torch.zeros_like(p) for p in params]

    def accumulate(out, cotangent):
        if not out.requires_grad:
            return
        found = torch.autograd.grad(out, [params[i] for i in wanted], grad_outputs=cotangent, allow_unused=True)
        for i, gp in zip(wanted, found):
            if gp is not None:
                grads[i].add_(gp)

    with torch.enable_grad():
        accumulate(mean(x), -g * A)
        for lo, hi in _chunk_bounds(n, chunk_rows(kernel, x)):
            W_c = dy * Kinv[lo:hi] - A[lo:hi] @ A.mT
            accumulate(kernel.K(x[lo:hi], x), (0.5 * g) * W_c)
    tr_W = dy * torch.trace(Kinv) - torch.sum(torch.square(A))
    d_noise = (g * 0.5 * tr_W).reshape(noise.shape).to(noise.dtype)
    return d_noise, grads


def _general_context(ctx, kernel, mean, slots, jitter, nb, rel_jitter, precision, noise, x, y, params, L, alpha):
    ctx.config = (jitter, rel_jitter, precision)
    ctx.nb = nb
    ctx.modules = (kernel, mean, slots)
    ctx.L, ctx.alpha = L, alpha  # intermediates: the backward drops L before K⁻¹ exists
    ctx.save_for_backward(noise, x, y, *params)


class _GeneralNLMLCore(torch.autograd.Function):
    """The fused NLML for calls under ``torch.func`` transforms: the
    ``setup_context`` form, whose ``vmap`` rule runs the mapped members one
    after the other through this function."""

    @staticmethod
    def forward(kernel, mean, slots, jitter, nb, rel_jitter, precision, held, noise, x, y, *params):
        kernel_at, mean_at = _modules_at(kernel, mean, slots, params)
        nlml, L, alpha = _fwd_impl(kernel_at, mean_at, noise, x, y, jitter, nb, rel_jitter, precision)
        held.value = (L, alpha)
        return nlml

    @staticmethod
    def setup_context(ctx, inputs, output):
        *config, held, noise, x, y = inputs[:11]
        L, alpha = held.value  # read at every level of nested transforms
        _general_context(ctx, *config, noise, x, y, inputs[11:], L, alpha)

    @staticmethod
    def backward(ctx, g):
        d_noise, grads = _general_backward(ctx, g)
        return (None,) * 8 + (d_noise, None, None, *grads)

    @staticmethod
    def vmap(info, in_dims, *args):
        members = [_GeneralNLMLCore.apply(*_member(args, in_dims, b)) for b in range(info.batch_size)]
        return torch.stack(members), 0


class _GeneralNLMLCoreEager(torch.autograd.Function):
    """:class:`_GeneralNLMLCore` in the ``ctx`` form, for calls outside
    ``torch.func`` transforms (the ``setup_context`` form binds its
    arguments by ``inspect.signature`` on every call)."""

    @staticmethod
    def forward(ctx, kernel, mean, slots, jitter, nb, rel_jitter, precision, noise, x, y, *params):
        kernel_at, mean_at = _modules_at(kernel, mean, slots, params)
        nlml, L, alpha = _fwd_impl(kernel_at, mean_at, noise, x, y, jitter, nb, rel_jitter, precision)
        _general_context(ctx, kernel, mean, slots, jitter, nb, rel_jitter, precision, noise, x, y, params, L, alpha)
        return nlml

    @staticmethod
    def backward(ctx, g):
        d_noise, grads = _general_backward(ctx, g)
        return (None,) * 7 + (d_noise, None, None, *grads)


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
    params, slots = _parameter_slots(kernel, mean)
    config = (kernel, mean, slots, jitter, nb, rel_jitter, precision)
    if torch._C._are_functorch_transforms_active():  # vmap, grad, ...: the form with a vmap rule
        return _GeneralNLMLCore.apply(*config, _Held(), noise, x, y, *params)
    return _GeneralNLMLCoreEager.apply(*config, noise, x, y, *params)
