"""Fused exact-GPR NLML with a closed-form backward (radial kernel family).

Counterpart of ``gptorch_tpu/ops/gpr_fast.py``.  Autograd through a
Cholesky keeps O(n²) residuals per operation; this op computes the same
value and gradient with a hand-written adjoint that stores two n² buffers
at most and runs on the blocked factorizations of
:mod:`~gptorch_tpu_torch.ops.blocked`.

Kinds: ``rbf``, ``matern12`` (= Exp), ``matern32``, ``matern52`` and ``rq``
(RationalQuadratic, whose log α comes in as ``log_extra``); r² is taken on
the length-scale-scaled inputs x̃ = x/ℓ.

forward:   K = σ²·f(r_ij) + (σ_n² + jitter + rel_jitter·σ²)·I
           L = blocked_cholesky(K),  α = L⁻¹ Y
           NLML = ½‖α‖² + dy·Σlog diag L + ½·n·dy·log 2π

backward (hyperparameter gradients only; x, y are data, which
:class:`~gptorch_tpu_torch.models.gpr.GPR` detaches):
           K⁻¹ = tril_square_rec(blocked_trtri(L)),  A = L⁻ᵀ α (= K⁻¹ Y)
           W   = dy·K⁻¹ − A Aᵀ                 (∂NLML/∂θ = ½⟨W, ∂K/∂θ⟩)
           ∂/∂log σ²   = ½ Σ W ⊙ G
           ∂/∂log ℓ_q  = Σᵢ rowsum(M)ᵢ·x̃²ᵢq − Σᵢ x̃ᵢq·(M x̃)ᵢq,  M = W ⊙ E
           ∂/∂log σ_n² = ½ σ_n²·(dy·tr K⁻¹ − ‖A‖²)
           ∂/∂log α    = ½ Σ W ⊙ F          (rq)

with G the noiseless Gram and E, F the radial maps of :data:`_RADIALS` /
:data:`_RADIALS_X`.  The contractions are :func:`radial_contractions`.

On the card the noisy Gram of ``rbf`` is the hand-written kernel of
:mod:`~gptorch_tpu_torch.ops.gram` (K1) and the contractions are the one of
:mod:`~gptorch_tpu_torch.ops.contract` (K2) for every kind; the other
kinds' Grams are plain torch, as they are plain XLA in the JAX package.
The JAX package's environment switches (``GPTORCH_TPU_PALLAS_GRAM``,
``_FWD_SOLVE``, ``_BWD_A``) are not ported: this module takes their
default branches.

Memory: the forward factors its own Gram in place (peak ≈ one n² buffer
plus the panel temporaries); the backward frees L once K⁻¹'s factor L⁻¹
exists, and L⁻¹ once K⁻¹ exists (peak ≈ 2 n²).

Under ``torch.func`` transforms (``vmap`` over chains or models) the loss
is an autograd function in the ``setup_context`` form whose ``vmap`` rule
runs the mapped members one after the other; eager calls take its
``ctx``-form twin.  The relative jitter is a
numerical device, not part of the model: it is a constant in the adjoint
and adds no gradient to log σ².
"""

from __future__ import annotations

import math

import torch

from .blocked import _cholesky_into, _solve_lower_t, blocked_ltrsm, blocked_trtri, tril_square_rec
from .contract import radial_contractions
from .gram import rbf_gram

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)


def _r_floor(dtype):
    """Clamp floor before a sqrt: the dtype's smallest normal number (1e-40
    is subnormal in float32 and NaNs gradients), at least 1e-40."""
    return max(1e-40, float(torch.finfo(dtype).tiny))


def _radial_rbf(r2, var):
    G = var * torch.exp(-0.5 * r2)
    return G, G  # E = G


def _radial_m12(r2, var):
    floor = _r_floor(r2.dtype)
    r = torch.sqrt(torch.clamp(r2, min=floor))
    G = var * torch.exp(-r)
    # E = G / r diverges at r -> 0, where the true contribution is 0
    # (diagonal, duplicate points): mask at the clamp floor.
    E = torch.where(r2 > floor, G / r, torch.zeros((), dtype=r2.dtype, device=r2.device))
    return G, E


def _radial_m32(r2, var):
    r = torch.sqrt(torch.clamp(r2, min=_r_floor(r2.dtype)))
    e = torch.exp(-_SQRT3 * r)
    G = var * (1.0 + _SQRT3 * r) * e
    E = 3.0 * var * e  # -(dK/dr)/r
    return G, E


def _radial_m52(r2, var):
    r = torch.sqrt(torch.clamp(r2, min=_r_floor(r2.dtype)))
    e = torch.exp(-_SQRT5 * r)
    G = var * (1.0 + _SQRT5 * r + (5.0 / 3.0) * r2) * e
    E = (5.0 / 3.0) * var * (1.0 + _SQRT5 * r) * e  # -(dK/dr)/r
    return G, E


#: Radial maps (r2, var) -> (G, E), E = −2·∂k/∂r² (the ∂/∂log ℓ_q map).
_RADIALS = {
    "rbf": _radial_rbf,
    "matern12": _radial_m12,
    "matern32": _radial_m32,
    "matern52": _radial_m52,
}


def _radial_rq(r2, var, log_extra):
    """RationalQuadratic: k = σ²·u^(−α), u = 1 + r²/(2α), α = exp(extra);
    returns (G, E, F) with E = σ²·u^(−α−1) and F = ∂k/∂log α =
    k·(r²/(2u) − α·ln u)."""
    a = torch.exp(log_extra).reshape(())
    u = 1.0 + r2 / (2.0 * a)
    G = var * torch.pow(u, -a)
    E = var * torch.pow(u, -(a + 1.0))
    F = G * (r2 / (2.0 * u) - a * torch.log(u))
    return G, E, F


#: Radial kinds with one extra scalar hyperparameter:
#: (r2, var, log_extra) -> (G, E, F), F = ∂K/∂log_extra.
_RADIALS_X = {"rq": _radial_rq}


def _radial_maps(kind, r2, var, log_extra=None):
    """(G, E, F) of ``kind`` at ``r2``; F is None for the kinds without an
    extra hyperparameter."""
    if kind in _RADIALS_X:
        return _RADIALS_X[kind](r2, var, log_extra)
    return (*_RADIALS[kind](r2, var), None)


def _scaled(x, log_ell):
    # Divide (not multiply by the reciprocal): the same x̃ as the model
    # path's X/ℓ, which matters for the kinked Materns near r = 0.
    return x / torch.exp(log_ell)


def _r2_full(xs):
    """Pairwise r² by the norm identity, clamped at 0, with the diagonal set
    to exactly 0 (the identity leaves ±eps there, which the kinked matern12
    amplifies to √eps)."""
    x1s = torch.sum(xs * xs, dim=1, keepdim=True)
    r2 = torch.clamp(x1s + x1s.mT - 2.0 * (xs @ xs.mT), min=0.0)
    r2.diagonal().zero_()
    return r2


def _gram(xs, log_var, kind, diag=None, log_extra=None):
    """Noiseless (``diag`` None) or noisy symmetric Gram on scaled inputs:
    :func:`~gptorch_tpu_torch.ops.gram.rbf_gram` for ``rbf`` (the kernel on
    the card), the plain maps for the other kinds."""
    if kind == "rbf":
        return rbf_gram(xs.contiguous(), var=torch.exp(log_var), diag=diag)
    G = _radial_maps(kind, _r2_full(xs), torch.exp(log_var), log_extra)[0]
    if diag is not None:
        G.diagonal().add_(diag)
    return G


def _contractions(Kinv, A, xs, log_var, dy, kind, log_extra):
    """svar, rowsum, MX, sextra of W = dy·Kinv − A Aᵀ against the radial maps
    (:func:`~gptorch_tpu_torch.ops.contract.radial_contractions`: the kernel
    on the card, the plain formula on the CPU)."""
    return radial_contractions(
        Kinv.contiguous(), A.contiguous(), xs.contiguous(), log_var, dy, kind,
        log_extra if kind in _RADIALS_X else None,
    )


def _fwd_impl(kind, log_ell, log_var, log_noise, x, y, jitter, nb, rel_jitter, log_extra):
    n, dy = y.shape
    xs = _scaled(x, log_ell)
    diag = torch.exp(log_noise) + jitter + rel_jitter * torch.exp(log_var)
    K = _gram(xs, log_var, kind, diag, log_extra)
    L = _cholesky_into(K, nb, lower_only=True)  # K is ours: factored in place
    alpha = blocked_ltrsm(L, y, leaf=4096)
    nlml = (
        0.5 * torch.sum(torch.square(alpha))
        + dy * torch.sum(torch.log(torch.diagonal(L)))
        + 0.5 * n * dy * math.log(2.0 * math.pi)
    )
    return nlml, L, alpha


class _Held:
    """Carries a forward's intermediates to ``setup_context`` off the
    autograd function's outputs and saved tensors (a plain object, so that
    ``torch.func`` passes it through as it is)."""

    value = None


def _member(args, in_dims, b):
    """Member ``b`` of a ``vmap`` rule's arguments: each mapped tensor at
    ``b`` on its mapped axis, a fresh :class:`_Held` for a held one, every
    other argument as it is."""
    return tuple(
        _Held() if isinstance(a, _Held) else a.select(d, b) if isinstance(a, torch.Tensor) and d is not None else a
        for a, d in zip(args, in_dims)
    )


def _radial_backward(ctx, g):
    """The closed-form adjoint (module docstring) of either autograd function
    below, from the inputs saved on ``ctx`` and its ``L`` and ``alpha``."""
    log_ell, log_var, log_noise, x, y, log_extra = ctx.saved_tensors
    kind, nb, alpha = ctx.kind, ctx.nb, ctx.alpha
    L, ctx.L = ctx.L, None
    if L is None:  # a second backward (retain_graph, gradcheck)
        jitter, rel_jitter = ctx.jitter
        _, L, _ = _fwd_impl(kind, log_ell, log_var, log_noise, x, y, jitter, nb, rel_jitter, log_extra)
    dy = y.shape[1]
    A = _solve_lower_t(L, alpha)  # L⁻ᵀα = K⁻¹Y
    Linv = blocked_trtri(L, min(nb, 1024))
    del L
    Kinv = tril_square_rec(Linv, min(nb, 512), 4096)
    del Linv

    xs = _scaled(x, log_ell)
    svar, rowsum, MX, sextra = _contractions(Kinv, A, xs, log_var, dy, kind, log_extra)
    d_log_var = 0.5 * svar
    d_log_ell_full = torch.sum(rowsum[:, None] * torch.square(xs), dim=0) - torch.sum(xs * MX, dim=0)
    if log_ell.ndim == 0:
        d_log_ell = torch.sum(d_log_ell_full)
    elif log_ell.shape[0] == 1 and x.shape[1] != 1:
        d_log_ell = torch.sum(d_log_ell_full, dim=0, keepdim=True)
    else:
        d_log_ell = d_log_ell_full
    tr_W = dy * torch.trace(Kinv) - torch.sum(torch.square(A))
    d_log_noise = 0.5 * torch.exp(log_noise) * tr_W
    if log_extra.numel():
        d_log_extra = (0.5 * sextra).expand(log_extra.shape).to(log_extra.dtype)
    else:
        d_log_extra = torch.zeros_like(log_extra)
    return (
        None,
        g * d_log_ell,
        g * d_log_var.reshape(log_var.shape),
        g * d_log_noise.reshape(log_noise.shape),
        None,
        None,
        None,
        None,
        None,
        g * d_log_extra,
    )


def _radial_context(ctx, kind, log_ell, log_var, log_noise, x, y, jitter, nb, rel_jitter, log_extra, L, alpha):
    ctx.kind, ctx.nb, ctx.jitter = kind, nb, (jitter, rel_jitter)
    # L is an intermediate, kept on ctx (not saved) so the backward can
    # drop it before K⁻¹ is allocated; a second backward refactors.
    ctx.L, ctx.alpha = L, alpha
    ctx.save_for_backward(log_ell, log_var, log_noise, x, y, log_extra)


class _RadialNLMLCore(torch.autograd.Function):
    """The fused NLML for calls under ``torch.func`` transforms: the
    ``setup_context`` form, whose ``vmap`` rule runs the mapped members one
    after the other through this function (each its own Gram, factor and
    contraction; a Gram at the fused sizes fills the card alone)."""

    @staticmethod
    def forward(kind, log_ell, log_var, log_noise, x, y, jitter, nb, rel_jitter, log_extra, held):
        nlml, L, alpha = _fwd_impl(kind, log_ell, log_var, log_noise, x, y, jitter, nb, rel_jitter, log_extra)
        held.value = (L, alpha)
        return nlml

    @staticmethod
    def setup_context(ctx, inputs, output):
        *args, held = inputs
        L, alpha = held.value  # read at every level of nested transforms
        _radial_context(ctx, *args, L, alpha)

    @staticmethod
    def backward(ctx, g):
        return _radial_backward(ctx, g) + (None,)

    @staticmethod
    def vmap(info, in_dims, *args):
        members = [_RadialNLMLCore.apply(*_member(args, in_dims, b)) for b in range(info.batch_size)]
        return torch.stack(members), 0


class _RadialNLMLCoreEager(torch.autograd.Function):
    """:class:`_RadialNLMLCore` in the ``ctx`` form, for calls outside
    ``torch.func`` transforms (the ``setup_context`` form binds its
    arguments by ``inspect.signature`` on every call)."""

    @staticmethod
    def forward(ctx, kind, log_ell, log_var, log_noise, x, y, jitter, nb, rel_jitter, log_extra):
        nlml, L, alpha = _fwd_impl(kind, log_ell, log_var, log_noise, x, y, jitter, nb, rel_jitter, log_extra)
        _radial_context(ctx, kind, log_ell, log_var, log_noise, x, y, jitter, nb, rel_jitter, log_extra, L, alpha)
        return nlml

    backward = staticmethod(_radial_backward)


def radial_nlml(kind, log_ell, log_var, log_noise, x, y, jitter=0.0, nb=1024, rel_jitter=0.0,
                log_extra=None):
    """Negative log marginal likelihood of exact GPR with a radial(-ARD)
    kernel and zero mean, differentiable in the log hyperparameters.

    :param kind: "rbf", "matern12", "matern32", "matern52" or "rq".
    :param log_ell: log length scales, scalar () / (1,) or ARD (d,).
    :param log_var: log kernel variance, 0-d.
    :param log_noise: log Gaussian noise variance, 0-d.
    :param x: (n, d) inputs.  :param y: (n, dy) targets (no gradient).
    :param jitter: extra absolute diagonal jitter.
    :param nb: panel size of the blocked factorizations.
    :param rel_jitter: relative jitter, added as rel_jitter·σ² to the
        diagonal (a constant in the adjoint).
    :param log_extra: (1,) log α for ``rq``; omit for the other kinds.
    """
    if log_extra is None:
        if kind in _RADIALS_X:
            raise ValueError(
                f"kind={kind!r} carries an extra hyperparameter: pass "
                "log_extra (rq: log alpha, shape (1,))"
            )
        log_extra = x.new_zeros((0,))
    args = (kind, log_ell, log_var, log_noise, x, y, jitter, nb, rel_jitter, log_extra)
    if torch._C._are_functorch_transforms_active():  # vmap, grad, ...: the form with a vmap rule
        return _RadialNLMLCore.apply(*args, _Held())
    return _RadialNLMLCoreEager.apply(*args)


def rbf_nlml(log_ell, log_var, log_noise, x, y, jitter=0.0, nb=1024, rel_jitter=0.0):
    """The RBF specialization of :func:`radial_nlml`."""
    return radial_nlml("rbf", log_ell, log_var, log_noise, x, y, jitter, nb, rel_jitter)


def rbf_nlml_value_and_grad(log_ell, log_var, log_noise, x, y, jitter=0.0, nb=1024):
    """(nlml, (d_log_ell, d_log_var, d_log_noise)) of :func:`rbf_nlml`."""
    params = [t.detach().requires_grad_() for t in (log_ell, log_var, log_noise)]
    with torch.enable_grad():
        nlml = rbf_nlml(*params, x, y, jitter, nb)
        grads = torch.autograd.grad(nlml, params)
    return nlml.detach(), tuple(grads)
