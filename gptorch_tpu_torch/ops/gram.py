"""The radial (RBF) Gram matrix: a hand-written Hopper kernel and its plain twin.

    out[i, j] = var · exp(−½ ‖x1[i] − x2[j]‖²)   (+ diag where i == j, symmetric case)

on inputs already divided by the length scales; with a leading batch axis,
B such Grams, each with its own ``var`` and ``diag``.

:func:`rbf_gram` replaces the JAX package's Pallas TPU kernel
``gptorch_tpu/ops/pallas_gram.py:_rbf_tile_kernel``.  On a CUDA tensor it
launches ``csrc/rbf_gram.cu`` (see the note at its top): one 64×64 output
tile per block, r² from direct differences (no cancellation, an exact 0 on
the symmetric diagonal), ragged shapes masked, ``var``/``diag`` read from a
(B, 2) device array so no call synchronises with the host, and a batch of
Grams in one launch (the member is the grid's z index).  It is bound by
the n1·n2 write: 4.29 GB for n = 32768 in float32, about 1.28 ms at the
H100's 3.35 TB/s.  On a CPU tensor it computes :func:`rbf_gram_plain`,
which is also the reference the kernel is tested against.

On CUDA the launch is the forward of a ``torch.autograd.Function`` whose
backward is plain torch ops on the saved output (:func:`_gram_vjp`); the
Pallas kernel has no backward either -- JAX differentiates its generic path
through XLA.  The function of one Gram has a ``vmap`` rule that makes the
batched launch, so ``torch.func.vmap`` over a kernel's ``K`` (a fleet of
GPs, :class:`~gptorch_tpu_torch.models.ensemble.GPEnsemble`) builds all
its Grams in one launch; ``torch.func.grad`` runs through the backward.
There is no forward-mode rule: the derivative GP differentiates a kernel's
pair function, not its Gram.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..functions import add_diag
from ..util import squared_distance
from . import _build


def rbf_gram_plain(x1, x2=None, var=1.0, diag=None):
    """Plain PyTorch version of :func:`rbf_gram`, through
    :func:`~gptorch_tpu_torch.util.squared_distance` (differentiable);
    a leading batch axis takes one ``var`` and ``diag`` per Gram."""
    var = _scalar(var, x1)
    out = var[..., None, None] * torch.exp(-0.5 * squared_distance(x1, x2))
    if x2 is None and diag is not None:
        out = add_diag(out, _scalar(diag, x1))
    return out


def _scalar(v, like):
    """``v`` as a tensor of shape ``like.shape[:-2]`` (0-d for one Gram, (B,)
    for a batch) of ``like``'s dtype on its device: one element is
    broadcast; a Python number becomes a device fill, not a host-to-device
    copy."""
    shape = like.shape[:-2]
    if isinstance(v, torch.Tensor):
        v = v.to(dtype=like.dtype, device=like.device)
    else:
        v = torch.full((), float(v), dtype=like.dtype, device=like.device)
    if v.numel() == 1:
        return v.reshape(()).expand(shape)
    return v.reshape(shape)


def _check(x1, x2):
    for name, t in (("x1", x1), ("x2", x2)):
        if not isinstance(t, torch.Tensor) or t.ndim not in (2, 3):
            raise ValueError(f"rbf_gram: {name} must be a 2-D tensor, or 3-D for a batch of Grams")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"rbf_gram: {name} has dtype {t.dtype}; float32 or float64 only")
        if not t.is_contiguous():
            raise ValueError(f"rbf_gram: {name} must be contiguous")
    if x1.dtype != x2.dtype or x1.device != x2.device:
        raise TypeError("rbf_gram: x1 and x2 must share dtype and device")
    if x1.ndim != x2.ndim or x1.shape[:-2] != x2.shape[:-2]:
        raise ValueError(f"rbf_gram: batch shapes differ ({tuple(x1.shape)} vs {tuple(x2.shape)})")
    if x1.shape[-1] != x2.shape[-1]:
        raise ValueError(f"rbf_gram: feature dims differ ({x1.shape[-1]} vs {x2.shape[-1]})")


@functools.cache
def _kernel_library():
    lib = _build.library("rbf_gram")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.rbf_gram_f32, lib.rbf_gram_f64):
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
    lib.rbf_gram_error_string.argtypes = [i32]
    lib.rbf_gram_error_string.restype = ctypes.c_char_p
    lib.rbf_gram_max_rows.argtypes = []
    lib.rbf_gram_max_rows.restype = i32
    return lib


def _launch(x1, x2, var, diag):
    """One launch of the kernel for one Gram (2-D inputs, 0-d ``var`` and
    ``diag``) or a batch of them (3-D inputs, (B,) ``var`` and ``diag``);
    ``x2`` None is the symmetric case, ``diag`` None a cross Gram.  All on
    the card."""
    lib = _kernel_library()
    sym = x2 is None
    x2_ = x1 if sym else x2
    batch = x1.shape[0] if x1.ndim == 3 else 1
    n1, d = x1.shape[-2:]
    n2 = x2_.shape[-2]
    if n1 > lib.rbf_gram_max_rows():
        raise ValueError(f"rbf_gram: {n1} rows exceed one launch's {lib.rbf_gram_max_rows()}")
    scal = torch.stack([var, torch.zeros_like(var) if diag is None else diag], dim=-1).contiguous()
    out = torch.empty(x1.shape[:-1] + (n2,), dtype=x1.dtype, device=x1.device)
    if batch == 0 or n1 == 0 or n2 == 0:
        return out
    fn = lib.rbf_gram_f32 if x1.dtype == torch.float32 else lib.rbf_gram_f64
    with torch.cuda.device(x1.device):
        code = fn(
            x1.data_ptr(), x2_.data_ptr(), scal.data_ptr(), out.data_ptr(),
            batch, n1, n2, d, int(sym), torch.cuda.current_stream().cuda_stream,
        )
    if code != 0:
        raise RuntimeError(f"rbf_gram launch failed: {lib.rbf_gram_error_string(code).decode()}")
    rbf_gram.launches += 1
    return out


def _gram_vjp(g, out, x1, x2, var, diag):
    """Cotangents of (x1, x2, var, diag) for the cotangent ``g`` of
    ``out = rbf_gram(x1, x2, var=var, diag=diag)``, from the saved output;
    over the last two axes, so a batch of Grams gives each member its own.

    With M = g ⊙ (out − diag·I) = g ⊙ G (G the noiseless Gram):
    ∂/∂var = ΣM / var, ∂/∂diag = tr g, ∂/∂x1 = M x2 − rowsum(M)·x1 and
    ∂/∂x2 = Mᵀ x1 − colsum(M)·x2; in the symmetric case (``x2`` None) the
    two input cotangents are summed into the one input's.
    """
    sym = x2 is None
    M = g * out
    if sym:
        M.diagonal(dim1=-2, dim2=-1).sub_(g.diagonal(dim1=-2, dim2=-1) * diag[..., None])
    x2_ = x1 if sym else x2
    d_x1 = M @ x2_ - M.sum(dim=-1, keepdim=True) * x1
    d_x2 = M.mT @ x1 - M.sum(dim=-2).unsqueeze(-1) * x2_
    d_var = M.sum(dim=(-2, -1)) / var
    if sym:
        return d_x1 + d_x2, None, d_var, g.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
    return d_x1, d_x2, d_var, None


class _RbfGram(torch.autograd.Function):
    """The kernel launch with a backward of plain torch ops
    (:func:`_gram_vjp`), for one Gram or a batch; under ``torch.func.vmap``
    its ``vmap`` rule makes one batched launch for the mapped Grams."""

    @staticmethod
    def forward(x1, x2, var, diag):
        return _launch(x1, x2, var, diag)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x1, x2, var, diag = inputs
        ctx.save_for_backward(x1, x2, var, diag, output)

    @staticmethod
    def backward(ctx, g):
        x1, x2, var, diag, out = ctx.saved_tensors
        return _gram_vjp(g, out, x1, x2, var, diag)

    @staticmethod
    def vmap(info, in_dims, x1, x2, var, diag):
        # The logical inputs here are one Gram's (or, under nested maps, a
        # batch's); the mapped axis goes first and joins the batch axis.
        shape = list(x1.shape)
        if in_dims[0] is not None:
            del shape[in_dims[0]]
        lead = len(shape) - 1  # the mapped axis and any batch axis

        def batched(t, dim):
            if t is None:
                return None
            t = t.movedim(dim, 0) if dim is not None else t.expand((info.batch_size,) + t.shape)
            return t.reshape((-1,) + tuple(t.shape[lead:])).contiguous()

        out = _RbfGram.apply(*(batched(t, dim) for t, dim in zip((x1, x2, var, diag), in_dims)))
        return out.reshape([info.batch_size] + shape[:-1] + [out.shape[-1]]), 0


def rbf_gram(x1, x2=None, *, var, diag=None):
    """var·exp(−½‖x1[i] − x2[j]‖²) (+ ``diag`` on the diagonal when ``x2``
    is None), for scaled inputs ``x1`` (n1, d) and ``x2`` (n2, d), or a
    batch of B Grams from (B, n1, d) and (B, n2, d) in one launch.

    :param var: kernel variance, a number, a tensor with one element, or
        (batch) one per Gram.
    :param diag: value added on the diagonal in the symmetric case (the
        noise variance), in the same forms; ignored for a cross Gram.

    CUDA tensors launch the kernel (and count the launch in
    ``rbf_gram.launches``), differentiably in every tensor argument; CPU
    tensors take :func:`rbf_gram_plain`.
    """
    sym = x2 is None
    _check(x1, x1 if sym else x2)
    if x1.device.type == "cpu":
        return rbf_gram_plain(x1, x2, var, diag)
    if x1.device.type != "cuda":
        raise ValueError(f"rbf_gram: unsupported device {x1.device}")
    diag = _scalar(0.0 if diag is None else diag, x1) if sym else None
    return _RbfGram.apply(x1, x2, _scalar(var, x1), diag)


#: Number of kernel launches made by :func:`rbf_gram` in this process.
rbf_gram.launches = 0
