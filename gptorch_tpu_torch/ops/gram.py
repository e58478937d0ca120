"""The radial (RBF) Gram matrix: a hand-written Hopper kernel and its plain twin.

    out[i, j] = var · exp(−½ ‖x1[i] − x2[j]‖²)   (+ diag where i == j, symmetric case)

on inputs already divided by the length scales.

:func:`rbf_gram` replaces the JAX package's Pallas TPU kernel
``gptorch_tpu/ops/pallas_gram.py:_rbf_tile_kernel``.  On a CUDA tensor it
launches ``csrc/rbf_gram.cu`` (see the note at its top): one 64×64 output
tile per block, r² from direct differences (no cancellation, an exact 0 on
the symmetric diagonal), ragged shapes masked, ``var``/``diag`` read from a
2-element device array so no call synchronises with the host.  It is bound
by the n1·n2 write: 4.29 GB for n = 32768 in float32, about 1.28 ms at the
H100's 3.35 TB/s.  On a CPU tensor it computes :func:`rbf_gram_plain`,
which is also the reference the kernel is tested against.

The kernel has no backward yet: on CUDA an input that requires grad while
grad is enabled raises ``NotImplementedError``.
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
    :func:`~gptorch_tpu_torch.util.squared_distance` (differentiable)."""
    var = _scalar(var, x1)
    out = var * torch.exp(-0.5 * squared_distance(x1, x2))
    if x2 is None and diag is not None:
        out = add_diag(out, _scalar(diag, x1))
    return out


def _scalar(v, like):
    """``v`` as a 0-d tensor of ``like``'s dtype on its device; a Python
    number becomes a device fill, not a host-to-device copy."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=like.dtype, device=like.device).reshape(())
    return torch.full((), float(v), dtype=like.dtype, device=like.device)


def _check(x1, x2):
    for name, t in (("x1", x1), ("x2", x2)):
        if not isinstance(t, torch.Tensor) or t.ndim != 2:
            raise ValueError(f"rbf_gram: {name} must be a 2-D tensor")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"rbf_gram: {name} has dtype {t.dtype}; float32 or float64 only")
        if not t.is_contiguous():
            raise ValueError(f"rbf_gram: {name} must be contiguous")
    if x1.dtype != x2.dtype or x1.device != x2.device:
        raise TypeError("rbf_gram: x1 and x2 must share dtype and device")
    if x1.shape[1] != x2.shape[1]:
        raise ValueError(f"rbf_gram: feature dims differ ({x1.shape[1]} vs {x2.shape[1]})")


@functools.cache
def _kernel_library():
    lib = _build.library("rbf_gram")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.rbf_gram_f32, lib.rbf_gram_f64):
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        fn.restype = i32
    lib.rbf_gram_error_string.argtypes = [i32]
    lib.rbf_gram_error_string.restype = ctypes.c_char_p
    lib.rbf_gram_max_rows.argtypes = []
    lib.rbf_gram_max_rows.restype = i32
    return lib


def rbf_gram(x1, x2=None, *, var, diag=None):
    """var·exp(−½‖x1[i] − x2[j]‖²) (+ ``diag`` on the diagonal when ``x2``
    is None), for scaled inputs ``x1`` (n1, d) and ``x2`` (n2, d).

    :param var: kernel variance, a number or a tensor with one element.
    :param diag: value added on the diagonal in the symmetric case (the
        noise variance), a number or a one-element tensor; ignored for a
        cross Gram.

    CUDA tensors launch the kernel (and count the launch in
    ``rbf_gram.launches``); CPU tensors take :func:`rbf_gram_plain`.
    """
    sym = x2 is None
    x2_ = x1 if sym else x2
    _check(x1, x2_)
    if x1.device.type == "cpu":
        return rbf_gram_plain(x1, x2, var, diag)
    if x1.device.type != "cuda":
        raise ValueError(f"rbf_gram: unsupported device {x1.device}")
    tensors = [t for t in (x1, x2_, var, diag) if isinstance(t, torch.Tensor)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "rbf_gram on CUDA has no backward yet; call it under torch.no_grad()"
        )
    lib = _kernel_library()
    n1, d = x1.shape
    n2 = x2_.shape[0]
    if n1 > lib.rbf_gram_max_rows():
        raise ValueError(f"rbf_gram: {n1} rows exceed one launch's {lib.rbf_gram_max_rows()}")
    scal = torch.stack([_scalar(var, x1), _scalar(0.0 if diag is None else diag, x1)])
    out = torch.empty((n1, n2), dtype=x1.dtype, device=x1.device)
    if n1 == 0 or n2 == 0:
        return out
    fn = lib.rbf_gram_f32 if x1.dtype == torch.float32 else lib.rbf_gram_f64
    with torch.cuda.device(x1.device):
        code = fn(
            x1.data_ptr(), x2_.data_ptr(), scal.data_ptr(), out.data_ptr(),
            n1, n2, d, int(sym), torch.cuda.current_stream().cuda_stream,
        )
    if code != 0:
        raise RuntimeError(f"rbf_gram launch failed: {lib.rbf_gram_error_string(code).decode()}")
    rbf_gram.launches += 1
    return out


#: Number of kernel launches made by :func:`rbf_gram` in this process.
rbf_gram.launches = 0
