"""The matrix-free product with the noisy radial Gram: a hand-written
Hopper kernel (K3) and its plain twin.

    out = (K + noise·I)·V,   K_ij = σ²·g(‖x̃ᵢ − x̃ⱼ‖²)

on length-scale-scaled inputs x̃, for the radial map g of one of
:data:`KINDS` (:mod:`~gptorch_tpu_torch.ops.gpr_fast`) and V (n, k).

:func:`gram_mvm` is the operator of the JAX package's ``radial_mvm``
(``gptorch_tpu/ops/iterative.py:92-127`` with ``_gram_slab`` :73-89), which
XLA fuses on the TPU into two GEMMs per row slab.  On a CUDA tensor it
launches ``csrc/radial_mvm.cu`` (see the note at its top).  The kernel forms
r² by the reference's norm identity on centred inputs: :func:`_mvm_records`
subtracts x̃'s column means (r² does not change) and folds rbf's constant,
so that t_ij = βᵢ + βⱼ + uᵢ·yⱼ = c·r², and :func:`_pack_records` writes each
point's (y, β) and V's columns of a pass as one aligned record.  Each thread
of the kernel holds a few rows in registers and walks the Gram's columns in
shared-memory tiles, recomputing each entry once per pair for up to 32 of
V's columns; no n² data is stored and every sum runs in a fixed order.  It
is bound by instruction issue: about 25 issue slots a pair at d = 8, k = 9,
where the function's operations bound it at 5.8 ms at n = 100000 on an
H100 in float32.  On a CPU tensor it computes :func:`gram_mvm_plain`, the
JAX package's slab loop, which is also the reference the kernel is tested
against.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .gpr_fast import _radial_maps
from .gram import _scalar

#: Kinds of the kernel, in the order of its compile-time switch.
KINDS = ("rbf", "matern12", "matern32", "matern52", "rq")
#: The widest inputs the kernel takes (``kMaxD`` of the source).
MAX_D = 32
#: rbf's exponent in base 2 per unit of r²: exp(−r²/2) = 2^(c·r²).
RBF_EXP2 = -0.5 * math.log2(math.e)


def _slab_gram(kind, xs, xsn, lo, slab, var, log_extra):
    """Rows [lo, lo + slab) of the noiseless Gram by the norm identity, the
    slab's self-distances set to exactly 0 (``_gram_slab``, iterative.py:73-89)."""
    xs_s = xs[lo : lo + slab]
    r2 = torch.sum(xs_s * xs_s, dim=1, keepdim=True) + xsn[None, :] - 2.0 * (xs_s @ xs.mT)
    r2[:, lo : lo + slab].diagonal().zero_()
    return _radial_maps(kind, torch.clamp(r2, min=0.0), var, log_extra)[0]


def gram_mvm_plain(kind, xs, log_var, noise, V, slab=2048, log_extra=None):
    """Plain PyTorch version of :func:`gram_mvm`: the slab loop of
    iterative.py:104-124 (O(slab·n) memory; a ragged end takes an
    overlapping final slab)."""
    n = xs.shape[0]
    var = torch.exp(log_var)
    xsn = torch.sum(xs * xs, dim=1)
    slab = min(slab, n)
    out = V.new_zeros((n, V.shape[1]))
    full = n // slab
    for s in range(full):
        lo = s * slab
        out[lo : lo + slab] = _slab_gram(kind, xs, xsn, lo, slab, var, log_extra) @ V
    rem = n - full * slab
    if rem:
        G = _slab_gram(kind, xs, xsn, n - slab, slab, var, log_extra)
        out[full * slab :] = (G @ V)[slab - rem :]
    return out + noise * V


def _mvm_records(xs, kind):
    """The kernel's view of x̃ (n, d): (u, β, y) with

        t_ij = βᵢ + βⱼ + uᵢ·yⱼ = c·‖x̃ᵢ − x̃ⱼ‖²,

    c = :data:`RBF_EXP2` for rbf (the kernel takes 2^min(t, 0)) and 1 for
    the other kinds (their map of max(t, 0)).  x̃ is centred first, so the
    norm identity's rounding, u·(‖x̃ᵢ‖² + ‖x̃ⱼ‖²), is the data's spread and
    not its offset; rbf's inputs are then scaled by √−c, so y = ±2u exactly
    and tᵢⱼ, tⱼᵢ round alike.  Any device; the kernel sets r² on the diagonal
    to exactly 0 itself (here tᵢᵢ is 0 up to rounding)."""
    xc = xs - xs.mean(dim=0)
    if kind == "rbf":
        u = xc * math.sqrt(-RBF_EXP2)
        return u, -torch.sum(u * u, dim=1), 2.0 * u
    return xc, torch.sum(xc * xc, dim=1), -2.0 * xc


def _pack_records(beta, y, V, maxd, kc, width):
    """The records of the kernel's passes, (⌈k / kc⌉, n, width): pass p's
    row j is [yⱼ (zero-padded to ``maxd``) | βⱼ | V's columns p·kc ..
    p·kc + kc − 1 of row j (zero beyond k) | zeros]."""
    n, d = y.shape
    k = V.shape[1]
    passes = -(-k // kc)
    rec = y.new_zeros((passes, n, width))
    rec[:, :, :d] = y
    rec[:, :, maxd] = beta
    cols = V if k == passes * kc else torch.nn.functional.pad(V, (0, passes * kc - k))
    rec[:, :, maxd + 1 : maxd + 1 + kc] = cols.reshape(n, passes, kc).transpose(0, 1)
    return rec


def _check(kind, xs, V):
    if kind not in KINDS:
        raise ValueError(f"gram_mvm: unknown kind {kind!r}; one of {KINDS}")
    for name, t in (("xs", xs), ("V", V)):
        if not isinstance(t, torch.Tensor) or t.ndim != 2:
            raise ValueError(f"gram_mvm: {name} must be a 2-D tensor")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"gram_mvm: {name} has dtype {t.dtype}; float32 or float64 only")
    if xs.dtype != V.dtype or xs.device != V.device:
        raise TypeError("gram_mvm: xs and V must share dtype and device")
    if V.shape[0] != xs.shape[0]:
        raise ValueError(f"gram_mvm: V has {V.shape[0]} rows, xs {xs.shape[0]}")


@functools.cache
def _kernel_library():
    lib = _build.library("radial_mvm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.radial_mvm_f32, lib.radial_mvm_f64):
        fn.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
        fn.restype = i32
    lib.radial_mvm_plan.argtypes = [i32] * 5 + [ctypes.POINTER(ctypes.c_int64)]
    lib.radial_mvm_plan.restype = i32
    lib.radial_mvm_max_d.argtypes = []
    lib.radial_mvm_max_d.restype = i32
    lib.radial_mvm_error_string.argtypes = [i32]
    lib.radial_mvm_error_string.restype = ctypes.c_char_p
    if lib.radial_mvm_max_d() != MAX_D:
        raise RuntimeError("radial_mvm: the built library's width limit differs from MAX_D")
    return lib


def gram_mvm(kind, xs, log_var, noise, V, slab=2048, log_extra=None):
    """(K + noise·I)·V for the radial Gram K of ``kind`` on ``xs``.

    :param xs: (n, d) length-scale-scaled inputs.
    :param log_var: log kernel variance, a 0-d tensor.
    :param noise: the diagonal, σ_n² + jitter (0-d tensor or number).
    :param V: (n, k) block of vectors.
    :param slab: the plain twin's row-slab size (the kernel ignores it).
    :param log_extra: (1,) log α for ``rq``; ignored by the other kinds.

    CUDA tensors launch the kernel (and count the call in
    ``gram_mvm.launches``); it takes d ≤ 32 and raises ``ValueError``
    beyond.  CPU tensors take :func:`gram_mvm_plain`.  Not differentiable
    itself: :func:`~gptorch_tpu_torch.ops.iterative.radial_mvm` wraps it.
    """
    _check(kind, xs, V)
    if xs.device.type == "cpu":
        return gram_mvm_plain(kind, xs, log_var, noise, V, slab, log_extra)
    if xs.device.type != "cuda":
        raise ValueError(f"gram_mvm: unsupported device {xs.device}")
    n, d = xs.shape
    k = V.shape[1]
    if d > MAX_D:
        raise ValueError(f"gram_mvm: the kernel takes d <= {MAX_D}; got d = {d}")
    out = V.new_empty((n, k))
    if n == 0 or k == 0:
        return out
    lib = _kernel_library()
    var = torch.exp(_scalar(log_var, xs))
    alpha = torch.exp(_scalar(log_extra, xs)) if kind == "rq" else var.new_ones(())
    scal = torch.stack([var, alpha, _scalar(noise, xs)])
    fn = lib.radial_mvm_f32 if xs.dtype == torch.float32 else lib.radial_mvm_f64
    plan = (ctypes.c_int64 * 4)()
    with torch.cuda.device(xs.device):
        code = lib.radial_mvm_plan(xs.element_size(), n, d, k, KINDS.index(kind), plan)
        if code == 0:
            maxd, kc, width, work_bytes = plan
            _, beta, y = _mvm_records(xs, kind)
            rec = _pack_records(beta, y, V, maxd, kc, width)
            work = torch.empty((work_bytes,), dtype=torch.uint8, device=xs.device)
            code = fn(
                rec.data_ptr(), scal.data_ptr(), work.data_ptr(), out.data_ptr(), n, d, k, KINDS.index(kind),
                torch.cuda.current_stream().cuda_stream,
            )
    if code != 0:
        raise RuntimeError(f"gram_mvm launch failed: {lib.radial_mvm_error_string(code).decode()}")
    gram_mvm.launches += 1
    return out


#: Number of calls of :func:`gram_mvm` that launched the kernel in this process.
gram_mvm.launches = 0
