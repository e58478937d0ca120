"""The backward contraction of the fused radial NLML: a hand-written Hopper
kernel and its plain twin.

With W = dy·K⁻¹ − A Aᵀ and the radial maps G, E (and F for ``rq``) of
r² = ‖x̃ᵢ − x̃ⱼ‖² (:mod:`~gptorch_tpu_torch.ops.gpr_fast`):

    svar   = Σ W ⊙ G          rowsum = (W ⊙ E)·1
    MX     = (W ⊙ E)·x̃        sextra = Σ W ⊙ F   (0 for kinds without F)

:func:`radial_contractions` replaces ``gptorch_tpu/ops/gpr_fast.py``
``_contractions`` (gpr_fast.py:300-367), which XLA fuses on the TPU.  On a
CUDA tensor it launches ``csrc/radial_contract.cu`` (see the note at its
top): one 256-thread block per strip of rows streams the strip's K⁻¹ once
through a ring of shared-memory stages filled by ``cp.async``, and each
thread computes a register micro-tile of rows × 16 bytes of columns per
stage.  None of G, E, W or W ⊙ E is stored, and the scalar sums are reduced
per strip in float64 without atomics, so a gradient is the same from run to
run.  Two limits of about the same size bound it on an H100: the read of
K⁻¹ (4.29 GB at n = 32768 in float32, 1.28 ms at 3.35 TB/s) and the issue
rate of the pair arithmetic (about 29 float32 instructions a pair at d = 8,
about 0.95 ms).  On a CPU tensor it computes
:func:`radial_contractions_plain`, which is also the reference the kernel is
tested against.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: Kinds of the kernel, in the order of its compile-time switch.
KINDS = ("rbf", "matern12", "matern32", "matern52", "rq")
#: The widest inputs and targets the kernel takes (``kMaxD``/``kMaxDy`` of
#: the source; checked against the built library when it loads).
MAX_D, MAX_DY = 32, 32


def kernel_takes(d: int, dy: int) -> bool:
    """Whether the kernel takes inputs of width ``d`` and ``dy`` outputs."""
    return d <= MAX_D and dy <= MAX_DY


def _maps(xs, log_var, kind, log_extra):
    """The radial maps (G, E, F) of ``kind`` on all pairs of ``xs``, F None
    for kinds without an extra hyperparameter, by the JAX package's formula
    (r² by the norm identity, :func:`~gptorch_tpu_torch.ops.gpr_fast._r2_full`)."""
    from .gpr_fast import _r2_full, _radial_maps

    return _radial_maps(kind, _r2_full(xs), torch.exp(log_var), log_extra)


def radial_contractions_plain(Kinv, A, xs, log_var, dy, kind, log_extra=None):
    """Plain PyTorch version of :func:`radial_contractions`: the non-streamed
    formula of gpr_fast.py:320-326, with every n² intermediate stored."""
    G, E, F = _maps(xs, log_var, kind, log_extra)
    W = dy * Kinv - A @ A.mT
    svar = torch.sum(W * G)
    sextra = torch.sum(W * F) if F is not None else xs.new_zeros(())
    J = torch.cat([xs.new_ones((xs.shape[0], 1)), xs], dim=1)
    P = (W * E) @ J
    return svar, P[:, 0], P[:, 1:], sextra


def contraction_scales(Kinv, A, xs, log_var, dy, kind, log_extra=None):
    """The sums of absolute terms behind each output of
    :func:`radial_contractions`: (Σ|W|·|G|, (|W|·|E|)·1, (|W|·|E|)·|x̃|,
    Σ|W|·|F|).  Two correct implementations that sum in different orders
    differ by a few units of roundoff of these, so they are the scale a
    comparison's tolerance is stated against."""
    G, E, F = _maps(xs, log_var, kind, log_extra)
    W = (dy * Kinv - A @ A.mT).abs_()
    WE = W * E.abs()
    sextra = torch.sum(W * F.abs()) if F is not None else xs.new_zeros(())
    return torch.sum(W * G.abs()), WE.sum(dim=1), WE @ xs.abs(), sextra


def _check(Kinv, A, xs, dy, kind):
    if kind not in KINDS:
        raise ValueError(f"radial_contractions: unknown kind {kind!r}; one of {KINDS}")
    for name, t in (("Kinv", Kinv), ("A", A), ("xs", xs)):
        if not isinstance(t, torch.Tensor) or t.ndim != 2:
            raise ValueError(f"radial_contractions: {name} must be a 2-D tensor")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"radial_contractions: {name} has dtype {t.dtype}; float32 or float64 only")
        if not t.is_contiguous():
            raise ValueError(f"radial_contractions: {name} must be contiguous")
        if t.dtype != xs.dtype or t.device != xs.device:
            raise TypeError("radial_contractions: Kinv, A and xs must share dtype and device")
    n = xs.shape[0]
    if Kinv.shape != (n, n) or A.shape[0] != n:
        raise ValueError(
            f"radial_contractions: shapes Kinv {tuple(Kinv.shape)}, A {tuple(A.shape)}, "
            f"xs {tuple(xs.shape)} do not agree"
        )
    if A.shape[1] != dy:
        raise ValueError(f"radial_contractions: A has {A.shape[1]} columns, dy is {dy}")


@functools.cache
def _kernel_library():
    lib = _build.library("radial_contract")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.radial_contract_f32, lib.radial_contract_f64):
        fn.argtypes = [ptr] * 8 + [i32, i32, i32, i32, ptr]
        fn.restype = i32
    for fn in (lib.radial_contract_max_d, lib.radial_contract_max_dy):
        fn.argtypes = []
        fn.restype = i32
    lib.radial_contract_workspace_bytes.argtypes = [i32, i32, i32, i32]
    lib.radial_contract_workspace_bytes.restype = ctypes.c_int64
    lib.radial_contract_error_string.argtypes = [i32]
    lib.radial_contract_error_string.restype = ctypes.c_char_p
    if (lib.radial_contract_max_d(), lib.radial_contract_max_dy()) != (MAX_D, MAX_DY):
        raise RuntimeError("radial_contract: the built library's width limits differ from MAX_D, MAX_DY")
    return lib


def radial_contractions(Kinv, A, xs, log_var, dy, kind, log_extra=None):
    """(svar, rowsum, MX, sextra) of W = dy·Kinv − A Aᵀ against the radial
    maps of ``kind`` on the scaled inputs ``xs``; the signature of the JAX
    package's ``_contractions``.

    :param Kinv: (n, n) symmetric K⁻¹.  :param A: (n, dy) K⁻¹Y.
    :param xs: (n, d) length-scale-scaled inputs.
    :param log_var: log kernel variance, a 0-d tensor.
    :param dy: number of outputs (A's columns).
    :param kind: one of :data:`KINDS`.
    :param log_extra: (1,) log α for ``rq``; ignored by the other kinds.

    CUDA tensors launch the kernel (and count the launch in
    ``radial_contractions.launches``); it takes d ≤ 32 and dy ≤ 32 and
    raises ``ValueError`` beyond.  CPU tensors take
    :func:`radial_contractions_plain`.
    """
    _check(Kinv, A, xs, dy, kind)
    if xs.device.type == "cpu":
        return radial_contractions_plain(Kinv, A, xs, log_var, dy, kind, log_extra)
    if xs.device.type != "cuda":
        raise ValueError(f"radial_contractions: unsupported device {xs.device}")
    lib = _kernel_library()
    n, d = xs.shape
    if not kernel_takes(d, dy):
        raise ValueError(
            f"radial_contractions: the kernel takes d <= {MAX_D} and dy <= {MAX_DY}; got d = {d}, dy = {dy}"
        )
    rowsum = xs.new_empty((n,))
    mx = xs.new_empty((n, d))
    out = xs.new_zeros((2,))
    if n == 0:
        return out[0], rowsum, mx, out[1]
    var = torch.exp(torch.as_tensor(log_var, dtype=xs.dtype, device=xs.device).reshape(()))
    if kind == "rq":
        alpha = torch.exp(log_extra.to(dtype=xs.dtype, device=xs.device).reshape(()))
    else:
        alpha = var.new_ones(())
    scal = torch.stack([var, alpha])
    work = torch.empty((lib.radial_contract_workspace_bytes(n, d, dy, xs.element_size()),),
                       dtype=torch.uint8, device=xs.device)
    fn = lib.radial_contract_f32 if xs.dtype == torch.float32 else lib.radial_contract_f64
    with torch.cuda.device(xs.device):
        code = fn(
            Kinv.data_ptr(), A.data_ptr(), xs.data_ptr(), scal.data_ptr(), rowsum.data_ptr(),
            mx.data_ptr(), work.data_ptr(), out.data_ptr(), n, d, dy, KINDS.index(kind),
            torch.cuda.current_stream().cuda_stream,
        )
    if code != 0:
        raise RuntimeError(
            f"radial_contractions launch failed: {lib.radial_contract_error_string(code).decode()}"
        )
    radial_contractions.launches += 1
    return out[0], rowsum, mx, out[1]


#: Number of kernel launches made by :func:`radial_contractions` in this process.
radial_contractions.launches = 0
