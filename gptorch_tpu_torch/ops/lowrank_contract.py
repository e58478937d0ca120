"""The backward contraction of the matrix-free exact GP: a hand-written
Hopper kernel (K4) and its plain twin.

For a low-rank, possibly asymmetric W = Wl·Wrᵀ (Wl, Wr: (n, r)) and the
radial maps G, E (and F for ``rq``) of r² = ‖x̃ᵢ − x̃ⱼ‖²
(:mod:`~gptorch_tpu_torch.ops.gpr_fast`):

    svar        = Σᵢⱼ Wᵢⱼ Gᵢⱼ
    grad_ell_q  = Σᵢⱼ Wᵢⱼ Eᵢⱼ (x̃ᵢq − x̃ⱼq)²
    sextra      = Σᵢⱼ Wᵢⱼ Fᵢⱼ     (0 for kinds without F)

:func:`lowrank_contractions` replaces the JAX package's
``_lowrank_contractions`` (``gptorch_tpu/ops/iterative.py:454-517``), which
XLA fuses on the TPU.  On a CUDA tensor it launches
``csrc/lowrank_contract.cu`` (see the note at its top).  G, E and F are
symmetric in (i, j), so the kernel visits each unordered pair once, weighted
by Sᵢⱼ = Wᵢⱼ + Wⱼᵢ (Wᵢᵢ on the diagonal).  :func:`_lowrank_records` packs
each point's x̃ (scaled for rbf) and its factor rows, interleaved, into one
aligned record, so that Sᵢⱼ is one dot product of a row's record (pairs
swapped) with a column's.  Each thread holds a few rows in registers and
walks the column tiles at or below its strip's diagonal; the length-scale
terms come from the same differences r² is summed from.  Nothing n² is
stored, and the sums go per block in float64 in a fixed order, without
atomics: a gradient is the same from run to run.  The function needs
n(n + 1)/2 · (4d + 4r + 11) operations (5.9 ms at n = 100000, d = 8, r = 9
on an H100 in float32); the kernel is bound by instruction issue, about 57
a pair there.  On a CPU tensor it computes
:func:`lowrank_contractions_plain`, the JAX package's slab loop, which is
also the reference the kernel is tested against;
:func:`lowrank_contractions_pairs` repeats the kernel's sum over unordered
pairs in plain torch, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .gpr_fast import _radial_maps
from .mvm import RBF_EXP2

#: Kinds of the kernel, in the order of its compile-time switch.
KINDS = ("rbf", "matern12", "matern32", "matern52", "rq")
#: The widest inputs the kernel takes, and the columns of Wl and Wr one
#: launch takes (wider factors go in chunks of this many, one launch each).
MAX_D, MAX_RANK = 32, 16
#: rbf's records hold s·x̃, s = √(log₂e / 2), so that exp(−r²/2) = 2^(−‖s·Δ‖²).
RBF_SCALE = math.sqrt(-RBF_EXP2)


def _slab_loop(kind, xs, var, Wl, Wr, slab, log_extra, absolute):
    """The loop of iterative.py:465-517; ``absolute`` sums |W|·G, |W|·E·Δ²
    and |W|·|F| with |W| bounded by |Wl|·|Wr|ᵀ instead (the scales of
    :func:`lowrank_scales`)."""
    n, d = xs.shape
    if absolute:
        Wl, Wr = Wl.abs(), Wr.abs()
    xsn = torch.sum(xs * xs, dim=1)
    sl = min(slab, n)
    svar = xs.new_zeros(())
    sextra = xs.new_zeros(())
    row_terms = xs.new_zeros((d,))
    colsum = xs.new_zeros((n,))
    for s in range(-(-n // sl)):
        lo = min(s * sl, n - sl)
        xs_s = xs[lo : lo + sl]
        r2 = torch.sum(xs_s**2, dim=1, keepdim=True) + xsn[None, :] - 2.0 * (xs_s @ xs.mT)
        r2[:, lo : lo + sl].diagonal().zero_()  # the self-distances, exactly (see below)
        G_s, E_s, F_s = _radial_maps(kind, torch.clamp(r2, min=0.0), var, log_extra)
        W_s = Wl[lo : lo + sl] @ Wr.mT
        if s * sl > lo:  # overlapping final slab: zero the re-visited rows
            W_s = torch.where((torch.arange(sl, device=xs.device) >= s * sl - lo)[:, None], W_s, 0.0)
        M_s = W_s * E_s
        svar = svar + torch.sum(W_s * G_s)
        if F_s is not None:
            sextra = sextra + torch.sum(W_s * (F_s.abs() if absolute else F_s))
        MX = M_s @ xs
        row_terms = row_terms + (
            torch.sum(torch.sum(M_s, dim=1)[:, None] * torch.square(xs_s), dim=0) - 2.0 * torch.sum(xs_s * MX, dim=0)
        )
        colsum = colsum + torch.sum(M_s, dim=0)
    grad_ell = row_terms + torch.sum(colsum[:, None] * torch.square(xs), dim=0)
    return svar, grad_ell, sextra


def lowrank_contractions_plain(kind, xs, var, Wl, Wr, slab=2048, log_extra=None):
    """Plain PyTorch version of :func:`lowrank_contractions`: the slab loop
    of iterative.py:465-517 (grad_ell by the norm identity, with the column
    sums of W ⊙ E), with one change: each slab's self-distances are set to
    exactly 0, as the JAX package's ``_gram_slab`` (iterative.py:82-87) and
    every Gram of the port do.  The JAX loop leaves the identity's ±eps
    there, which matern12's E = G/r amplifies to about 1e-8 relative in the
    length-scale gradient; the kernel's direct differences give the exact 0."""
    return _slab_loop(kind, xs, var, Wl, Wr, slab, log_extra, absolute=False)


def lowrank_scales(kind, xs, var, Wl, Wr, slab=2048, log_extra=None):
    """The sums of absolute terms behind each output, with |Wᵢⱼ| bounded by
    (|Wl|·|Wr|ᵀ)ᵢⱼ: (Σ|W|G, Σ|W|E(x̃ᵢq − x̃ⱼq)² for each q, Σ|W||F|) (G, E ≥ 0
    for every kind).  Two correct implementations that sum in different
    orders differ by a few units of roundoff of these, so they are the scale
    a comparison's tolerance is stated against."""
    svar, _, sextra = _slab_loop(kind, xs, var, Wl, Wr, slab, log_extra, absolute=True)
    # grad_ell's terms are nonnegative once |W| replaces W, but the norm
    # identity cancels; sum them from direct differences instead.
    n, d = xs.shape
    Wl, Wr = Wl.abs(), Wr.abs()
    ell = xs.new_zeros((d,))
    sl = min(slab, n)
    for lo in range(0, n, sl):
        diff = xs[lo : lo + sl, None, :] - xs[None, :, :]
        _, E_s, _ = _radial_maps(kind, torch.sum(diff * diff, dim=-1), var, log_extra)
        ell = ell + torch.einsum("ij,ijq->q", (Wl[lo : lo + sl] @ Wr.mT) * E_s, diff * diff)
    return svar, ell, sextra


def _layout(dtype, d, r):
    """(MAXD, P, record width) of a launch of r ≤ :data:`MAX_RANK` columns
    (the kernel's rule, which its plan reports): the inputs padded to 8, 16
    or 32 and the 2r interleaved factor columns rounded up to 4 in float32
    (8 in float64)."""
    maxd = 8 if d <= 8 else (16 if d <= 16 else 32)
    step = 4 if dtype == torch.float32 else 8
    p = -(-2 * r // step) * step
    return maxd, p, maxd + p


def _lowrank_records(xs, Wl, Wr, kind, maxd, width):
    """The kernel's records of one launch, (n, width): row j is [x'ⱼ
    (zero-padded to ``maxd``) | Wlⱼ₀, Wrⱼ₀, Wlⱼ₁, Wrⱼ₁, … | zeros], with
    x' = :data:`RBF_SCALE`·x̃ for rbf and x̃ otherwise."""
    n, d = xs.shape
    r = Wl.shape[1]
    rec = xs.new_zeros((n, width))
    rec[:, :d] = xs * RBF_SCALE if kind == "rbf" else xs
    rec[:, maxd : maxd + 2 * r] = torch.stack([Wl, Wr], dim=2).reshape(n, 2 * r)
    return rec


def lowrank_contractions_pairs(kind, xs, var, Wl, Wr, log_extra=None, rows=256, tile=128):
    """The kernel's sum in plain torch, for the tests: for each chunk of
    :data:`MAX_RANK` columns, the records of :func:`_lowrank_records`; strips
    of ``rows`` rows against the column tiles of ``tile`` records at or below
    their diagonal, in order; each unordered pair once, weighted by
    Sᵢⱼ = [Wrᵢ, Wlᵢ]·[Wlⱼ, Wrⱼ] (pairs interleaved) = Wⱼᵢ + Wᵢⱼ, and the
    diagonal by Sᵢᵢ / 2 = Wᵢᵢ; rbf's map 2^(−t) on its scaled records and
    its length-scale sums scaled back."""
    n, d = xs.shape
    svar, ell, sextra = xs.new_zeros(()), xs.new_zeros((d,)), xs.new_zeros(())
    for c0 in range(0, Wl.shape[1], MAX_RANK):
        wl, wr = Wl[:, c0 : c0 + MAX_RANK], Wr[:, c0 : c0 + MAX_RANK]
        maxd, _, width = _layout(xs.dtype, d, wl.shape[1])
        rec = _lowrank_records(xs, wl, wr, kind, maxd, width)
        x, w = rec[:, :maxd], rec[:, maxd:]
        a = w.reshape(n, -1, 2).flip(2).reshape(n, -1)  # a row's factors, each pair swapped
        for lo in range(0, n, rows):
            for j0 in range(0, min(n, lo + rows), tile):
                diff = x[lo : lo + rows, None, :] - x[None, j0 : j0 + tile, :]
                sq = diff * diff
                r2 = sq.sum(dim=-1)
                S = a[lo : lo + rows] @ w[j0 : j0 + tile].mT
                i = torch.arange(lo, min(n, lo + rows), device=xs.device)[:, None]
                j = torch.arange(j0, min(n, j0 + tile), device=xs.device)[None, :]
                S = S * torch.where(j < i, 1.0, torch.where(j == i, 0.5, 0.0)).to(S.dtype)
                if kind == "rbf":
                    G = E = var * torch.exp2(-r2)
                    F = None
                else:
                    G, E, F = _radial_maps(kind, r2, var, log_extra)
                svar = svar + torch.sum(S * G)
                ell = ell + torch.einsum("ij,ijq->q", S * E, sq)[:d]
                if F is not None:
                    sextra = sextra + torch.sum(S * F)
    return svar, ell / RBF_SCALE**2 if kind == "rbf" else ell, sextra


def _check(kind, xs, Wl, Wr):
    if kind not in KINDS:
        raise ValueError(f"lowrank_contractions: unknown kind {kind!r}; one of {KINDS}")
    for name, t in (("xs", xs), ("Wl", Wl), ("Wr", Wr)):
        if not isinstance(t, torch.Tensor) or t.ndim != 2:
            raise ValueError(f"lowrank_contractions: {name} must be a 2-D tensor")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"lowrank_contractions: {name} has dtype {t.dtype}; float32 or float64 only")
        if t.dtype != xs.dtype or t.device != xs.device:
            raise TypeError("lowrank_contractions: xs, Wl and Wr must share dtype and device")
    if Wl.shape != Wr.shape or Wl.shape[0] != xs.shape[0]:
        raise ValueError(
            f"lowrank_contractions: shapes xs {tuple(xs.shape)}, Wl {tuple(Wl.shape)}, Wr {tuple(Wr.shape)} "
            "do not agree"
        )


@functools.cache
def _kernel_library():
    lib = _build.library("lowrank_contract")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.lowrank_contract_f32, lib.lowrank_contract_f64):
        fn.argtypes = [ptr] * 4 + [i32] * 4 + [ctypes.POINTER(ctypes.c_int64), ptr]
        fn.restype = i32
    lib.lowrank_contract_plan.argtypes = [i32] * 5 + [ctypes.POINTER(ctypes.c_int64)]
    lib.lowrank_contract_plan.restype = i32
    for fn in (lib.lowrank_contract_max_d, lib.lowrank_contract_max_rank):
        fn.argtypes = []
        fn.restype = i32
    lib.lowrank_contract_error_string.argtypes = [i32]
    lib.lowrank_contract_error_string.restype = ctypes.c_char_p
    if (lib.lowrank_contract_max_d(), lib.lowrank_contract_max_rank()) != (MAX_D, MAX_RANK):
        raise RuntimeError("lowrank_contract: the built library's limits differ from MAX_D, MAX_RANK")
    return lib


def lowrank_contractions(kind, xs, var, Wl, Wr, slab=2048, log_extra=None):
    """(svar, grad_ell (d,), sextra) of W = Wl·Wrᵀ against the radial maps
    of ``kind`` on ``xs``; the signature of the JAX package's
    ``_lowrank_contractions``.

    :param xs: (n, d) length-scale-scaled inputs.
    :param var: the kernel variance, a 0-d tensor.
    :param Wl, Wr: (n, r) factors of W.
    :param slab: the plain twin's row-slab size (the kernel ignores it).
    :param log_extra: (1,) log α for ``rq``; ignored by the other kinds.

    CUDA tensors pack the kernel's records (:func:`_lowrank_records`) and
    launch it, once per chunk of :data:`MAX_RANK` columns of the factors
    (each counted in ``lowrank_contractions.launches``); it takes d ≤ 32
    and raises ``ValueError`` beyond.  CPU tensors take
    :func:`lowrank_contractions_plain`.
    """
    _check(kind, xs, Wl, Wr)
    if xs.device.type == "cpu":
        return lowrank_contractions_plain(kind, xs, var, Wl, Wr, slab, log_extra)
    if xs.device.type != "cuda":
        raise ValueError(f"lowrank_contractions: unsupported device {xs.device}")
    n, d = xs.shape
    r = Wl.shape[1]
    if d > MAX_D:
        raise ValueError(f"lowrank_contractions: the kernel takes d <= {MAX_D}; got d = {d}")
    if n == 0 or r == 0:
        return xs.new_zeros(()), xs.new_zeros((d,)), xs.new_zeros(())
    lib = _kernel_library()
    var = torch.as_tensor(var, dtype=xs.dtype, device=xs.device).reshape(())
    if kind == "rq":
        alpha = torch.exp(log_extra.to(dtype=xs.dtype, device=xs.device).reshape(()))
    else:
        alpha = var.new_ones(())
    scal = torch.stack([var, alpha])
    fn = lib.lowrank_contract_f32 if xs.dtype == torch.float32 else lib.lowrank_contract_f64
    plan = (ctypes.c_int64 * 6)()  # [MAXD, P, record width, workspace bytes, grid, items a block]
    outs = []
    with torch.cuda.device(xs.device):
        for c0 in range(0, r, MAX_RANK):
            rc = min(MAX_RANK, r - c0)
            code = lib.lowrank_contract_plan(xs.element_size(), n, d, rc, KINDS.index(kind), plan)
            if code == 0:
                maxd, _, width, work_bytes = plan[:4]
                rec = _lowrank_records(xs, Wl[:, c0 : c0 + rc], Wr[:, c0 : c0 + rc], kind, maxd, width)
                work = torch.empty((work_bytes,), dtype=torch.uint8, device=xs.device)
                out = xs.new_empty((d + 2,))
                code = fn(
                    rec.data_ptr(), scal.data_ptr(), work.data_ptr(), out.data_ptr(), n, d, rc, KINDS.index(kind),
                    plan, torch.cuda.current_stream().cuda_stream,
                )
            if code != 0:
                raise RuntimeError(
                    f"lowrank_contractions launch failed: {lib.lowrank_contract_error_string(code).decode()}"
                )
            lowrank_contractions.launches += 1
            outs.append(out)
    total = outs[0] if len(outs) == 1 else torch.stack(outs).sum(dim=0)
    return total[0], total[1 : d + 1], total[d + 1]


#: Number of kernel launches made by :func:`lowrank_contractions` in this process.
lowrank_contractions.launches = 0
