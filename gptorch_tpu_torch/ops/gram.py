"""The radial (RBF) Gram matrix: a hand-written Hopper kernel and its plain twin.

    out[i, j] = var · exp(−½ ‖x1[i] − x2[j]‖²)   (+ diag where i == j, symmetric case)

on inputs already divided by the length scales; with a leading batch axis,
B such Grams, each with its own ``var`` and ``diag``.

:func:`rbf_gram` replaces the JAX package's Pallas TPU kernel
``gptorch_tpu/ops/pallas_gram.py:_rbf_tile_kernel``.  On a CUDA tensor it
launches ``csrc/rbf_gram.cu`` (see the note at its top) in the mapping that
:func:`plan` picks from the shape: output tiles with 16-byte streaming
stores (scalar stores where rows are not 16-byte aligned), walked by a
persistent grid (many float32 tiles) or a block a tile, a symmetric
Gram's lower triangle only,
mirrored through shared memory; a warp per member for batches of Grams of
at most 32×32; a thread per row for a single column, per column for a few
rows.  r² comes from direct differences (no
cancellation, an exact 0 on the symmetric diagonal) and ragged shapes are
masked.  ``var`` and ``diag`` are passed as device pointers with a stride
(0 for one value shared by a batch), so a call makes no launch besides the
kernel's and no host synchronisation.  It is bound by the n1·n2 write:
4.29 GB for n = 32768 in float32, about 1.28 ms at the H100's 3.35 TB/s.
On a CPU tensor it computes :func:`rbf_gram_plain`, which is also the
reference the kernel is tested against.

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

import contextlib
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
    broadcast; a Python number becomes a device scalar (on the card one
    cached per value and stream outside a graph capture, so an eager call
    makes no fill), never a host-to-device copy."""
    shape = like.shape[:-2]
    if isinstance(v, torch.Tensor):
        if v.dtype != like.dtype or v.device != like.device:
            v = v.to(dtype=like.dtype, device=like.device)
        if v.ndim == 0 and not shape:
            return v
    elif like.device.type == "cuda" and not torch.cuda.is_current_stream_capturing():
        stream = torch.cuda.current_stream(like.device)
        v = _device_constant(float(v), like.dtype, like.device, stream.cuda_stream)
    else:
        v = torch.full((), float(v), dtype=like.dtype, device=like.device)
    if v.numel() == 1:
        return v.reshape(()).expand(shape)
    return v.reshape(shape)


@functools.lru_cache(maxsize=64)
def _device_constant(value, dtype, device, stream):
    """A 0-d device tensor holding ``value``, made once for the CUDA stream
    ``stream`` (the current one, read only: every user takes views).  It is
    allocated on that stream and read only by launches on it, so when the
    cache lets it go the caching allocator reuses its block after those
    launches; only eager calls use it, so no captured graph holds it."""
    return torch.full((), value, dtype=dtype, device=device)


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


#: The launch's mappings (csrc/rbf_gram.cu's ``Mapping``): tiles of 64
#: columns (128 rows for a float32 Gram of more than 64 rows, else 64) with
#: scalar or 16-byte stores, 64×64 tiles over a symmetric Gram's lower
#: triangle (mirrored), a warp per member of at most 32×32 (and group of
#: rows), a thread per row for n2 = 1, a thread per column for a cross Gram
#: of at most 16 rows.
TILES, TILES_VEC, HALF, HALF_VEC, PACKED, ROWS, COLUMNS = range(7)
MAPPINGS = ("tiles", "tiles_vec", "half", "half_vec", "packed", "rows", "columns")
TILE, THREADS, PACKED_MAX, COLUMNS_MAX, SHORT_ROWS = 64, 256, 32, 16, 64
#: Float32's 16-byte 128-row tiles walk a persistent grid past this many
#: waves of resident blocks (a block a tile below: a few waves end more
#: evenly so; PERF.md).
PERSISTENT_WAVES = 4
#: Rows (n1 or n2) one launch takes (the kernel's ``rbf_gram_max_rows``).
MAX_ROWS = 1 << 30
#: Output tiles one launch walks (the tile index is a 32-bit int).
MAX_TILES = 2**31 - 1


@functools.lru_cache(maxsize=4096)
def plan(batch, n1, n2, sym, itemsize, limits):
    """``(mapping, grid)`` of one launch for ``batch`` Grams of (n1, n2)
    (``sym``: n1 = n2 and x2 = x1) whose elements take ``itemsize`` bytes,
    given ``limits``, the resident blocks of each mapping on the card: the
    grid walks the work with at most that many blocks (a persistent grid),
    except tiles, which take a block a tile unless they are float32's
    16-byte 128-row ones past :data:`PERSISTENT_WAVES` waves.  n2 = 1 takes
    ROWS; members of at most 32×32 PACKED; cross Grams of at most 16 rows
    COLUMNS; the rest tiles, a symmetric Gram's lower triangle mirrored
    (HALF), with 16-byte stores when every row starts 16-byte aligned (n2 a
    multiple of 16 / itemsize: the ``_VEC`` codes).  Raises ``ValueError``
    past one launch's rows or tiles."""
    if max(n1, n2) > MAX_ROWS:
        raise ValueError(f"rbf_gram: {max(n1, n2)} rows exceed one launch's {MAX_ROWS}")
    if n2 == 1:
        mapping, blocks = ROWS, -(-batch * n1 // THREADS)
    elif n1 <= PACKED_MAX and n2 <= PACKED_MAX:
        rows = 32 if batch >= 1024 else 8  # a warp's rows (four warps a member for a small batch)
        mapping, blocks = PACKED, -(-batch * -(-n1 // rows) // (THREADS // 32))
    elif n1 <= COLUMNS_MAX and not sym:
        mapping, blocks = COLUMNS, -(-batch * n2 // THREADS)
    else:
        vec = n2 % (16 // itemsize) == 0
        rows = 2 * TILE if itemsize == 4 and not sym and n1 > SHORT_ROWS else TILE
        rt, ct = -(-n1 // rows), -(-n2 // TILE)
        blocks = batch * (rt * (rt + 1) // 2 if sym else rt * ct)
        if blocks > MAX_TILES:
            raise ValueError(f"rbf_gram: {batch} Grams of ({n1}, {n2}) are {blocks} tiles, past one launch's {MAX_TILES}")
        mapping = (HALF if sym else TILES) + vec
        # One block a tile, scheduled by the card as blocks finish, is the
        # faster on the H100 for mirrored and diagonal tiles, float64's and
        # scalar stores' (their costs differ from tile to tile) and for a
        # few waves of tiles (PERF.md).
        if not (vec and rows == 2 * TILE and blocks > PERSISTENT_WAVES * limits[mapping]):
            return mapping, blocks
    return mapping, min(blocks, limits[mapping])


@functools.cache
def _kernel_library():
    lib = _build.library("rbf_gram")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.rbf_gram_f32, lib.rbf_gram_f64):
        fn.argtypes = [ptr, ptr, ptr, i64, ptr, i64, ptr, i32, i32, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
    lib.rbf_gram_grid_limit.argtypes = [i32, i32]
    lib.rbf_gram_grid_limit.restype = i32
    lib.rbf_gram_error_string.argtypes = [i32]
    lib.rbf_gram_error_string.restype = ctypes.c_char_p
    lib.rbf_gram_max_rows.argtypes = []
    lib.rbf_gram_max_rows.restype = i32
    if lib.rbf_gram_max_rows() != MAX_ROWS:
        raise RuntimeError(f"rbf_gram: the library takes {lib.rbf_gram_max_rows()} rows, the wrapper {MAX_ROWS}")
    return lib


@functools.cache
def _grid_limits(f64, device_index):
    """Resident blocks of each mapping on the card ``device_index``, for
    float64 when ``f64`` (queried once)."""
    lib = _kernel_library()
    with torch.cuda.device(device_index):
        limits = tuple(lib.rbf_gram_grid_limit(int(f64), m) for m in range(len(MAPPINGS)))
    if min(limits) <= 0:
        code = -min(limits)
        raise RuntimeError(f"rbf_gram: occupancy query failed: {lib.rbf_gram_error_string(code).decode()}")
    return limits


def _launch(x1, x2, var, diag, grid=None):
    """One launch of the kernel for one Gram (2-D inputs, 0-d ``var`` and
    ``diag``) or a batch of them (3-D inputs, (B,) ``var`` and ``diag``);
    ``x2`` None is the symmetric case, ``diag`` None adds nothing.  All on
    the card; ``var`` and ``diag`` go as a pointer and a stride each, so the
    call launches the kernel and nothing else.  ``grid`` replaces the plan's
    grid (a test's walk of many tiles a block)."""
    lib = _kernel_library()
    sym = x2 is None
    x2_ = x1 if sym else x2
    batch = x1.shape[0] if x1.ndim == 3 else 1
    n1, d = x1.shape[-2:]
    n2 = x2_.shape[-2]
    f64 = x1.dtype == torch.float64
    device = x1.device.index
    out = torch.empty(x1.shape[:-1] + (n2,), dtype=x1.dtype, device=x1.device)
    if batch == 0 or n1 == 0 or n2 == 0:
        return out
    mapping, planned = plan(batch, n1, n2, sym, x1.element_size(), _grid_limits(f64, device))
    grid = planned if grid is None else grid
    diag_ptr, diag_stride = (None, 0) if diag is None else (diag.data_ptr(), diag.stride(0) if diag.ndim else 0)
    fn = lib.rbf_gram_f64 if f64 else lib.rbf_gram_f32
    guard = contextlib.nullcontext() if device == torch.cuda.current_device() else torch.cuda.device(device)
    with guard:
        code = fn(
            x1.data_ptr(), x2_.data_ptr(), var.data_ptr(), var.stride(0) if var.ndim else 0, diag_ptr, diag_stride,
            out.data_ptr(), batch, n1, n2, d, int(sym), mapping, grid, torch.cuda.current_stream(device).cuda_stream,
        )
    if code != 0:
        raise RuntimeError(f"rbf_gram launch failed: {lib.rbf_gram_error_string(code).decode()}")
    rbf_gram.launches += 1
    return out


def _gram_vjp(g, out, x1, x2, var, diag):
    """Cotangents of (x1, x2, var, diag) for the cotangent ``g`` of
    ``out = rbf_gram(x1, x2, var=var, diag=diag)``, from the saved output;
    over the last two axes, so a batch of Grams gives each member its own.

    With M = g ⊙ (out − diag·I) = g ⊙ G (G the noiseless Gram; ``diag``
    None in the symmetric case adds nothing and has no cotangent):
    ∂/∂var = ΣM / var, ∂/∂diag = tr g, ∂/∂x1 = M x2 − rowsum(M)·x1 and
    ∂/∂x2 = Mᵀ x1 − colsum(M)·x2; in the symmetric case (``x2`` None) the
    two input cotangents are summed into the one input's.
    """
    sym = x2 is None
    M = g * out
    if diag is not None:
        M.diagonal(dim1=-2, dim2=-1).sub_(g.diagonal(dim1=-2, dim2=-1) * diag[..., None])
    x2_ = x1 if sym else x2
    d_x1 = M @ x2_ - M.sum(dim=-1, keepdim=True) * x1
    d_x2 = M.mT @ x1 - M.sum(dim=-2).unsqueeze(-1) * x2_
    d_var = M.sum(dim=(-2, -1)) / var
    if sym:
        d_diag = None if diag is None else g.diagonal(dim1=-2, dim2=-1).sum(dim=-1)
        return d_x1 + d_x2, None, d_var, d_diag
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


class _RbfGramEager(torch.autograd.Function):
    """:class:`_RbfGram` in the ``ctx`` form, for calls outside ``torch.func``
    transforms: for a ``setup_context`` form torch binds the arguments by
    ``inspect.signature`` on every call, host time that each launch pays."""

    @staticmethod
    def forward(ctx, x1, x2, var, diag):
        out = _launch(x1, x2, var, diag)
        ctx.save_for_backward(x1, x2, var, diag, out)
        return out

    backward = staticmethod(_RbfGram.backward)


def rbf_gram(x1, x2=None, *, var, diag=None):
    """var·exp(−½‖x1[i] − x2[j]‖²) (+ ``diag`` on the diagonal when ``x2``
    is None), for scaled inputs ``x1`` (n1, d) and ``x2`` (n2, d), or a
    batch of B Grams from (B, n1, d) and (B, n2, d) in one launch.

    :param var: kernel variance, a number, a tensor with one element, or
        (batch) one per Gram.
    :param diag: value added on the diagonal in the symmetric case (the
        noise variance), in the same forms; ignored for a cross Gram.

    CUDA tensors launch the kernel (and count the launch in
    ``rbf_gram.launches``), differentiably in every tensor argument (through
    an autograd function only where a gradient or a ``torch.func``
    transform needs one); CPU tensors take :func:`rbf_gram_plain`.
    """
    sym = x2 is None
    _check(x1, x1 if sym else x2)
    if x1.device.type == "cpu":
        return rbf_gram_plain(x1, x2, var, diag)
    if x1.device.type != "cuda":
        raise ValueError(f"rbf_gram: unsupported device {x1.device}")
    args = (x1, x2, _scalar(var, x1), _scalar(diag, x1) if sym and diag is not None else None)
    if torch._C._are_functorch_transforms_active():  # vmap, grad, ...: the form with a vmap rule
        return _RbfGram.apply(*args)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        return _RbfGramEager.apply(*args)
    return _launch(*args)


#: Number of kernel launches made by :func:`rbf_gram` in this process.
rbf_gram.launches = 0
