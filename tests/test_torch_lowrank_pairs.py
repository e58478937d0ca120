"""The algebra of the backward contraction's kernel (K4), on the CPU in
float64: each unordered pair once, weighted by Sᵢⱼ = Wᵢⱼ + Wⱼᵢ from the
interleaved records (Wᵢᵢ on the diagonal), rbf's scaled records, and the
chunks of 16 factor columns (ops/lowrank_contract.py
``lowrank_contractions_pairs``, ``_lowrank_records``, ``_layout``), against
the JAX package's ``_lowrank_contractions`` and the port's plain twin.  The
kernel itself needs a card (tests/test_torch_cuda.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu.ops import iterative as ji
from gptorch_tpu_torch.ops import gpr_fast, lowrank_contract

KINDS = list(lowrank_contract.KINDS)
LOG_ALPHA = np.log([0.7])
# Two correct sums in other orders differ by a few units of roundoff of the
# sums of absolute terms (lowrank_contract.lowrank_scales).
TOL = 1e-10


def _inputs(n, r, form, d=3, seed=0):
    rng = np.random.RandomState(seed + n + r)
    xs = rng.randn(n, d) / 1.1
    Wl = rng.randn(n, r)
    if form == "symmetric":
        Wr = Wl
    elif form == "gv":  # radial_mvm's backward: W = g·Vᵀ, g a cotangent of another scale
        Wl, Wr = 1e-3 * rng.randn(n, r), rng.randn(n, r)
    else:
        Wr = rng.randn(n, r)
    return xs, Wl, Wr


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _identity_floor(kind, xs, Wl, Wr):
    """The plain twin's grad_ell by the norm identity cancels: Σ rowsum·x̃² +
    Σ colsum·x̃² − 2 Σ x̃·(M x̃) leaves up to 4u·Σ|W|E(x̃ᵢq² + x̃ⱼq²), which
    matters where the true terms are 0 (n = 1: the diagonal alone)."""
    _, E, _ = gpr_fast._radial_maps(kind, torch.cdist(xs, xs) ** 2, _t(1.3), _t(LOG_ALPHA))
    WE = (Wl.abs() @ Wr.abs().T) * E.abs()
    return 4 * 2.0**-52 * (WE.sum(dim=1) @ xs**2 + WE.sum(dim=0) @ xs**2)


def _assert_close(got, want, scales, floors=(0.0, 0.0, 0.0)):
    for g, w, s, f in zip(got, want, scales, floors):
        assert bool(torch.all((g - w).abs() <= TOL * s + f)), (g, w, s)


@pytest.mark.parametrize("dtype, d, r, layout", [
    (torch.float32, 8, 9, (8, 20, 28)), (torch.float32, 3, 1, (8, 4, 12)), (torch.float32, 9, 16, (16, 32, 48)),
    (torch.float32, 32, 5, (32, 12, 44)), (torch.float64, 8, 9, (8, 24, 32)), (torch.float64, 1, 1, (8, 8, 16)),
    (torch.float64, 17, 16, (32, 32, 64)),
])
def test_layout(dtype, d, r, layout):
    """MAXD, the factor columns (2r rounded up to 4 in float32, 8 in
    float64) and the record width, a whole number of 16-byte copies."""
    assert lowrank_contract._layout(dtype, d, r) == layout
    assert layout[2] * torch.empty((), dtype=dtype).element_size() % 16 == 0


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("kind", ["rbf", "matern32"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_records_layout(dtype, kind, strided):
    """[x' (zero-padded to MAXD) | Wl₀, Wr₀, Wl₁, Wr₁, … | zeros], x' the
    inputs (scaled for rbf), for contiguous and strided factors."""
    n, d, r = 37, 5, 7
    rng = np.random.RandomState(1)
    xs = torch.tensor(rng.randn(n, d), dtype=dtype)
    W = torch.tensor(rng.randn(n, 2 * r), dtype=dtype)
    Wl, Wr = (W[:, ::2], W[:, 1::2]) if strided else (W[:, :r].contiguous(), W[:, r:].contiguous())
    assert Wl.is_contiguous() is not strided
    maxd, p, width = lowrank_contract._layout(dtype, d, r)
    rec = lowrank_contract._lowrank_records(xs, Wl, Wr, kind, maxd, width)
    assert rec.shape == (n, width) and rec.dtype == dtype and rec.is_contiguous()
    scale = lowrank_contract.RBF_SCALE if kind == "rbf" else 1.0
    assert torch.equal(rec[:, :d], xs * scale)
    assert torch.equal(rec[:, maxd : maxd + 2 * r : 2], Wl)
    assert torch.equal(rec[:, maxd + 1 : maxd + 2 * r : 2], Wr)
    assert not rec[:, d:maxd].any() and not rec[:, maxd + 2 * r :].any()


def test_rbf_scale():
    """exp(−r²/2) = 2^(−‖s·Δ‖²) with s = RBF_SCALE."""
    r2 = torch.linspace(0.0, 30.0, 61, dtype=torch.float64)
    s2 = lowrank_contract.RBF_SCALE**2
    torch.testing.assert_close(torch.exp2(-s2 * r2), torch.exp(-0.5 * r2), rtol=1e-14, atol=0.0)


# (n, r, W, rows): n across a thread's rows, a 128-record tile and its
# diagonal, and a 256-row strip; r across the rounding of 2r and the chunks
# of 16; the kernel's strips of 128 rows (one a thread: float64, wide
# float32 records), 256 (two) and 512 (four: float32 at d <= 8, r <= 10)
CASES = [
    (1, 1, "asymmetric", 512), (1, 4, "symmetric", 128), (127, 4, "asymmetric", 128), (127, 17, "gv", 256),
    (128, 5, "symmetric", 512), (128, 16, "asymmetric", 128), (129, 9, "asymmetric", 512), (129, 33, "symmetric", 128),
    (129, 1, "gv", 128), (257, 16, "gv", 256), (257, 9, "symmetric", 128), (257, 5, "asymmetric", 256),
    (600, 17, "asymmetric", 128), (600, 33, "gv", 256), (600, 1, "symmetric", 512),
]


@pytest.mark.parametrize("n, r, form, rows", CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_pairs_match_plain(kind, n, r, form, rows):
    xs, Wl, Wr = (_t(a) for a in _inputs(n, r, form))
    args = (kind, xs, _t(1.3), Wl, Wr)
    got = lowrank_contract.lowrank_contractions_pairs(*args, _t(LOG_ALPHA), rows=rows)
    want = lowrank_contract.lowrank_contractions_plain(*args, 128, _t(LOG_ALPHA))
    scales = lowrank_contract.lowrank_scales(*args, 128, _t(LOG_ALPHA))
    _assert_close(got, want, scales, (0.0, _identity_floor(kind, xs, Wl, Wr), 0.0))
    if kind != "rq":
        assert float(got[2]) == 0.0


@functools.cache
def _jax_contractions(kind):
    extra = jnp.asarray(LOG_ALPHA) if kind == "rq" else None
    return jax.jit(lambda xs, var, Wl, Wr: ji._lowrank_contractions(kind, xs, var, Wl, Wr, 128, extra))


@pytest.mark.parametrize("form", ["asymmetric", "symmetric", "gv"])
@pytest.mark.parametrize("kind", KINDS)
def test_pairs_match_jax(kind, form):
    """Against the reference itself (jitted on the CPU) at n = 257, r = 9."""
    xs, Wl, Wr = _inputs(257, 9, form)
    want = _jax_contractions(kind)(jnp.asarray(xs), jnp.asarray(1.3), jnp.asarray(Wl), jnp.asarray(Wr))
    args = (kind, _t(xs), _t(1.3), _t(Wl), _t(Wr))
    got = lowrank_contract.lowrank_contractions_pairs(*args, _t(LOG_ALPHA))
    scales = lowrank_contract.lowrank_scales(*args, 128, _t(LOG_ALPHA))
    _assert_close(got, [_t(w) for w in want], scales, (0.0, _identity_floor(kind, *args[1:2], *args[3:]), 0.0))


@pytest.mark.parametrize("kind", KINDS)
def test_single_point_is_the_diagonal(kind):
    """n = 1: only the diagonal pair, weighted by S₁₁ / 2 = W₁₁; its r² is
    exactly 0, so the length-scale sums are exactly 0."""
    xs, Wl, Wr = (_t(a) for a in _inputs(1, 5, "asymmetric"))
    svar, ell, sextra = lowrank_contract.lowrank_contractions_pairs(kind, xs, _t(1.3), Wl, Wr, _t(LOG_ALPHA))
    torch.testing.assert_close(svar, 1.3 * (Wl @ Wr.T)[0, 0], rtol=1e-15, atol=0.0)
    assert not ell.any() and float(sextra) == 0.0
