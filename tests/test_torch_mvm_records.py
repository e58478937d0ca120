"""The records the matrix-free product's kernel (K3) reads, on the CPU in
float64: the centring, the norm identity with rbf's constant folded
(ops/mvm.py ``_mvm_records``) and the aligned, padded layout of a pass
(``_pack_records``).  The kernel itself needs a card
(tests/test_torch_cuda.py)."""

import math

import numpy as np
import pytest
import torch

from gptorch_tpu_torch.ops import mvm

U64 = 2.0**-53
KINDS = list(mvm.KINDS)


def _inputs(n, d, offset, seed=0):
    rng = np.random.RandomState(seed)
    return torch.tensor(rng.randn(n, d) / 1.1 + offset)


def _exponent(u, beta, y):
    """t_ij = βᵢ + βⱼ + uᵢ·yⱼ, the kernel's formula."""
    return beta[:, None] + beta[None, :] + u @ y.T


def _scaled_r2(kind, x):
    """c·‖xᵢ − xⱼ‖² by direct differences."""
    c = mvm.RBF_EXP2 if kind == "rbf" else 1.0
    return c * ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)


@pytest.mark.parametrize("offset", [0.0, 40.0])
@pytest.mark.parametrize("kind", KINDS)
def test_norm_identity_matches_direct_differences(kind, offset):
    x = _inputs(60, 5, offset)
    u, beta, y = mvm._mvm_records(x, kind)
    t = _exponent(u, beta, y)
    want = _scaled_r2(kind, x)
    # rounding of the centred identity: a few u·(‖uᵢ‖² + ‖uⱼ‖²) per entry,
    # whatever the offset (centring x + 40 subtracts exactly)
    spread = float(torch.sum(u * u, dim=1).max())
    assert float((t - want).abs().max()) <= 16 * U64 * (spread + 1.0)
    assert float(want.abs().max()) > 1.0  # the distances are not all tiny


@pytest.mark.parametrize("kind", KINDS)
def test_diagonal_is_zero_to_rounding(kind):
    x = _inputs(40, 8, 3.0, seed=1)
    u, beta, y = mvm._mvm_records(x, kind)
    diag = _exponent(u, beta, y).diagonal()
    # not exactly 0 here: the kernel sets r² on the diagonal to exactly 0
    # itself, as the reference does (iterative.py:82-87).  Two adds and a
    # d-term dot product, each rounding terms up to 2‖uᵢ‖²:
    d = x.shape[1]
    assert bool(torch.all(diag.abs() <= 2 * (d + 2) * U64 * torch.sum(u * u, dim=1)))


@pytest.mark.parametrize("kind", KINDS)
def test_centring_leaves_distances_unchanged(kind):
    x = _inputs(50, 3, 0.0, seed=2)
    t0 = _exponent(*mvm._mvm_records(x, kind))
    t1 = _exponent(*mvm._mvm_records(x + 40.0, kind))
    u, _, _ = mvm._mvm_records(x, kind)
    # both centre to the same points, up to the rounding of x + 40 (δ = 2⁻⁴⁸
    # a coordinate, so 4δ·Σ|xᵢq − xⱼq| in r²) and the identity's own
    d, spread = x.shape[1], float(torch.sum(u * u, dim=1).max())
    bound = 8 * 2.0**-48 * d * float(u.abs().max()) + 32 * U64 * (spread + 1.0)
    assert float((t0 - t1).abs().max()) <= bound
    # the records are centred: the row vectors have zero column means
    assert float(u.mean(dim=0).abs().max()) <= 1e-14


def test_rbf_folds_the_base_two_constant():
    x = _inputs(30, 4, 0.0, seed=3)
    u, beta, y = mvm._mvm_records(x, "rbf")
    assert torch.equal(y, 2.0 * u)  # y = 2u exactly: tᵢⱼ and tⱼᵢ round alike
    assert torch.equal(beta, -torch.sum(u * u, dim=1))
    g = torch.exp2(torch.clamp(_exponent(u, beta, y), max=0.0))
    want = torch.exp(-0.5 * ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1))
    torch.testing.assert_close(g, want, rtol=1e-13, atol=1e-15)
    assert math.isclose(mvm.RBF_EXP2, -0.5 / math.log(2.0), rel_tol=1e-15)


@pytest.mark.parametrize("n, d, k, maxd, kc, width", [(7, 3, 1, 8, 1, 12), (9, 8, 9, 8, 12, 24),
                                                      (5, 9, 40, 16, 32, 52), (4, 2, 5, 8, 8, 18)])
def test_records_layout_and_zero_padding(n, d, k, maxd, kc, width):
    rng = np.random.RandomState(n + k)
    x, V = torch.tensor(rng.randn(n, d)), torch.tensor(rng.randn(n, k))
    _, beta, y = mvm._mvm_records(x, "matern32")
    rec = mvm._pack_records(beta, y, V, maxd, kc, width)
    passes = -(-k // kc)
    assert rec.shape == (passes, n, width) and rec.is_contiguous()
    assert torch.equal(rec[:, :, :d], y.expand(passes, n, d))
    assert torch.equal(rec[:, :, maxd], beta.expand(passes, n))
    cols = torch.cat([rec[p, :, maxd + 1 : maxd + 1 + kc] for p in range(passes)], dim=1)
    assert torch.equal(cols[:, :k], V)
    # every other entry is padding, and zero
    assert not bool(cols[:, k:].any())
    assert not bool(rec[:, :, d:maxd].any())
    assert not bool(rec[:, :, maxd + 1 + kc :].any())


def test_records_follow_non_contiguous_inputs():
    rng = np.random.RandomState(5)
    base = torch.tensor(rng.randn(6, 20))
    x, V = base[:, ::4].T, base[:, 1::2].T  # (5, 6) and (10, 6) views
    x, V = x[:, :3], V[:5, :4]
    _, beta, y = mvm._mvm_records(x, "rbf")
    rec = mvm._pack_records(beta, y, V, 8, 4, 16)
    _, beta_c, y_c = mvm._mvm_records(x.contiguous(), "rbf")
    assert torch.equal(rec, mvm._pack_records(beta_c, y_c, V.contiguous(), 8, 4, 16))
