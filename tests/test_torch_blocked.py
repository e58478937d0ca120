"""The port's blocked factorizations (gptorch_tpu_torch.ops.blocked) against
the JAX package's (gptorch_tpu.ops.blocked), float64 on the CPU, at small n
with small panels so every branch of the algorithms runs.  The JAX side runs
under one ``jax.jit`` per call (eagerly, each of the loops' differently
shaped slices would compile on its own)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu.ops import blocked as jb
from gptorch_tpu_torch.ops import blocked as tb

RTOL, ATOL = 1e-10, 1e-12


def _spd(n, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(n, n)
    return a @ a.T / n + 0.5 * np.eye(n)


def _lower(n, seed=0):
    return np.linalg.cholesky(_spd(n, seed))


def _jx(fn, *arrays):
    """fn(*arrays) through one jax.jit, on jnp copies of numpy arrays."""
    return jax.jit(fn)(*[jnp.asarray(a) for a in arrays])


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "algo, n, nb", [("dc", 150, 32), ("dc", 256, 64), ("dc", 40, 64), ("right", 150, 32), ("right", 256, 64)]
)
def test_blocked_cholesky_matches_jax(algo, n, nb):
    a = _spd(n, seed=n + nb)
    A = _t(a)
    got = tb.blocked_cholesky(A, nb, algo=algo, solve_block=16)
    _close(got, _jx(lambda m: jb.blocked_cholesky(m, nb, algo=algo, solve_block=16), a))
    _close(got, np.linalg.cholesky(a))
    assert torch.equal(A, _t(a)), "blocked_cholesky overwrote its input"


@pytest.mark.parametrize("algo", ["dc", "right"])
def test_lower_only_keeps_the_lower_triangle(algo):
    a = _spd(192, seed=3)
    got = tb.blocked_cholesky(_t(a), 64, lower_only=True, algo=algo, solve_block=16)
    want = _jx(lambda m: jb.blocked_cholesky(m, 64, lower_only=True, algo=algo, solve_block=16), a)
    _close(torch.tril(got), jnp.tril(want))


def test_consumers_read_only_the_lower_triangle():
    """The right-looking loop with lower_only=True leaves leftovers of K
    above the diagonal; every consumer must give the same answer as on the
    clean factor.  Garbage (large values) above the diagonal checks it."""
    n = 160
    a = _spd(n, seed=4)
    L_left = tb.blocked_cholesky(_t(a), 32, lower_only=True, algo="right", solve_block=16)
    assert torch.triu(L_left, 1).abs().max() > 0, "expected leftovers above the diagonal"
    clean = torch.tril(L_left)
    garbage = clean + torch.triu(_t(np.random.RandomState(5).randn(n, n) * 1e3), 1)
    b = _t(np.random.RandomState(6).randn(n, 3))
    for L in (L_left, garbage):
        for trans in (0, 1):
            _close(tb.blocked_ltrsm(L, b, leaf=32, trans=trans), tb.blocked_ltrsm(clean, b, leaf=32, trans=trans))
        _close(tb.blocked_trtri(L, 32), tb.blocked_trtri(clean, 32))
        _close(tb._solve_lower(L, b), tb._solve_lower(clean, b))
        _close(tb._solve_lower_t(L, b), tb._solve_lower_t(clean, b))
        assert torch.equal(torch.diagonal(L), torch.diagonal(clean))


def test_in_place_divide_and_conquer_branch(monkeypatch):
    """_DC_CONCAT_MAX made small in both packages: the outer levels split
    in place on the buffer, inner blocks are assembled by concatenation."""
    monkeypatch.setattr(jb, "_DC_CONCAT_MAX", 64)
    monkeypatch.setattr(tb, "_DC_CONCAT_MAX", 64)
    a = _spd(160, seed=7)
    for lower_only in (False, True):
        got = tb._chol_dc(_t(a), 16, 8, None, lower_only)
        want = _jx(lambda m: jb._chol_dc(m, 16, 8, None, lower_only), a)
        _close(got, want)
    A = _t(a)
    # n <= nb routes big leaves (n > 1024 there) through _chol_dc; the public
    # function on the right-looking path with n a multiple of nb must copy.
    got = tb.blocked_cholesky(A, 40, algo="right", solve_block=8)
    _close(got, np.linalg.cholesky(a))
    assert torch.equal(A, _t(a))


def test_rtrsm_and_panel_trsm_match_jax():
    lkk = _lower(64, seed=8)
    panel = np.random.RandomState(9).randn(50, 64)
    _close(tb._rtrsm(_t(lkk), _t(panel), 8), _jx(lambda l, p: jb._rtrsm(l, p, 8), lkk, panel))
    for nb2 in (0, 16, 24):
        _close(tb._panel_trsm(_t(lkk), _t(panel), nb2), _jx(lambda l, p: jb._panel_trsm(l, p, nb2), lkk, panel))
    _close(tb._chol_dc_concat(_t(_spd(96, 10)), 16, 8, None), _jx(lambda m: jb._chol_dc_concat(m, 16, 8, None), _spd(96, 10)))


@pytest.mark.parametrize("trans", [0, 1])
@pytest.mark.parametrize("n, leaf", [(200, 32), (37, 64)])
def test_blocked_ltrsm_matches_jax(trans, n, leaf):
    L = _lower(n, seed=11)
    b = np.random.RandomState(12).randn(n, 3)
    got = tb.blocked_ltrsm(_t(L), _t(b), leaf=leaf, trans=trans)
    _close(got, _jx(lambda l, r: jb.blocked_ltrsm(l, r, leaf=leaf, trans=trans), L, b))
    _close(got, np.linalg.solve(L.T if trans else L, b), rtol=1e-9)


@pytest.mark.parametrize(
    "name, args",
    [("tril_square", (32,)), ("tril_square", (48,)), ("tril_square_rec", (32, 64)), ("tril_square_dc", (32,))],
)
def test_tril_square_variants_match_jax(name, args):
    Linv = np.linalg.inv(_lower(160, seed=13))
    got = getattr(tb, name)(_t(Linv), *args)
    _close(got, _jx(lambda m: getattr(jb, name)(m, *args), Linv))
    _close(got, Linv.T @ Linv)


def test_syrk_and_trtri_match_jax():
    B = np.random.RandomState(14).randn(30, 100)
    _close(tb._syrk_lower(_t(B), 32), _jx(lambda m: jb._syrk_lower(m, 32), B))
    L = _lower(150, seed=15)
    _close(tb.blocked_trtri(_t(L), 32), _jx(lambda m: jb.blocked_trtri(m, 32), L))


def test_cholesky_blocked_gradient_matches_jax():
    a = _spd(96, seed=16)
    w = np.random.RandomState(17).randn(96, 96)
    A = _t(a).requires_grad_()
    (torch.sum(_t(w) * tb.cholesky_blocked(A, 32))).backward()
    want = _jx(jax.grad(lambda m, v: jnp.sum(v * jb.cholesky_blocked(m, 32))), a, w)
    _close(A.grad, want, rtol=1e-9)
    # and against autograd through torch's own Cholesky
    B = _t(a).requires_grad_()
    (torch.sum(_t(w) * torch.linalg.cholesky(B))).backward()
    _close(A.grad, B.grad.numpy(), rtol=1e-9)


def test_failed_leaf_is_nan():
    a = -np.eye(64)
    assert torch.isnan(torch.diagonal(tb.blocked_cholesky(_t(a), 16, algo="right"))).all()
