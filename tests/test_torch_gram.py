"""The port's radial Gram (gptorch_tpu_torch.ops.gram) against the JAX package.

The plain version runs here on the CPU and is held against the Pallas
kernel in interpret mode (as tests/test_ops.py runs it) and against the JAX
``kernels.Rbf``.  The hand-written CUDA kernel runs only on a card; its
tests are in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu.ops import rbf_gram as pallas_rbf_gram
from gptorch_tpu_torch.ops import _build, gram


def _direct(x1, x2, var, diag=None):
    """Float64 numpy reference from explicit differences."""
    r2 = ((x1[:, None, :] - x2[None, :, :]) ** 2).sum(-1)
    out = var * np.exp(-0.5 * r2)
    if diag is not None:
        out = out + diag * np.eye(len(x1))
    return out


class TestPlainVsPallas:
    """Float32, tile 128, n = 256, abs 2e-5: the JAX test's own setup."""

    def test_symmetric_with_diag(self):
        x = np.random.RandomState(0).randn(256, 4).astype(np.float32)
        expected = np.asarray(
            pallas_rbf_gram(jnp.asarray(x), log_ell=0.3, log_var=0.2, diag=0.05, tile=128)
        )
        xs = torch.as_tensor(x) / float(np.exp(0.3))
        out = gram.rbf_gram_plain(xs, None, float(np.exp(0.2)), 0.05)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), expected, rtol=0, atol=2e-5)

    def test_cross(self):
        rng = np.random.RandomState(1)
        x1 = rng.randn(256, 3).astype(np.float32)
        x2 = rng.randn(128, 3).astype(np.float32)
        expected = np.asarray(pallas_rbf_gram(jnp.asarray(x1), jnp.asarray(x2), tile=128))
        out = gram.rbf_gram_plain(torch.as_tensor(x1), torch.as_tensor(x2), 1.0)
        np.testing.assert_allclose(out.numpy(), expected, rtol=0, atol=2e-5)


class TestPlainVsJaxRbf:
    @pytest.mark.parametrize("sym", [True, False])
    def test_ard_float64(self, sym):
        rng = np.random.RandomState(2)
        x1, x2 = rng.randn(40, 3), rng.randn(25, 3)
        ell = np.array([0.7, 1.3, 2.1])
        k = jax_kernels.Rbf(3, variance=1.7, length_scales=ell, ARD=True)
        expected = np.asarray(k.K(jnp.asarray(x1)) if sym else k.K(jnp.asarray(x1), jnp.asarray(x2)))
        t1 = torch.as_tensor(x1) / torch.as_tensor(ell)
        t2 = None if sym else torch.as_tensor(x2) / torch.as_tensor(ell)
        out = gram.rbf_gram_plain(t1, t2, 1.7).numpy()
        np.testing.assert_allclose(out, expected, rtol=1e-12, atol=0)
        if sym:
            assert np.all(np.diag(out) == 1.7)  # exact zero self-distance

    def test_diag_matches_kyy(self):
        x = np.random.RandomState(3).randn(30, 2)
        k = jax_kernels.Rbf(2, variance=0.8)
        expected = np.asarray(k.K(jnp.asarray(x))) + 0.3 * np.eye(30)
        out = gram.rbf_gram_plain(torch.as_tensor(x), None, 0.8, 0.3).numpy()
        np.testing.assert_allclose(out, expected, rtol=1e-12, atol=0)


class TestWrapperOnCpu:
    @pytest.mark.parametrize("shape", [(100, 37), (37, 100), (1, 5)])
    def test_ragged_cross(self, shape):
        rng = np.random.RandomState(4)
        x1, x2 = rng.randn(shape[0], 3), rng.randn(shape[1], 3)
        before = gram.rbf_gram.launches
        out = gram.rbf_gram(torch.as_tensor(x1), torch.as_tensor(x2), var=0.9)
        assert gram.rbf_gram.launches == before  # the CPU path launches nothing
        assert out.shape == shape
        np.testing.assert_allclose(out.numpy(), _direct(x1, x2, 0.9), rtol=1e-12, atol=1e-300)

    def test_ragged_symmetric(self):
        x = np.random.RandomState(5).randn(101, 4)
        var = torch.tensor([1.1], dtype=torch.float64)
        out = gram.rbf_gram(torch.as_tensor(x), var=var, diag=torch.tensor(0.2, dtype=torch.float64))
        np.testing.assert_allclose(out.numpy(), _direct(x, x, 1.1, 0.2), rtol=1e-12, atol=1e-300)

    def test_cpu_path_builds_nothing(self, monkeypatch):
        def no_build(name):
            raise AssertionError(f"the CPU path asked for the {name} library")

        monkeypatch.setattr(_build, "library", no_build)
        out = gram.rbf_gram(torch.zeros(3, 2), var=1.0)
        assert torch.equal(out, torch.ones(3, 3))

    def test_plain_is_differentiable(self):
        x = torch.as_tensor(np.random.RandomState(6).randn(7, 2), dtype=torch.float64)
        var = torch.tensor(1.2, dtype=torch.float64, requires_grad=True)
        gram.rbf_gram(x, var=var).sum().backward()
        assert torch.isfinite(var.grad)

    @pytest.mark.parametrize(
        "x1, x2, err",
        [
            (torch.zeros(4, 2).T, None, ValueError),  # not contiguous
            (torch.zeros(4, 2, dtype=torch.int64), None, TypeError),
            (torch.zeros(4), None, ValueError),
            (torch.zeros(4, 2), torch.zeros(3, 3), ValueError),
            (torch.zeros(4, 2, dtype=torch.float32), torch.zeros(3, 2, dtype=torch.float64), TypeError),
        ],
    )
    def test_rejects(self, x1, x2, err):
        with pytest.raises(err):
            gram.rbf_gram(x1, x2, var=1.0)



@pytest.mark.parametrize("sym", [True, False])
def test_backward_formula_matches_autograd_of_plain(sym):
    """The kernel's backward (_gram_vjp, torch ops on the saved output)
    against autograd through the plain version, float64 on the CPU: the
    card runs the same function on the kernel's output."""
    rng = np.random.RandomState(8)
    x1 = torch.tensor(rng.randn(9, 3), requires_grad=True)
    x2 = None if sym else torch.tensor(rng.randn(6, 3), requires_grad=True)
    var = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    diag = torch.tensor(0.2, dtype=torch.float64, requires_grad=True) if sym else None
    out = gram.rbf_gram_plain(x1, x2, var, diag)
    g = torch.as_tensor(rng.randn(*out.shape))
    inputs = [t for t in (x1, x2, var, diag) if t is not None]
    want = torch.autograd.grad(out, inputs, grad_outputs=g)
    got = gram._gram_vjp(g, out.detach(), x1.detach(), None if sym else x2.detach(), var.detach(),
                         None if diag is None else diag.detach())
    got = [t for t in got if t is not None]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-12)
