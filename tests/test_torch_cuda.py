"""Tests of the port that need an NVIDIA CUDA card.

They carry the ``cuda`` marker and skip where no card is present.  This file
imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch; there, skip the JAX-configuring tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from gptorch_tpu_torch import kernels, likelihoods, settings
from gptorch_tpu_torch.models import GPR
from gptorch_tpu_torch.ops import gram


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")


pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 2e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("n1, n2", [(256, None), (1031, None), (100, 37), (64, 4099), (1, 1)])
def test_kernel_matches_plain(cuda, dtype, tol, n1, n2):
    g = torch.Generator(device="cuda").manual_seed(0)
    x1 = torch.randn(n1, 8, generator=g, device="cuda", dtype=dtype)
    x2 = None if n2 is None else torch.randn(n2, 8, generator=g, device="cuda", dtype=dtype)
    var = torch.tensor(1.3, device="cuda", dtype=dtype)
    diag = torch.tensor(0.1, device="cuda", dtype=dtype)
    before = gram.rbf_gram.launches
    out = gram.rbf_gram(x1, x2, var=var, diag=diag)
    torch.cuda.synchronize()
    assert gram.rbf_gram.launches == before + 1
    expected = gram.rbf_gram_plain(x1, x2, var, diag)
    assert float((out - expected).abs().max()) <= tol * 1.3
    if n2 is None:
        assert torch.equal(out.diagonal(), (var + diag).expand(n1))  # exact 0 self-distance


@pytest.mark.parametrize("d", [1, 3, 8, 13, 17])
def test_kernel_feature_widths(cuda, d):
    g = torch.Generator(device="cuda").manual_seed(1)
    x1 = torch.randn(70, d, generator=g, device="cuda", dtype=torch.float64)
    x2 = torch.randn(90, d, generator=g, device="cuda", dtype=torch.float64)
    out = gram.rbf_gram(x1, x2, var=0.7)
    assert float((out - gram.rbf_gram_plain(x1, x2, 0.7)).abs().max()) <= 1e-12


def test_kernel_rejects_grad(cuda):
    x = torch.randn(8, 2, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError):
        gram.rbf_gram(x, var=1.0)
    with torch.no_grad():
        assert gram.rbf_gram(x, var=1.0).shape == (8, 8)


def test_default_device_is_the_card(cuda):
    x, y = np.zeros((4, 1)), np.zeros((4, 1))
    model = GPR(x, y, kernels.Rbf(1))
    assert model.device.type == "cuda"
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_serving_card_matches_cpu(cuda):
    """The whole serving path in float64: the card's route against the
    CPU's plain route on the same data."""
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        rng = np.random.RandomState(0)
        x = rng.randn(300, 3)
        y = np.sin(x[:, :1]) + 0.1 * rng.randn(300, 1)
        xs = rng.randn(40, 3)
        out = {}
        with settings.override(jitter_policy="fixed"):
            for device in ("cuda", "cpu"):
                model = GPR(x, y, kernels.Rbf(3, ARD=True), likelihood=likelihoods.Gaussian(0.1), device=device)
                post = model.posterior()
                serving = post.for_serving(nb=64)
                out[device] = (*post.predict_f(xs), *serving.predict_y(xs), serving.mean_only(xs))
    finally:
        torch.set_default_dtype(old)
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
