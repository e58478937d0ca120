"""The port's kernels, bijectors, priors and parameters against the JAX package
and against the reference goldens in tests/data/kernels (float64, CPU)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import bijectors as jax_bijectors
from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import param as jax_param
from gptorch_tpu import priors as jax_priors
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu_torch import bijectors, kernels, module, param, priors

DATA_DIR = os.path.join(os.path.dirname(__file__), "data", "kernels")


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _load(name):
    return np.load(os.path.join(DATA_DIR, name))


def _np(t):
    return t.detach().numpy()


STATIONARY = ["Exp", "Matern12", "Matern32", "Matern52", "Rbf", "RationalQuadratic"]
STATIC = ["White", "Constant", "Bias"]


def _pair(name, ard):
    """The same kernel built by both packages, with non-default parameters."""
    if name in STATIC:
        args, kwargs = (3,), {"variance": 1.4}
    else:
        ell = np.array([0.6, 1.1, 2.3]) if ard else 0.8
        args, kwargs = (3,), {"variance": 1.4, "length_scales": ell, "ARD": ard}
        if name == "RationalQuadratic":
            kwargs["alpha"] = 0.7
    return getattr(jax_kernels, name)(*args, **kwargs), getattr(kernels, name)(*args, **kwargs)


CASES = [(n, False) for n in STATIC] + [(n, ard) for n in STATIONARY for ard in (False, True)]


@pytest.mark.parametrize("name, ard", CASES)
def test_kernel_matches_jax(name, ard):
    jk, tk = _pair(name, ard)
    rng = np.random.RandomState(0)
    x, x2 = rng.randn(12, 3), rng.randn(7, 3)
    jx, jx2 = jnp.asarray(x), jnp.asarray(x2)
    tx, tx2 = torch.as_tensor(x), torch.as_tensor(x2)
    for got, want in (
        (tk.K(tx), jk.K(jx)),
        (tk.K(tx, tx2), jk.K(jx, jx2)),
        (tk.Kdiag(tx), jk.Kdiag(jx)),
    ):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12, atol=1e-300)
    assert sorted(dict(tk.named_params())) == sorted(jax_get_trainable(jk))


@pytest.mark.parametrize("op", ["add", "mul"])
def test_combination_matches_jax(op):
    pairs = [_pair("Rbf", True), _pair("Matern32", False)]
    jk = getattr(pairs[0][0], f"__{op}__")(pairs[1][0])
    tk = getattr(pairs[0][1], f"__{op}__")(pairs[1][1])
    x = np.random.RandomState(1).randn(9, 3)
    np.testing.assert_allclose(_np(tk.K(torch.as_tensor(x))), np.asarray(jk.K(jnp.asarray(x))), rtol=1e-12)
    np.testing.assert_allclose(_np(tk.Kdiag(torch.as_tensor(x))), np.asarray(jk.Kdiag(jnp.asarray(x))), rtol=1e-12)
    assert sorted(dict(tk.named_params())) == sorted(jax_get_trainable(jk))


def test_combination_requires_same_input_dim():
    with pytest.raises(ValueError):
        kernels.Rbf(2) + kernels.Rbf(3)


GOLDEN = ["White", "Constant", "Bias", "Exp", "Matern12", "Matern32", "Matern52", "Rbf"]


@pytest.mark.parametrize("name", GOLDEN)
def test_kernel_goldens(name):
    x1, x2 = torch.as_tensor(_load("x1.npy")), torch.as_tensor(_load("x2.npy"))
    k = getattr(kernels, name)(x1.shape[1])
    assert np.allclose(_load(f"{name}_kx.npy"), _np(k.K(x1)))
    assert np.allclose(_load(f"{name}_kx2.npy"), _np(k.K(x1, x2)))
    assert np.allclose(_load(f"{name}_kdiag.npy"), _np(k.Kdiag(x1)))
    if name in STATIONARY:
        ell = _load("ard_length_scales.npy")
        k = getattr(kernels, name)(x1.shape[1], ARD=True, length_scales=ell)
        assert np.allclose(_load(f"{name}_kx_ard.npy"), _np(k.K(x1)))
        assert np.allclose(_load(f"{name}_kx2_ard.npy"), _np(k.K(x1, x2)))
        assert np.allclose(_load(f"{name}_kdiag_ard.npy"), _np(k.Kdiag(x1)))
        # translation invariance
        assert np.allclose(_load(f"{name}_kx_ard.npy"), _np(k.K(x1 + 0.34)))


def test_dist_floor_is_dtype_aware():
    k = kernels.Exp(2)
    x = torch.zeros(3, 2, dtype=torch.float32, requires_grad=True)
    k.to(torch.float32)
    k.K(x).sum().backward()
    assert torch.isfinite(x.grad).all()


BIJECTORS = [
    ("Identity", ()),
    ("Exp", ()),
    ("Softplus", ()),
    ("Shift", (2.0,)),
]


@pytest.mark.parametrize("name, args", BIJECTORS + [("Chain", None)])
def test_bijector_matches_jax(name, args):
    if name == "Chain":
        jb = jax_bijectors.Chain([jax_bijectors.Shift(2.0), jax_bijectors.Exp()])
        tb = bijectors.Chain([bijectors.Shift(2.0), bijectors.Exp()])
    else:
        jb, tb = getattr(jax_bijectors, name)(*args), getattr(bijectors, name)(*args)
    x = np.random.RandomState(2).randn(5)
    y = np.array(jb.forward(jnp.asarray(x)))
    np.testing.assert_allclose(_np(tb.forward(torch.as_tensor(x))), y, rtol=1e-12)
    np.testing.assert_allclose(_np(tb.inverse(torch.as_tensor(y))), np.asarray(jb.inverse(jnp.asarray(y))), rtol=1e-12)
    np.testing.assert_allclose(
        _np(tb.forward_log_det_jacobian(torch.as_tensor(x))),
        np.asarray(jb.forward_log_det_jacobian(jnp.asarray(x))),
        rtol=1e-12,
        atol=1e-300,
    )


def test_positive_bijector_follows_settings():
    from gptorch_tpu_torch import settings

    assert isinstance(bijectors.positive(), bijectors.Exp)
    with settings.override(positive_bijector="softplus"):
        assert isinstance(bijectors.positive(), bijectors.Softplus)


PRIORS = [
    ("Normal", (0.3, 1.7)),
    ("LogNormal", (-0.2, 0.9)),
    ("Gamma", (2.5, 1.5)),
    ("Uniform", (0.5, 2.0)),
]


@pytest.mark.parametrize("name, args", PRIORS)
def test_prior_matches_jax(name, args):
    x = np.array([0.1, 0.7, 1.3, 2.9])
    want = np.asarray(getattr(jax_priors, name)(*args).log_prob(jnp.asarray(x)))
    got = _np(getattr(priors, name)(*args).log_prob(torch.as_tensor(x)))
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("value", [0.37, [0.5, 2.0, 3.5]])
def test_positive_param_matches_jax(value):
    from gptorch_tpu.util import as_array as jax_as_array
    from gptorch_tpu_torch.util import as_array

    jp = jax_param.positive_param(jax_as_array(value), prior=jax_priors.Gamma(2.0, 1.0))
    tp = param.positive_param(as_array(value), prior=priors.Gamma(2.0, 1.0))
    assert tuple(tp.shape) == tuple(jp.shape)  # a Python scalar becomes shape (1,)
    np.testing.assert_allclose(_np(tp.raw), np.asarray(jp.raw), rtol=1e-15)
    np.testing.assert_allclose(_np(tp.value), np.asarray(jp.value), rtol=1e-15)
    assert tp.trainable


def test_log_prior_matches_jax():
    jk, tk = _pair("Rbf", True)
    jk.variance.prior = jax_priors.Gamma(2.0, 1.0)
    jk.length_scales.prior = jax_priors.LogNormal(0.0, 1.0)
    tk.variance.prior = priors.Gamma(2.0, 1.0)
    tk.length_scales.prior = priors.LogNormal(0.0, 1.0)
    np.testing.assert_allclose(float(tk.log_prior().detach()), float(jk.log_prior()), rtol=1e-12)


def test_trainable_views():
    k = kernels.Rbf(3, ARD=True) + kernels.Constant(3)
    k.kern2.variance.trainable = False
    values = module.get_trainable(k)
    assert sorted(values) == ["kern1.length_scales", "kern1.variance"]
    vec = module.pack_vector(values)
    new = module.unpack_vector(vec + 1.0, values)
    module.set_trainable(k, new)
    np.testing.assert_allclose(module.pack_vector(module.get_trainable(k)), vec + 1.0)
    assert float(k.kern2.variance.value) == 1.0
