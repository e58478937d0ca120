"""The port's kernel zoo against the JAX package, float64 on the CPU:
Periodic, ExpSinSquared (plain and ARD), SpectralMixture, ActiveDims,
DeepKernel (with nn.MLP), InputWarp, MultiFidelity, Cosine, ArcCosine,
ChangePoints and Coregion -- the Gram, its diagonal, a cross Gram and the
gradient of all three in the kernel's parameters, and the kernel-general
NLML (and gradient) of a GPR whose kernel composes it with Rbf -- on the
JAX model's weights carried across by convert.load_trainable.  Also
spectral_mixture_init, the row blocks of the (n, m)-buffer Grams, and
SpectralMixture's random Fourier features.

Tolerances: Grams and their gradients rel 1e-10 of the largest entry (the
same formulas; sums over the input dimensions in another order, and
arccos, sin, cos and pow differ between the libraries by ulps); the NLML
rel 1e-10 and its gradient 1e-8 of the largest entry (the factorizations'
roundoff, amplified by cond(K)).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu import nn as jax_nn
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu_torch import convert, kernels, likelihoods, nn, sampling
from gptorch_tpu_torch.models import GPR
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.ops import gpr_general

GRAM_RTOL, LOSS_RTOL, GRAD_RTOL = 1e-10, 1e-10, 1e-8
N, N2, D, T = 24, 9, 3, 3


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _x(kind, rng, n):
    """Inputs of the kind the kernel takes."""
    if kind == "unit":
        return rng.rand(n, D)
    if kind == "task":
        return np.concatenate([rng.randn(n, D), rng.randint(0, T, (n, 1)) * 1.0], axis=1)
    if kind == "fidelity":
        return np.concatenate([rng.randn(n, D), rng.randint(0, 2, (n, 1)) * 1.0], axis=1)
    if kind == "line":
        return 2.0 * rng.randn(n, 1)
    return rng.randn(n, D)


def _mlp(K):
    return K.DeepKernel(K.Rbf(2, ARD=True), (jax_nn if K is jax_kernels else nn).MLP([D, 8, 8, 2], seed=3))


# name: (input kind, the kernel over a kernels module, the kernel composed with Rbf)
ZOO = {
    # σ² cos(r) is positive definite on a line, not in general
    "periodic": ("line", lambda K: K.Periodic(1, variance=1.3, length_scales=0.7),
                 lambda K, k: k + K.Rbf(1)),
    "exp_sin_squared": ("real", lambda K: K.ExpSinSquared(D, variance=0.9, length_scales=1.4, period=1.7),
                        lambda K, k: K.Rbf(D, ARD=True) * k),
    "exp_sin_squared_ard": ("real", lambda K: K.ExpSinSquared(D, length_scales=[0.8, 1.2, 2.0], period=1.3,
                                                              ARD=True),
                            lambda K, k: K.Rbf(D, ARD=True) * k),
    "spectral_mixture": ("real", lambda K: K.SpectralMixture(D, 3, weights=[0.5, 0.3, 0.4],
                                                             means=0.2 + 0.1 * np.arange(9).reshape(3, 3),
                                                             scales=0.3 + 0.05 * np.arange(9).reshape(3, 3)),
                         lambda K, k: k + K.Rbf(D)),
    "active_dims": ("real", lambda K: K.ActiveDims(K.Rbf(2, ARD=True), [0, 2], D),
                    lambda K, k: k + K.Rbf(D)),
    "deep_kernel": ("real", _mlp, lambda K, k: k + K.Rbf(D)),
    "input_warp": ("unit", lambda K: K.InputWarp(K.Rbf(D, ARD=True), a=[0.8, 1.2, 1.5], b=1.3),
                   lambda K, k: k + K.Rbf(D)),
    "multi_fidelity": ("fidelity", lambda K: K.MultiFidelity([K.Rbf(D), K.Matern52(D)], rho=0.7),
                       lambda K, k: k + K.Rbf(D + 1)),
    "cosine": ("real", lambda K: K.Cosine(D, variance=0.8, length_scales=[1.5, 2.5, 3.0], ARD=True),
               lambda K, k: k + K.Rbf(D)),
    "arc_cosine_0": ("real", lambda K: K.ArcCosine(D, order=0, weight_variances=[0.5, 1.0, 1.5]),
                     lambda K, k: k + K.Rbf(D)),
    "arc_cosine_1": ("real", lambda K: K.ArcCosine(D, order=1, bias_variance=0.5),
                     lambda K, k: k + K.Rbf(D)),
    "arc_cosine_2": ("real", lambda K: K.ArcCosine(D, order=2, variance=0.7),
                     lambda K, k: k + K.Rbf(D)),
    "change_points": ("line", lambda K: K.ChangePoints([K.Rbf(1), K.Matern32(1), K.Rbf(1, length_scales=0.3)],
                                                      [-1.0, 1.0], steepness=[2.0, 4.0]),
                      lambda K, k: k + K.Rbf(1)),
    "coregion": ("task", lambda K: K.ActiveDims(K.Coregion(T, rank=2), [D], D + 1),
                 lambda K, k: K.ActiveDims(K.Rbf(D, ARD=True), list(range(D)), D + 1) * k),
}


def _data(name, seed=0):
    kind = ZOO[name][0]
    rng = np.random.RandomState(seed)
    x, x2 = _x(kind, rng, N), _x(kind, rng, N2)
    y = np.sin(2.0 * x[:, :1]) + 0.1 * rng.randn(N, 1)
    return x, x2, y


def _perturbed(values, seed=7):
    rng = np.random.RandomState(seed)
    return {k: np.asarray(v) + 0.05 * rng.randn(*np.shape(v)) for k, v in values.items()}


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX package's results for one kernel, in one compiled call: at
    perturbed trainables, K(X), Kdiag(X), K(X, X2) and the gradient of
    Σ R₁⊙K(X) + Σ R₂⊙K(X, X2) + Σ r₃⊙Kdiag(X); and, for the GPR with the
    composite kernel (``fast=True``: the kernel-general path), its loss and
    gradient."""
    _, make, compose = ZOO[name]
    x, x2, y = _data(name)
    kern = make(jax_kernels)
    model = JaxGPR(x, y, compose(jax_kernels, make(jax_kernels)), likelihood=jax_likelihoods.Gaussian(0.2),
                   fast=True)
    kv = _perturbed(jax_get_trainable(kern))
    mv = _perturbed(jax_get_trainable(model), seed=8)
    rng = np.random.RandomState(9)
    R1, R2, r3 = rng.randn(N, N), rng.randn(N, N2), rng.randn(N)

    def compute(kv, mv):
        def probe(v):
            k = jax_with_trainable(kern, v)
            return jnp.sum(R1 * k.K(x)) + jnp.sum(R2 * k.K(x, x2)) + jnp.sum(r3 * k.Kdiag(x))

        k = jax_with_trainable(kern, kv)
        loss, grads = jax.value_and_grad(lambda v: jax_with_trainable(model, v)._loss())(mv)
        return {"K": k.K(x), "Kdiag": k.Kdiag(x), "Kx": k.K(x, x2), "probe_grad": jax.grad(probe)(kv),
                "loss": loss, "loss_grad": grads}

    return kv, mv, (R1, R2, r3), jax.tree_util.tree_map(np.asarray, jax.jit(compute)(kv, mv))


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(ZOO))
def test_gram_and_gradient_match_jax(name):
    kv, _, (R1, R2, r3), want = _reference(name)
    x, x2, _ = (torch.as_tensor(a) for a in _data(name))
    kern = ZOO[name][1](kernels)
    convert.load_trainable(kern, kv)
    K, Kdiag, Kx = kern.K(x), kern.Kdiag(x), kern.K(x, x2)
    for got, key in ((K, "K"), (Kdiag, "Kdiag"), (Kx, "Kx")):
        _close(got, want[key], GRAM_RTOL)
    probe = torch.sum(torch.as_tensor(R1) * K) + torch.sum(torch.as_tensor(R2) * Kx) + torch.sum(
        torch.as_tensor(r3) * Kdiag)
    probe.backward()
    grads = {k: v.grad for k, v in get_trainable(kern).items()}
    assert set(grads) == set(want["probe_grad"])
    scale = max(float(np.abs(g).max()) for g in want["probe_grad"].values())
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want["probe_grad"][k], rtol=0, atol=GRAM_RTOL * scale, err_msg=k)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_general_path_nlml_matches_jax(name):
    _, mv, _, want = _reference(name)
    _, make, compose = ZOO[name]
    x, _, y = _data(name)
    model = GPR(x, y, compose(kernels, make(kernels)), likelihood=likelihoods.Gaussian(0.2), fast=True,
                device="cpu")
    assert model._general_eligible(model.X) and not model._fast_eligible(model.X)
    convert.load_trainable(model, mv)
    loss = model.loss()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want["loss"]), rel=LOSS_RTOL)
    scale = max(float(np.abs(g).max()) for g in want["loss_grad"].values())
    for k, raw in get_trainable(model).items():
        np.testing.assert_allclose(raw.grad.numpy(), want["loss_grad"][k], rtol=0, atol=GRAD_RTOL * scale,
                                   err_msg=k)


def test_spectral_mixture_init_matches_jax():
    rng = np.random.RandomState(1)
    x = np.concatenate([rng.randn(50, 2), np.linspace(0, 5, 50)[:, None]], axis=1)
    y = np.sin(x[:, :1]) + 0.1 * rng.randn(50, 1)
    want = jax_kernels.spectral_mixture_init(x, y, 4, seed=2)
    got = kernels.spectral_mixture_init(x, y, 4, seed=2)
    for name in ("weights", "means", "scales"):
        np.testing.assert_allclose(getattr(got, name).value.detach().numpy(), np.asarray(getattr(want, name).value),
                                   rtol=1e-15, atol=0, err_msg=name)
    assert got.num_mixtures == 4 and got.input_dim == 3


def test_deep_kernel_mlp_weights_and_paths_match_jax():
    """The MLP's start is the JAX package's (a seeded numpy draw), under
    the JAX dotted paths, and the features agree on weights carried
    across."""
    jax_net, net = jax_nn.MLP([D, 16, 2], seed=5), nn.MLP([D, 16, 2], seed=5)
    want = {k: np.asarray(v) for k, v in jax_get_trainable(jax_net).items()}
    got = {k: v.detach().numpy() for k, v in get_trainable(net).items()}
    assert set(got) == set(want) == {"layer0.w", "layer0.b", "layer1.w", "layer1.b"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    values = _perturbed(want)
    convert.load_trainable(net, values)
    x = np.random.RandomState(2).randn(7, D)
    _close(net(torch.as_tensor(x)), np.asarray(jax_with_trainable(jax_net, values)(x)), 1e-13)
    model = GPR(x, x[:, :1], kernels.DeepKernel(kernels.Rbf(2), net), device="cpu")
    assert {"kernel.net.layer0.w", "kernel.net.layer1.b"} <= set(get_trainable(model))
    with pytest.raises(ValueError, match="out_dim"):
        kernels.DeepKernel(kernels.Rbf(3), net)


def test_kernel_validation_errors():
    with pytest.raises(ValueError, match="num_mixtures"):
        kernels.SpectralMixture(2, 0)
    with pytest.raises(ValueError, match="expected weights"):
        kernels.SpectralMixture(2, 2, weights=[1.0])
    with pytest.raises(ValueError, match="len\\(dims\\)"):
        kernels.ActiveDims(kernels.Rbf(2), [0])
    with pytest.raises(ValueError, match="non-negative"):
        kernels.ActiveDims(kernels.Rbf(1), [-1])
    with pytest.raises(ValueError, match="both lo and hi"):
        kernels.InputWarp(kernels.Rbf(2), lo=0.0)
    with pytest.raises(ValueError, match="same input_dim"):
        kernels.MultiFidelity([kernels.Rbf(2), kernels.Rbf(3)])
    with pytest.raises(ValueError, match="order"):
        kernels.ArcCosine(2, order=3)
    with pytest.raises(ValueError, match="1-D"):
        kernels.ChangePoints([kernels.Rbf(2), kernels.Rbf(2)], [0.0])
    with pytest.raises(ValueError, match="len\\(locations\\) \\+ 1"):
        kernels.ChangePoints([kernels.Rbf(1)], [0.0])
    with pytest.raises(ValueError, match="rank"):
        kernels.Coregion(3, rank=0)


def test_input_warp_box_and_add_fidelity_match_jax():
    rng = np.random.RandomState(3)
    x = rng.uniform(-2.0, 3.0, (6, 2))
    jk = jax_kernels.InputWarp(jax_kernels.Rbf(2), a=0.7, b=1.4, lo=[-2.0, -2.0], hi=[3.0, 3.0])
    tk = kernels.InputWarp(kernels.Rbf(2), a=0.7, b=1.4, lo=[-2.0, -2.0], hi=[3.0, 3.0])
    _close(tk.K(torch.as_tensor(x)), np.asarray(jk.K(x)), 1e-13)
    np.testing.assert_array_equal(kernels.add_fidelity(x, 1), jax_kernels.add_fidelity(x, 1))
    np.testing.assert_array_equal(kernels.add_fidelity(torch.as_tensor(x), 1).numpy(), jax_kernels.add_fidelity(x, 1))


@pytest.mark.parametrize("name", ["exp_sin_squared_ard", "spectral_mixture"])
def test_row_blocks_give_the_same_gram(name, monkeypatch):
    """Without a gradient, the (n, m)-buffer Grams go in row blocks; the
    blocks give the same Gram as one pass."""
    x, x2, _ = (torch.as_tensor(a) for a in _data(name))
    kern = ZOO[name][1](kernels)
    with torch.no_grad():
        whole = kern.K(x, x2)
        monkeypatch.setattr(kernels, "_CPU_BLOCK_ELEMENTS", 5 * N2)  # 5-row blocks, a ragged last one
        blocked = kern.K(x, x2)
    assert torch.equal(whole, blocked)


def test_chunk_rows_follow_the_kernel():
    """The general path's VJP chunks hold at most the budget of saved
    temporaries: a SpectralMixture saves several (rows, n) tensors per
    component and dimension, a radial kernel a few."""
    x = torch.randn(4000, D, dtype=torch.float64)
    sm = ZOO["spectral_mixture"][1](kernels)
    rows_sm, rows_rbf = gpr_general.chunk_rows(sm, x), gpr_general.chunk_rows(kernels.Rbf(D), x)
    assert 1 <= rows_sm < 200 and rows_rbf > 10 * rows_sm
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.numel() * t.element_size()) or t,
                                                  lambda t: t):
        sm.K(x[:rows_sm], x)
    assert sum(saved) <= max(2 * 4000 * 4000 * 8, 2 ** 28)


def test_spectral_mixture_random_features_match_its_gram():
    """E[φ(x)ᵀφ(x')] = k(x, x'): each entry of the feature estimate lies
    within 5 standard errors (of the mean over features) of the Gram."""
    kern = ZOO["spectral_mixture"][1](kernels)
    x = torch.as_tensor(np.random.RandomState(5).randn(6, D) * 0.7)
    features = 8192
    phi = sampling.RandomFourierFeatures(kern, features, torch.Generator().manual_seed(0))(x)
    terms = features * phi[:, None, :] * phi[None, :, :]  # (6, 6, F), mean = estimate
    estimate, se = terms.mean(-1), terms.std(-1) / np.sqrt(features)
    K = kern.K(x).detach()
    assert float(torch.max(torch.abs(estimate - K) / se)) < 5.0
    assert torch.allclose(torch.diagonal(estimate), torch.sum(kern.weights.value).expand(6), rtol=0.1)
