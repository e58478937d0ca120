"""Tests of the port that need an NVIDIA CUDA card.

They carry the ``cuda`` marker and skip where no card is present.  This file
imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch; there, skip the JAX-configuring tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import contextlib
import ctypes
import math

import numpy as np
import pytest
import torch

from gptorch_tpu_torch import kernels, likelihoods, mean_functions, nn, sampling, settings
from gptorch_tpu_torch.models import FITC, GPR, SVGP, VFE
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.ops import contract, gpr_fast, gram, iterative, lowrank_contract, mvm
from gptorch_tpu_torch.training import fit


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


@pytest.mark.parametrize("sym", [True, False])
def test_kernel_backward_matches_plain(cuda, sym):
    """K1's backward (torch ops on the kernel's output) against autograd
    through the plain version, float64."""
    g = torch.Generator(device="cuda").manual_seed(2)
    leaves = {
        "x1": torch.randn(300, 5, generator=g, device="cuda", dtype=torch.float64),
        "x2": None if sym else torch.randn(170, 5, generator=g, device="cuda", dtype=torch.float64),
        "var": torch.tensor(1.3, device="cuda", dtype=torch.float64),
        "diag": torch.tensor(0.1, device="cuda", dtype=torch.float64) if sym else None,
    }
    grads = []
    for fn in (lambda a, b, v, d: gram.rbf_gram(a, b, var=v, diag=d), gram.rbf_gram_plain):
        inputs = {k: None if t is None else t.clone().requires_grad_() for k, t in leaves.items()}
        out = fn(*inputs.values())
        cot = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(3),
                          device="cuda", dtype=torch.float64)
        grads.append(torch.autograd.grad(out, [t for t in inputs.values() if t is not None], cot))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def _contraction_inputs(n, d, dy, dtype, seed=0, far=False):
    """K⁻¹, A, x̃, log σ² and log α.  ``far`` spreads x̃ six times wider and
    takes α = 0.02, so r² runs from 0 to the hundreds and rq's
    u = 1 + r²/2α to the tens of thousands: the range where the float32
    kernel's approximate log2, reciprocal and square root are furthest from
    IEEE's."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = torch.randn(n, d, generator=g, device="cuda", dtype=dtype) * (6.0 if far else 1.0)
    # A duplicate point, so matern12's E mask is hit off the diagonal.  Its
    # coordinates are multiples of 1/4: the plain twin's norm identity is then
    # exact for the pair (any rounding would leave r² = ±eps, which E = G/r
    # turns into a huge term).
    xs[n // 2] = xs[n // 3] = torch.arange(d, device="cuda", dtype=dtype) % 5 * 0.25 - 0.5
    M = torch.randn(n, n, generator=g, device="cuda", dtype=dtype) / n ** 0.5
    Kinv = M @ M.T + torch.eye(n, device="cuda", dtype=dtype)
    A = torch.randn(n, dy, generator=g, device="cuda", dtype=dtype)
    log_var = torch.tensor(0.2, device="cuda", dtype=dtype)
    log_extra = torch.tensor([math.log(0.02) if far else -0.5], device="cuda", dtype=dtype)
    return Kinv, A, xs, log_var, log_extra


#: Kernel vs the plain twin evaluated in float64 on the same inputs, relative
#: to the sum of absolute terms of each output (contract.contraction_scales).
#: float32: the kernel rounds each term (and W = dy·K⁻¹ − AAᵀ) at u = 6e-8 and
#: sums a row's n terms in 32 sequential lanes, about √(n/32)·u of the scale
#: for errors that behave as random; 2e-5 leaves a wide margin at n ≤ 1000.
#: The twin runs in float64 because its r² by the norm identity loses up to
#: u·(|x̃ᵢ|² + |x̃ⱼ|²) absolute, which matern12's E = G/r amplifies at the
#: closest pairs (r² ≈ 1e-3 at n = 1000, d = 3) past any float32 tolerance.
#: float64: the same amplification of the twin's own r² (u = 1.1e-16) reaches
#: about 1e-12 of the scale at those pairs; 1e-10 leaves a margin.
CONTRACT_TOL = {torch.float32: 2e-5, torch.float64: 1e-10}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", contract.KINDS)
# The kernel's stage is C = 128 columns in float32 and 64 in float64, its
# strip 32, 16 or 8 rows by type and width; rows of K⁻¹ go by 16-byte copies
# only when n·itemsize % 16 == 0.  The cases put n at C − 1, C, C + 1 and
# 2C + 1 of both types (63, 64, 65, 127, 128, 129, 257; all but 64 and 128
# misaligned in float32, the odd ones in float64), below one strip (1, 5),
# and cover d ∈ {1, 8, 9, 16, 17, 32} and dy ∈ {1, 2, 32}.  The last case
# holds the approximate float32 maps to the tolerance at far pairs and a
# small α (see _contraction_inputs).
@pytest.mark.parametrize("n, d, dy, far", [
    (1000, 3, 2, False), (257, 8, 1, False), (130, 13, 3, False), (70, 20, 1, False),
    (1, 8, 1, False), (5, 32, 32, False), (63, 16, 2, False), (64, 1, 1, False), (65, 9, 32, False),
    (127, 8, 1, False), (128, 17, 2, False), (129, 32, 1, False), (300, 8, 1, True),
])
def test_contraction_kernel_matches_plain(cuda, dtype, kind, n, d, dy, far):
    Kinv, A, xs, log_var, log_extra = _contraction_inputs(n, d, dy, dtype, far=far)
    before = contract.radial_contractions.launches
    got = contract.radial_contractions(Kinv, A, xs, log_var, dy, kind, log_extra)
    torch.cuda.synchronize()
    assert contract.radial_contractions.launches == before + 1
    ref = [t.double() for t in (Kinv, A, xs, log_var, log_extra)]
    want = contract.radial_contractions_plain(*ref[:4], dy, kind, ref[4])
    scales = contract.contraction_scales(*ref[:4], dy, kind, ref[4])
    for name, a, b, s in zip(("svar", "rowsum", "MX", "sextra"), got, want, scales):
        assert a.shape == b.shape and a.dtype == dtype, name
        err = (a.double() - b).abs()
        assert bool((err <= CONTRACT_TOL[dtype] * s + 1e-30).all()), (name, float(err.max()))


@pytest.mark.parametrize("n", [1500, 20000])  # 20000: 625 strips, more than the resident blocks
def test_contraction_kernel_is_deterministic(cuda, n):
    inputs = _contraction_inputs(n, 8, 1, torch.float32)
    first = contract.radial_contractions(*inputs[:4], 1, "rbf")
    second = contract.radial_contractions(*inputs[:4], 1, "rbf")
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_contraction_kernel_rejects_wide_inputs(cuda):
    Kinv, A, xs, log_var, _ = _contraction_inputs(40, 33, 1, torch.float32)
    with pytest.raises(ValueError, match="d <= 32"):
        contract.radial_contractions(Kinv, A, xs, log_var, 1, "rbf")


@contextlib.contextmanager
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(old)


@pytest.mark.parametrize("kind", contract.KINDS)
def test_radial_nlml_card_matches_cpu(cuda, kind):
    """The fused radial NLML and its gradient in float64: the card's route
    (K1 for rbf, K2 for every kind) against the CPU's plain route."""
    rng = np.random.RandomState(5)
    x, y = rng.randn(300, 3), rng.randn(300, 2)
    theta = [np.log([0.9, 1.2, 0.7]), np.asarray(0.3), np.asarray(-2.0), np.asarray([-0.4])]
    out = {}
    for device in ("cuda", "cpu"):
        params = [torch.tensor(t, device=device, requires_grad=True) for t in theta]
        extra = params[3] if kind == "rq" else None
        before = (gram.rbf_gram.launches, contract.radial_contractions.launches)
        v = gpr_fast.radial_nlml(kind, *params[:3], torch.as_tensor(x, device=device),
                                 torch.as_tensor(y, device=device), 1e-4, 64, 1e-3, extra)
        v.backward()
        launched = (gram.rbf_gram.launches - before[0], contract.radial_contractions.launches - before[1])
        out[device] = (v.detach().cpu(), [p.grad.cpu() for p in params[: 4 if kind == "rq" else 3]], launched)
    assert out["cuda"][2] == ((1 if kind == "rbf" else 0), 1)
    assert out["cpu"][2] == (0, 0)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-10, atol=0)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("route", ["generic", "general"])
def test_training_routes_card_match_cpu(cuda, route):
    """GPR loss and gradient in float64 on the generic route (Rbf, fast=False:
    K1 with its backward under autograd) and the kernel-general route
    (Rbf + Matern32 with a LinearMean: K1's backward inside the row sweep)."""
    rng = np.random.RandomState(6)
    x, y = rng.randn(260, 3), rng.randn(260, 1)
    out = {}
    with _float64():
        for device in ("cuda", "cpu"):
            if route == "generic":
                kern, mean, fast = kernels.Rbf(3, ARD=True), None, False
            else:
                kern = kernels.Rbf(3, ARD=True) + kernels.Matern32(3)
                mean, fast = mean_functions.LinearMean(3, 1, W=np.array([[0.2, -0.1, 0.3]])), True
            model = GPR(x, y, kern, mean_function=mean, likelihood=likelihoods.Gaussian(0.1), fast=fast,
                        fast_block=64, device=device)
            before = gram.rbf_gram.launches
            loss = model.loss()
            loss.backward()
            out[device] = (float(loss.detach()), {k: v.grad.cpu() for k, v in get_trainable(model).items()},
                           gram.rbf_gram.launches - before)
    assert out["cuda"][2] >= 1 and out["cpu"][2] == 0
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-10)
    for k, g in out["cuda"][1].items():
        torch.testing.assert_close(g, out["cpu"][1][k], rtol=1e-8, atol=1e-10)


def test_default_device_is_the_card(cuda):
    x, y = np.zeros((4, 1)), np.zeros((4, 1))
    model = GPR(x, y, kernels.Rbf(1))
    assert model.device.type == "cuda"
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_serving_card_matches_cpu(cuda):
    """The whole serving path in float64: the card's route against the
    CPU's plain route on the same data."""
    with _float64():
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
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)


#: K1 at the sparse paths' shapes, d = 9: Kuf (1024 × 4096 cross), Kuu
#: (1024² symmetric, no added diagonal), a ragged pair.
SPARSE_SHAPES = [(1024, 4096), (1024, None), (1000, 4000)]


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 2e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("n1, n2", SPARSE_SHAPES)
def test_kernel_at_sparse_shapes(cuda, dtype, tol, n1, n2):
    """Forward against the plain twin (tolerance per unit of var, as above)
    and the backward against autograd through the twin; the symmetric
    launch with ``diag=None`` adds exactly 0 on its diagonal."""
    g = torch.Generator(device="cuda").manual_seed(4)
    leaves = {
        "x1": torch.randn(n1, 9, generator=g, device="cuda", dtype=dtype),
        "x2": None if n2 is None else torch.randn(n2, 9, generator=g, device="cuda", dtype=dtype),
        "var": torch.tensor(1.3, device="cuda", dtype=dtype),
    }
    outs, grads = [], []
    for fn in (lambda a, b, v: gram.rbf_gram(a, b, var=v), lambda a, b, v: gram.rbf_gram_plain(a, b, v)):
        inputs = {k: None if t is None else t.clone().requires_grad_() for k, t in leaves.items()}
        before = gram.rbf_gram.launches
        out = fn(*inputs.values())
        outs.append((out.detach(), gram.rbf_gram.launches - before))
        cot = torch.randn(out.shape, generator=torch.Generator(device="cuda").manual_seed(5), device="cuda",
                          dtype=dtype)
        grads.append(torch.autograd.grad(out, [t for t in inputs.values() if t is not None], cot))
    (k, launched), (p, plain_launched) = outs
    assert (launched, plain_launched) == (1, 0)
    assert float((k - p).abs().max()) <= tol * 1.3
    if n2 is None:
        assert torch.equal(k.diagonal(), leaves["var"].expand(n1))
    # each cotangent sums n2 (x1, var) or n1 (x2) terms of O(1): rounding of
    # the twin's r² at u per term, about √n·u relative to the largest entry
    rel = 1e-3 if dtype == torch.float32 else 1e-10
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=rel, atol=rel * float(b.abs().max()))


def _sparse_models(device, whiten):
    rng = np.random.RandomState(7)
    x = rng.randn(300, 3)
    y = np.sin(x[:, :1]) + 0.1 * rng.randn(300, 1)
    z = x[rng.permutation(300)[:40]]
    common = dict(inducing_points=z, jitter=1e-6, device=device)
    return {
        "svgp": SVGP(x, y, kernels.Rbf(3, ARD=True), likelihood=likelihoods.Gaussian(0.1), whiten=whiten,
                     batch_size=64, **common),
        "vfe": VFE(x, y, kernels.Rbf(3, ARD=True), likelihood=likelihoods.Gaussian(0.1), **common),
        "fitc": FITC(x, y, kernels.Rbf(3, ARD=True), likelihood=likelihoods.Gaussian(0.1), **common),
    }, x, y


@pytest.mark.parametrize("whiten", [False, True])
def test_sparse_models_card_match_cpu(cuda, whiten):
    """SVGP (on one explicit batch), VFE and FITC loss and gradient, and
    each model's serving posterior, in float64: the card's route (K1 for
    Kuu, Kuf and Kus, with its backward) against the CPU's plain route."""
    out = {}
    with _float64(), settings.override(jitter_policy="fixed"):
        for device in ("cuda", "cpu"):
            models, x, y = _sparse_models(device, whiten)
            xs = torch.as_tensor(x[:50], device=device)
            res = {}
            for name, model in models.items():
                before = gram.rbf_gram.launches
                batch = (model.X[:64], model.Y[:64]) if name == "svgp" else (None, None)
                loss = model.loss(*batch)
                loss.backward()
                grads = {k: v.grad.cpu().clone() for k, v in get_trainable(model).items()}
                serving = model.posterior().for_serving(nb=16)
                res[name] = (float(loss.detach()), grads, [t.cpu() for t in serving.predict_f(xs)],
                             gram.rbf_gram.launches - before)
            out[device] = res
    for name, (loss, grads, moments, launched) in out["cuda"].items():
        cpu = out["cpu"][name]
        assert launched >= 3 and cpu[3] == 0, name
        assert loss == pytest.approx(cpu[0], rel=1e-10), name
        for k, g in grads.items():
            torch.testing.assert_close(g, cpu[1][k], rtol=1e-8, atol=1e-8 * float(g.abs().max()),
                                       msg=lambda m, name=name, k=k: f"{name} {k}: {m}")
        for a, b in zip(moments, cpu[2]):
            torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-10)


def test_svgp_minibatch_and_natgrad_on_the_card(cuda):
    """The generator lives on the card, the batch is drawn there, and one
    natural-gradient step matches the CPU's from the same values."""
    from gptorch_tpu_torch.training import natgrad

    with _float64():
        res = {}
        for device in ("cuda", "cpu"):
            models, _, _ = _sparse_models(device, whiten=False)
            model = models["svgp"]
            model.batch_size = None
            step, _ = natgrad.make_natgrad_step(model, nat_lr=0.5)
            loss = step()
            res[device] = (float(loss), {k: v.detach().cpu() for k, v in get_trainable(model).items()})
        models, _, _ = _sparse_models("cuda", whiten=True)
        losses = models["svgp"].fit_scan("Adam", max_iter=3, generator=torch.Generator(device="cuda").manual_seed(0))
        assert losses.device.type == "cuda" and bool(torch.isfinite(losses).all())
    assert res["cuda"][0] == pytest.approx(res["cpu"][0], rel=1e-10)
    for k, v in res["cuda"][1].items():
        torch.testing.assert_close(v, res["cpu"][1][k], rtol=1e-7, atol=1e-9)


def _card_and_cpu_loss(make, n=4096):
    """Loss, gradients by path, rbf_gram and radial_contractions launches and
    the fused-route flag of ``make(device)`` on the card and on the CPU, in
    float64."""
    out = {}
    with _float64(), settings.override(jitter_policy="fixed"):
        for device in ("cuda", "cpu"):
            model = make(device)
            before = (gram.rbf_gram.launches, contract.radial_contractions.launches)
            loss = model.loss()
            loss.backward()
            out[device] = (float(loss.detach()), {k: v.grad.cpu() for k, v in get_trainable(model).items()},
                           (gram.rbf_gram.launches - before[0], contract.radial_contractions.launches - before[1]),
                           model._fast_eligible(model.X))
    return out


def _assert_card_matches_cpu(out):
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-8)
    scale = max(float(g.abs().max()) for g in out["cpu"][1].values())
    for k, g in out["cuda"][1].items():
        torch.testing.assert_close(g, out["cpu"][1][k], rtol=0, atol=1e-8 * scale)


@pytest.mark.parametrize("d, dy", [(33, 1), (3, 33)], ids=["d=33", "dy=33"])
def test_wide_inputs_route_to_the_general_path_on_the_card(cuda, d, dy):
    """At n = 4096 the contraction kernel cannot take d = 33 or dy = 33: the
    card takes the kernel-general path (no contraction launch), the CPU the
    fused one, and both give the same loss and gradient."""
    rng = np.random.RandomState(7)
    x = rng.randn(4096, d)
    y = np.sin(x[:, :1] * np.arange(1, dy + 1)) + 0.1 * rng.randn(4096, dy)

    def make(device):
        kern = kernels.Rbf(d, ARD=True, length_scales=np.linspace(0.8, 1.6, d) * math.sqrt(d / 3))
        return GPR(x, y, kern, likelihood=likelihoods.Gaussian(0.1), device=device)

    out = _card_and_cpu_loss(make)
    assert out["cpu"][3] and not out["cuda"][3]
    assert out["cuda"][2][0] >= 2 and out["cuda"][2][1] == 0 and out["cpu"][2] == (0, 0)
    _assert_card_matches_cpu(out)


@pytest.mark.parametrize("objective", ["nlml", "loo"])
def test_composite_and_loo_card_match_cpu(cuda, objective):
    """Linear + Rbf + Constant at n = 4096 (kernel-general path for the
    NLML; the blocked factor for LOO), card against CPU in float64."""
    rng = np.random.RandomState(8)
    x = rng.randn(4096, 3)
    y = np.sin(x[:, :1]) + 0.1 * rng.randn(4096, 1)

    def make(device):
        kern = kernels.Linear(3, ARD=True) + kernels.Rbf(3, ARD=True) + kernels.Constant(3)
        return GPR(x, y, kern, likelihood=likelihoods.Gaussian(0.1), objective=objective, device=device)

    out = _card_and_cpu_loss(make)
    assert out["cuda"][2][0] >= 1 and out["cuda"][2][1] == 0
    _assert_card_matches_cpu(out)


def _observe_setup(n=2048, nb=2, steps=4, seed=9):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3)
    y = np.sin(x[:, :1]) + 0.1 * rng.randn(n, 1)
    xb = rng.randn(nb * steps, 3)
    yb = np.sin(xb[:, :1]) + 0.1 * rng.randn(nb * steps, 1)
    model = GPR(x, y, kernels.Rbf(3, ARD=True), likelihood=likelihoods.Gaussian(0.1))
    return model, xb, yb, rng.randn(50, 3)


def test_fantasy_chain_matches_refit_on_the_card(cuda):
    """Four observes of two points into a chain on the card against a fresh
    factorization of the augmented data, float64."""
    with _float64(), settings.override(jitter_policy="none"):
        model, xb, yb, xs = _observe_setup()
        chain = model.posterior().fantasy_chain(model.num_data + len(xb))
        for i in range(0, len(xb), 2):
            assert chain.observe(xb[i:i + 2], yb[i:i + 2]) is chain
        refit = GPR(np.concatenate([model.X.cpu().numpy(), xb]), np.concatenate([model.Y.cpu().numpy(), yb]),
                    model.kernel, likelihood=model.likelihood).posterior()
        with pytest.raises(ValueError, match="capacity"):
            chain.observe(xb[:1], yb[:1])
        for got, want in zip(chain.predict_f(xs), refit.predict_f(xs)):
            np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_serving_condition_on_matches_posterior_on_the_card(cuda):
    """ServingGPRPosterior.condition_on against GPRPosterior.condition_on,
    two chained steps, float64 on the card."""
    with _float64(), settings.override(jitter_policy="none"):
        model, xb, yb, xs = _observe_setup()
        post = model.posterior()
        serving = post.for_serving()
        for i in (0, 2):
            post, serving = post.condition_on(xb[i:i + 2], yb[i:i + 2]), serving.condition_on(xb[i:i + 2], yb[i:i + 2])
        assert serving.Linv.device.type == "cuda"
        for got, want in zip(serving.predict_f(xs), post.predict_f(xs)):
            np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


def test_sample_moments_on_the_card(cuda):
    """predict_f_samples with a generator on the card: 20000 draws at 3
    points have the posterior's mean and variance within 5 standard errors."""
    with _float64():
        model, _, _, xs = _observe_setup(n=500)
        x = xs[:3]
        mu, var = model.predict_f(x)
        S = 20000
        draws = model.predict_f_samples(x, S, generator=torch.Generator(device="cuda").manual_seed(0))
        assert draws.shape == (S, 3, 1)
        assert np.all(np.abs(draws.mean(0) - mu) <= 5 * np.sqrt(var / S))
        assert np.all(np.abs(draws.var(0) - var) <= 5 * var * np.sqrt(2.0 / (S - 1)))


def test_sample_paths_repeat_for_a_seed_on_the_card(cuda):
    """sample_paths on both posteriors: the same generator seed gives the
    same paths; another seed other paths; both posteriors agree."""
    with _float64():
        model, _, _, xs = _observe_setup()
        post = model.posterior()
        serving = post.for_serving()
        cand = torch.as_tensor(xs, device="cuda")

        def paths(p, seed):
            return p.sample_paths(8, 256, generator=torch.Generator(device="cuda").manual_seed(seed))(cand)

        a, b, c = paths(post, 0), paths(post, 0), paths(post, 1)
        assert torch.equal(a, b) and not torch.allclose(a, c)
        torch.testing.assert_close(paths(serving, 0), a, rtol=1e-8, atol=1e-10)


def _captured_and_eager(make, method, steps, lr, policy="fixed"):
    """(eager losses, captured losses, eager values, captured values,
    generator states after each, fit_scan.last_run of the captured call)
    of two models made by ``make()``, trained from one generator seed."""
    out = []
    with settings.override(jitter_policy=policy):
        for capture in (False, True):
            model = make()
            gen = torch.Generator(device="cuda").manual_seed(11)
            _, losses = fit._fit_scan(model, method, steps, lr, gen, capture)
            out.append((losses.cpu(), {k: v.detach().cpu() for k, v in get_trainable(model).items()},
                        gen.get_state(), fit.fit_scan.last_run, model))
    return out


def _svgp_card():
    return _sparse_models("cuda", whiten=False)[0]["svgp"]


@pytest.mark.parametrize("method", ["Adam", "SGD", "RMSprop", "Adagrad", "Adadelta", "Adamax"])
def test_captured_fit_scan_matches_eager_on_the_card(cuda, method):
    """A minibatched SVGP in float64: the captured graph's replays draw the
    same batches (the generator ends in the same state) and take the same
    steps as the eager loop."""
    lr = 1e-4 if method == "SGD" else 1e-2  # heavy-ball SGD at 1e-2 diverges on this ELBO
    with _float64():
        (l0, v0, g0, _, _), (l1, v1, g1, run, model) = _captured_and_eager(_svgp_card, method, 12, lr)
    assert run["captured"] and run["steps"] == 12 and run["launches_per_step"]["rbf_gram"] >= 2
    assert torch.equal(g0, g1)
    torch.testing.assert_close(l1, l0, rtol=1e-10, atol=0)
    for k in v0:
        torch.testing.assert_close(v1[k], v0[k], rtol=1e-9, atol=1e-12)
    with settings.override(jitter_policy="fixed"):
        assert fit.captures(model, method)


def test_captured_fit_scan_reuses_its_graph_and_resets_the_optimizer(cuda):
    """A second call with the same key replays the cached graph from a fresh
    optimizer state: from the same values and generator state it repeats
    the first call's losses bit for bit."""
    with _float64(), settings.override(jitter_policy="fixed"):
        model = _svgp_card()
        start = {k: v.detach().clone() for k, v in get_trainable(model).items()}
        first = model.fit_scan("Adam", max_iter=6, generator=torch.Generator(device="cuda").manual_seed(2))
        before = gram.rbf_gram.launches
        with torch.no_grad():
            for k, v in get_trainable(model).items():
                v.copy_(start[k])
        again = model.fit_scan("Adam", max_iter=6, generator=torch.Generator(device="cuda").manual_seed(2))
        assert gram.rbf_gram.launches == before  # replays only: nothing launched from the host
        assert torch.equal(first, again)
        assert len(fit._GRAPHS[model]) == 1
        model.fit_scan("Adam", max_iter=6, learning_rate=0.05, generator=torch.Generator(device="cuda"))
        assert len(fit._GRAPHS[model]) == 2
        fit.release_graphs(model)
        assert model not in fit._GRAPHS


@pytest.mark.parametrize("route", ["fused", "general"])
def test_captured_exact_training_matches_eager_on_the_card(cuda, route):
    """GPR training captured on the fused radial path (K1 and K2 in the
    graph) and the kernel-general path (K1 and the chunked VJP), float64,
    under the default adaptive jitter policy, which neither path reads."""
    rng = np.random.RandomState(12)
    x, y = rng.randn(512, 3), rng.randn(512, 1)

    def make():
        kern = kernels.Rbf(3, ARD=True) if route == "fused" else kernels.Rbf(3, ARD=True) + kernels.Linear(3)
        return GPR(x, y, kern, likelihood=likelihoods.Gaussian(0.1), fast=True, fast_block=128)

    with _float64():
        (l0, v0, _, _, _), (l1, v1, _, run, model) = _captured_and_eager(make, "Adam", 4, 1e-2, policy="adaptive")
    assert fit.captures(model, "Adam") and run["captured"]
    launches = run["launches_per_step"]
    if route == "fused":
        assert launches == {"rbf_gram": 1, "radial_contractions": 1, "gram_mvm": 0, "lowrank_contractions": 0}
    else:  # the Gram, the chunk-size probe and the one VJP chunk
        assert launches == {"rbf_gram": 3, "radial_contractions": 0, "gram_mvm": 0, "lowrank_contractions": 0}
    torch.testing.assert_close(l1, l0, rtol=1e-10, atol=0)
    for k in v0:
        torch.testing.assert_close(v1[k], v0[k], rtol=1e-9, atol=1e-12)


def test_adaptive_policy_and_lbfgs_run_eagerly_on_the_card(cuda):
    with _float64():
        model = _svgp_card()
        assert not fit.captures(model, "Adam") and not fit.captures(model, "LBFGS")
        model.fit_scan("Adam", max_iter=2, generator=torch.Generator(device="cuda"))
        assert fit.fit_scan.last_run["captured"] is False


def test_captured_fit_scan_restores_on_a_nonfinite_loss(cuda):
    with _float64(), settings.override(jitter_policy="fixed"):
        model = _svgp_card()
        start = {k: v.detach().clone() for k, v in get_trainable(model).items()}
        with pytest.raises(FloatingPointError):
            model.fit_scan("SGD", max_iter=5, learning_rate=1e12, generator=torch.Generator(device="cuda"))
        for k, v in get_trainable(model).items():
            assert torch.equal(v.detach(), start[k])


def test_lbfgs_card_matches_cpu(cuda):
    """Five L-BFGS iterations of a GPR in float64, the card's route (K1)
    against the CPU's: the same losses and trained values."""
    rng = np.random.RandomState(13)
    x = rng.randn(300, 3)
    y = np.sin(x[:, :1]) + 0.1 * rng.randn(300, 1)
    out = {}
    with _float64():
        for device in ("cuda", "cpu"):
            model = GPR(x, y, kernels.Rbf(3, ARD=True), likelihood=likelihoods.Gaussian(0.1), device=device)
            losses = model.fit_scan("LBFGS", max_iter=5)
            out[device] = (losses.cpu(), {k: v.detach().cpu() for k, v in get_trainable(model).items()})
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-9, atol=0)
    for k, v in out["cuda"][1].items():
        torch.testing.assert_close(v, out["cpu"][1][k], rtol=0, atol=1e-7)


def _zoo(d):
    """The eleven zoo kernels (the wrappers around Rbf) and the input each
    takes, for (n, d) real inputs x."""
    return {
        "Periodic": (kernels.Periodic(d, length_scales=2.0), "x"),
        "ExpSinSquared": (kernels.ExpSinSquared(d, length_scales=np.linspace(0.8, 1.6, d), period=2.0, ARD=True),
                          "x"),
        "SpectralMixture": (kernels.SpectralMixture(d, 4, means=0.1 + 0.05 * np.arange(4 * d).reshape(4, d),
                                                    scales=0.2 + 0.01 * np.arange(4 * d).reshape(4, d)), "x"),
        "ActiveDims": (kernels.ActiveDims(kernels.Rbf(2, ARD=True), [0, d - 1], d), "x"),
        "DeepKernel": (kernels.DeepKernel(kernels.Rbf(2, ARD=True), nn.MLP([d, 16, 2])), "x"),
        "InputWarp": (kernels.InputWarp(kernels.Rbf(d, ARD=True), a=0.8, b=1.3, lo=-4.0, hi=4.0), "x"),
        "MultiFidelity": (kernels.MultiFidelity([kernels.Rbf(d), kernels.Rbf(d, length_scales=2.0)], rho=0.6),
                          "fidelity"),
        "Cosine": (kernels.Cosine(d, length_scales=3.0), "x"),
        "ArcCosine": (kernels.ArcCosine(d, order=1), "x"),
        "ChangePoints": (kernels.ChangePoints([kernels.Rbf(1), kernels.Rbf(1, length_scales=0.5)], [0.0]), "line"),
        "Coregion": (kernels.Coregion(4, rank=2), "task"),
    }


def _zoo_input(kind, x):
    if kind == "fidelity":
        return torch.cat([x, (torch.arange(x.shape[0], device=x.device) % 2).to(x.dtype)[:, None]], dim=1)
    if kind == "line":
        return x[:, :1]
    if kind == "task":
        return (torch.arange(x.shape[0], device=x.device) % 4).to(x.dtype)[:, None]
    return x


@pytest.mark.parametrize("name", sorted(_zoo(3)))
def test_zoo_grams_card_match_cpu(cuda, name):
    """Each zoo kernel's Gram, cross Gram, diagonal and parameter gradient
    in float64: the card (K1 under the Rbf wrappers, index columns cast on
    the card) against the CPU."""
    rng = np.random.RandomState(14)
    x1, x2 = rng.randn(300, 3), rng.randn(170, 3)
    out = {}
    with _float64():
        for device in ("cuda", "cpu"):
            kern, kind = _zoo(3)[name]
            kern = kern.to(device)
            a, b = (_zoo_input(kind, torch.as_tensor(t, device=device)) for t in (x1, x2))
            K, Kx, Kd = kern.K(a), kern.K(a, b), kern.Kdiag(a)
            (K.sum() + (Kx * Kx).sum() + Kd.sum()).backward()
            out[device] = [t.detach().cpu() for t in (K, Kx, Kd)] + [
                v.grad.cpu() for v in get_trainable(kern).values()]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-10 * max(1.0, float(want.abs().max())))


def test_zoo_gram_rows_blocks_on_the_card(cuda, monkeypatch):
    """Without a gradient, the SpectralMixture and ExpSinSquared(ARD) Grams
    go in row blocks on the card; the same Gram as one pass."""
    x = torch.randn(700, 3, generator=torch.Generator(device="cuda").manual_seed(3), device="cuda",
                    dtype=torch.float64)
    for name in ("SpectralMixture", "ExpSinSquared"):
        kern = _zoo(3)[name][0].to(device="cuda", dtype=torch.float64)
        with torch.no_grad():
            whole = kern.K(x)
            monkeypatch.setattr(kernels, "_BLOCK_ELEMENTS", 64 * 700)
            blocked = kern.K(x)
            monkeypatch.setattr(kernels, "_BLOCK_ELEMENTS", 2 ** 27)
        assert torch.equal(whole, blocked)


def test_spectral_mixture_features_on_the_card(cuda):
    """SpectralMixture's random Fourier features drawn on the card: the
    feature estimate of K within 5 standard errors."""
    with _float64():
        kern = _zoo(3)["SpectralMixture"][0].to("cuda")
        x = torch.randn(6, 3, generator=torch.Generator(device="cuda").manual_seed(4), device="cuda") * 0.7
        F = 8192
        phi = sampling.RandomFourierFeatures(kern, F, torch.Generator(device="cuda").manual_seed(0))(x)
        terms = F * phi[:, None, :] * phi[None, :, :]
        z = (terms.mean(-1) - kern.K(x).detach()) / (terms.std(-1) / math.sqrt(F))
        assert float(z.abs().max()) < 5.0


def test_dkl_studentt_svgp_card_matches_cpu(cuda):
    """DeepKernel(Rbf) with an MLP and a StudentT likelihood in an SVGP:
    the full-batch ELBO and its gradient in float64, card against CPU
    within 1e-8 (the inducing points' Gram in a 2-D feature space is far
    worse conditioned than in input space, and carries K1's and the plain
    twin's roundoff into the ELBO), and a captured Adam run on the card."""
    rng = np.random.RandomState(15)
    x = rng.randn(400, 3)
    y = np.sin(x[:, :1]) + 0.1 * rng.standard_t(4.0, (400, 1))
    z = x[rng.permutation(400)[:32]]
    out = {}
    with _float64(), settings.override(jitter_policy="fixed"):
        for device in ("cuda", "cpu"):
            kern = kernels.DeepKernel(kernels.Rbf(2, ARD=True), nn.MLP([3, 16, 16, 2]))
            model = SVGP(x, y, kern, inducing_points=z, likelihood=likelihoods.StudentT(df=4.0), batch_size=64,
                         jitter=1e-4, device=device)
            loss = model.loss(x=model.X, y=model.Y)
            loss.backward()
            out[device] = (float(loss.detach()), {k: v.grad.cpu() for k, v in get_trainable(model).items()})
            del loss  # a live graph of an earlier backward would tie the capture to the default stream
            if device == "cuda":
                losses = model.fit_scan("Adam", max_iter=5, generator=torch.Generator(device="cuda"))
                assert fit.fit_scan.last_run["captured"] and bool(torch.isfinite(losses).all())
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-8)
    scale = max(float(g.abs().max()) for g in out["cpu"][1].values())
    for k, g in out["cuda"][1].items():
        torch.testing.assert_close(g, out["cpu"][1][k], rtol=0, atol=1e-8 * scale)


# -- the matrix-free exact GP: K3 (gram_mvm) and K4 (lowrank_contractions) -------

RADIAL_KINDS = ["rbf", "matern12", "matern32", "matern52", "rq"]
# against the twins in float64 on the same inputs, relative to the sums of
# absolute terms (chip_smoke.py's MVM_TOL, with its reasons)
MVM_TOL = {torch.float32: 2e-5, torch.float64: 1e-10}


def _lowrank_tol(dtype, n):
    """K4's limit (chip_smoke.py's lowrank_tol, with its reasons): MVM_TOL,
    and in float32 also 1e-4/√m of the scale for its m = n(n + 1)/2 pairs,
    which a zero or half-wrong output fails where 2e-5 alone would not."""
    if dtype == torch.float64:
        return MVM_TOL[dtype]
    return min(MVM_TOL[dtype], 1e-4 / math.sqrt(n * (n + 1) / 2))


def _radial_inputs(n, d, cols, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    xs = torch.randn(n, d, generator=g, device="cuda", dtype=dtype) / 1.1
    V = torch.randn(n, cols, generator=g, device="cuda", dtype=dtype)
    return xs, V, torch.tensor(math.log(1.3), device="cuda", dtype=dtype), torch.tensor(
        [math.log(0.7)], device="cuda", dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", RADIAL_KINDS)
@pytest.mark.parametrize("n, d, k, layout", [
    (1, 8, 1, "plain"), (255, 3, 9, "plain"), (257, 8, 1, "plain"), (300, 17, 16, "plain"),
    (513, 32, 40, "plain"), (1000, 8, 256, "plain"),
    # one pass's widths (k rounded up to 4 in float32), n under, at and over
    # a 256-row strip, n under the 128 rows of one warp, d across MAXD
    (255, 9, 2, "plain"), (256, 1, 4, "plain"), (257, 16, 5, "plain"), (100, 8, 12, "plain"),
    (511, 9, 13, "plain"), (512, 8, 17, "plain"), (128, 16, 32, "plain"), (129, 1, 33, "plain"),
    # a common offset: the wrapper's centring keeps the float32 tolerance
    (1000, 8, 9, "offset"),
    # non-contiguous xs and V
    (300, 9, 17, "strided"),
])
def test_mvm_kernel_matches_plain(cuda, dtype, kind, n, d, k, layout):
    xs, V, lv, le = _radial_inputs(n, d, k, dtype, seed=n + k)
    if layout == "offset":
        xs = xs + 40.0
    elif layout == "strided":
        xs = xs.T.contiguous().T
        V = torch.stack([V, -V], dim=2).reshape(n, 2 * k)[:, ::2]
        assert not xs.is_contiguous() and not V.is_contiguous()
    before = mvm.gram_mvm.launches
    got = mvm.gram_mvm(kind, xs, lv, 0.101, V, log_extra=le)
    again = mvm.gram_mvm(kind, xs, lv, 0.101, V, log_extra=le)
    torch.cuda.synchronize()
    assert mvm.gram_mvm.launches == before + 2
    assert torch.equal(got, again)  # no atomics: the same bits from run to run
    ref = (xs.double(), lv.double(), 0.101)
    want = mvm.gram_mvm_plain(kind, *ref, V.double(), 128, le.double())
    scale = mvm.gram_mvm_plain(kind, *ref, V.double().abs(), 128, le.double())
    assert float(((got.double() - want).abs() / scale).max()) <= MVM_TOL[dtype]


def test_mvm_kernel_rejects_wide_inputs(cuda):
    xs, V, lv, _ = _radial_inputs(10, 33, 2, torch.float32, seed=0)
    with pytest.raises(ValueError, match="d <= 32"):
        mvm.gram_mvm("rbf", xs, lv, 0.1, V)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", RADIAL_KINDS)
@pytest.mark.parametrize("n, d, r, layout", [
    (1, 8, 1, "plain"), (255, 3, 9, "plain"), (257, 8, 17, "plain"), (300, 17, 33, "plain"), (1000, 32, 8, "plain"),
    # across a thread's rows (up to four in float32), a 128-record tile, a
    # strip of 128, 256 or 512 rows and its diagonal tiles; the factor width
    # 2r rounded up to 4 (8 in float64) and chunks of 16 columns
    (127, 8, 4, "plain"), (128, 8, 5, "plain"), (129, 8, 12, "plain"), (4097, 8, 16, "plain"),
    (129, 5, 32, "plain"), (128, 16, 9, "symmetric"), (300, 8, 12, "strided"), (4097, 8, 9, "symmetric"),
])
def test_lowrank_kernel_matches_plain(cuda, dtype, kind, n, d, r, layout):
    xs, W, lv, le = _radial_inputs(n, d, 2 * r, dtype, seed=n + r)
    Wl, Wr = W[:, :r].contiguous(), W[:, r:].contiguous()
    if layout == "symmetric":
        Wr = Wl
    elif layout == "strided":
        Wl, Wr = W[:, ::2], W[:, 1::2]
        assert not Wl.is_contiguous() and not Wr.is_contiguous()
    var = torch.exp(lv)
    before = lowrank_contract.lowrank_contractions.launches
    got = lowrank_contract.lowrank_contractions(kind, xs, var, Wl, Wr, log_extra=le)
    again = lowrank_contract.lowrank_contractions(kind, xs, var, Wl, Wr, log_extra=le)
    torch.cuda.synchronize()
    assert lowrank_contract.lowrank_contractions.launches == before + 2 * -(-r // lowrank_contract.MAX_RANK)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = (kind, xs.double(), var.double(), Wl.double(), Wr.double())
    want = lowrank_contract.lowrank_contractions_plain(*ref, 128, le.double())
    scales = lowrank_contract.lowrank_scales(*ref, 128, le.double())
    # the twin's grad_ell by the norm identity cancels: Σ rowsum·x̃² +
    # Σ colsum·x̃² − 2 Σ x̃·(M x̃) leaves up to 4u·Σ|W|E(x̃ᵢq² + x̃ⱼq²) in
    # float64, which matters where the true terms are 0 (n = 1: the
    # diagonal alone)
    x64 = xs.double()
    _, E, _ = gpr_fast._radial_maps(kind, torch.cdist(x64, x64) ** 2, var.double(), le.double())
    WE = (Wl.double().abs() @ Wr.double().abs().T) * E.abs()
    identity = 4 * 2.0**-52 * (WE.sum(dim=1) @ x64**2 + WE.sum(dim=0) @ x64**2)
    for a, b, s, floor in zip(got, want, scales, (0.0, identity, 0.0)):
        assert bool(torch.all((a.double() - b).abs() <= _lowrank_tol(dtype, n) * s + floor))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d, r", [(1, 1), (8, 9), (9, 16), (32, 2)])
def test_lowrank_plan_matches_layout(cuda, dtype, d, r):
    """The kernel's record layout is the one the CPU tests hold
    (lowrank_contract._layout), and its workspace holds a block's sums."""
    lib = lowrank_contract._kernel_library()
    plan = (ctypes.c_int64 * 6)()
    assert lib.lowrank_contract_plan(torch.empty((), dtype=dtype).element_size(), 100000, d, r, 0, plan) == 0
    assert tuple(plan)[:3] == lowrank_contract._layout(dtype, d, r)
    assert plan[3] > 0 and plan[3] == plan[4] * 34 * 8 and plan[5] >= 1


def test_lowrank_launch_rejects_another_plan(cuda):
    """The entry point launches only with the plan of its own arguments."""
    lib = lowrank_contract._kernel_library()
    n, d, r = 1000, 8, 9
    plan = (ctypes.c_int64 * 6)()
    assert lib.lowrank_contract_plan(4, n, d, r, 0, plan) == 0
    rec = torch.zeros((n, plan[2]), device="cuda")
    scal, out = torch.ones(2, device="cuda"), torch.empty(d + 2, device="cuda")
    work = torch.empty((plan[3],), dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    args = (rec.data_ptr(), scal.data_ptr(), work.data_ptr(), out.data_ptr())
    assert lib.lowrank_contract_f32(*args, n, d, r, 0, plan, stream) == 0
    for i, value in ((1, plan[1] + 4), (4, plan[4] + 1), (5, 0)):
        bad = (ctypes.c_int64 * 6)(*plan)
        bad[i] = value
        assert lib.lowrank_contract_f32(*args, n, d, r, 0, bad, stream) != 0
    assert lib.lowrank_contract_f32(*args, 4 * n, d, r, 0, plan, stream) != 0
    torch.cuda.synchronize()


def test_radial_mvm_gradient_on_the_card(cuda):
    """iterative.radial_mvm's backward (K3 for ∂/∂V, K4 for the log
    hyperparameters) against the CPU's twins, float64."""
    rng = np.random.RandomState(3)
    x, V, C = rng.randn(300, 5), rng.randn(300, 4), rng.randn(300, 4)
    theta = [np.log([0.9, 1.2, 0.8, 1.1, 1.0]), np.asarray(np.log(1.3)), np.asarray(np.log(0.1)), np.log([0.7])]
    out = {}
    for device in ("cuda", "cpu"):
        params = [torch.tensor(t, device=device, requires_grad=True) for t in theta]
        v = torch.tensor(V, device=device, requires_grad=True)
        y = iterative.radial_mvm("rq", *params[:3], torch.tensor(x, device=device), v, 1e-3, 128, params[3])
        torch.sum(y * torch.tensor(C, device=device)).backward()
        out[device] = [y.detach().cpu()] + [p.grad.cpu() for p in params + [v]]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_iterative_gpr_card_matches_cpu(cuda):
    """GPR(solver="iterative") at n = 1024 in float64, card (K3, K4)
    against the CPU's twins from the same seeds: loss and gradient to 1e-8,
    the LOVE posterior's moments, and fit_scan running eagerly.  CG solves
    to 1e-10, so the gradient's terms, linear in the solves, are not held
    back by the stopping tolerance (chip_smoke.py's iterative_card_vs_cpu)."""
    rng = np.random.RandomState(4)
    x = rng.randn(1024, 4)
    y = np.sin(x[:, :1]) + 0.1 * rng.randn(1024, 1)
    xq = rng.randn(7, 4)
    out = {}
    with _float64():
        for device in ("cuda", "cpu"):
            model = GPR(x, y, kernels.Rbf(4, ARD=True), likelihood=likelihoods.Gaussian(0.1), solver="iterative",
                        probes=8, max_cg_iters=128, precond_rank=32, cg_tol=1e-10, device=device)
            before = (mvm.gram_mvm.launches, lowrank_contract.lowrank_contractions.launches)
            loss = model.loss()
            loss.backward()
            launched = (mvm.gram_mvm.launches - before[0], lowrank_contract.lowrank_contractions.launches - before[1])
            moments = model.posterior(love_rank=64).predict_f(xq)
            out[device] = (float(loss.detach()), {k: v.grad.cpu() for k, v in get_trainable(model).items()},
                           moments, launched)
            if device == "cuda":
                losses = model.fit_scan("Adam", max_iter=2)
                assert not fit.fit_scan.last_run["captured"] and bool(torch.isfinite(losses).all())
    assert out["cuda"][3][0] >= 64 and out["cuda"][3][1] == 1 and out["cpu"][3] == (0, 0)
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-8)
    scale = max(float(g.abs().max()) for g in out["cpu"][1].values())
    for k, g in out["cuda"][1].items():
        torch.testing.assert_close(g, out["cpu"][1][k], rtol=0, atol=1e-8 * scale)
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-9)


def _gplvm_card(**kw):
    from gptorch_tpu_torch.models import GPLVM

    rng = np.random.RandomState(0)
    y = np.tanh(rng.randn(60, 2) @ rng.randn(2, 6)) + 0.05 * rng.randn(60, 6)
    return GPLVM(y, 3, num_inducing_points=10, device="cuda", **kw)


def _vecchia_card():
    from gptorch_tpu_torch.models import VecchiaGPR

    rng = np.random.RandomState(1)
    x = rng.rand(3000, 3)
    y = np.sin(4.0 * x.sum(axis=1, keepdims=True)) + 0.1 * rng.randn(3000, 1)
    return VecchiaGPR(x, y, kernels.Rbf(3, ARD=True, length_scales=0.3), likelihood=likelihoods.Gaussian(0.01),
                      num_neighbors=16, chunk=1024, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_vecchia_neighbour_grams_one_launch(cuda, dtype):
    """ops.vecchia.batched_gram of an Rbf on the card: one batched K1 launch
    for a chunk's Grams and one for its cross columns, equal to the CPU's
    (float32 2e-5 of var, float64 1e-12), and its gradient too."""
    from gptorch_tpu_torch.ops import vecchia as vops

    rng = np.random.RandomState(7)
    a, b = rng.rand(300, 16, 3), rng.rand(300, 1, 3)
    tol = 2e-5 if dtype == torch.float32 else 1e-12
    out = {}
    for device in ("cuda", "cpu"):
        k = kernels.Rbf(3, ARD=True, length_scales=[0.3, 0.4, 0.5], variance=1.3).to(device=device, dtype=dtype)
        ta, tb = (torch.as_tensor(v, dtype=dtype, device=device) for v in (a, b))
        before = gram.rbf_gram.launches
        knn, kx = vops.batched_gram(k, ta), vops.batched_gram(k, ta, tb)
        launched = gram.rbf_gram.launches - before
        (knn.sum() + kx.sum()).backward()
        out[device] = (knn.detach().cpu(), kx.detach().cpu(),
                       [p.grad.cpu() for p in get_trainable(k).values()], launched)
    assert out["cuda"][3] == 2 and out["cpu"][3] == 0
    for got, want in zip(out["cuda"][:2], out["cpu"][:2]):
        torch.testing.assert_close(got, want, rtol=0, atol=tol * 1.3)
    for got, want in zip(out["cuda"][2], out["cpu"][2]):
        torch.testing.assert_close(got, want, rtol=tol * 10, atol=tol * 10 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["gplvm", "gplvm_large_p", "gplvm_dynamical", "vecchia"])
def test_captured_gplvm_and_vecchia_losses_match_eager(cuda, name):
    """The GPLVM's collapsed bound (iid, large p, dynamical prior) and the
    Vecchia likelihood in float64: fit_scan's captured graph takes the eager
    loop's Adam steps (no host read in either loss; the GPLVM's under the
    fixed jitter policy).  The two loops' Adam bias corrections round apart
    (the step count on the host or on the card), which the dynamical KL
    amplifies by cond(K_t): its time kernel's length scale, 1.5 steps,
    keeps K_t's condition near 3e4 (at 4 steps, about 1e7, the losses part
    by 1e-10 relative after five steps)."""
    make = {"gplvm": _gplvm_card, "gplvm_large_p": lambda: _gplvm_card(large_p=True),
            "gplvm_dynamical": lambda: _gplvm_card(times=np.arange(60.0),
                                                   time_kernel=kernels.Rbf(1, length_scales=1.5)),
            "vecchia": _vecchia_card}[name]
    with _float64():
        (l0, v0, _, _, _), (l1, v1, _, run, _) = _captured_and_eager(make, "Adam", 6, 1e-2)
    assert run["captured"]
    # the Vecchia loss maps Rbf.K over each of its 3 chunks twice (the
    # neighbour Grams and the cross column): one batched K1 launch each
    assert run["launches_per_step"]["rbf_gram"] == {"vecchia": 6, "gplvm_dynamical": 2}.get(name, 1)
    torch.testing.assert_close(l1, l0, rtol=1e-10, atol=0)
    for k in v0:
        torch.testing.assert_close(v1[k], v0[k], rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("cov", ["diag", "full"])
def test_predict_uncertain_card_matches_cpu(cuda, cov):
    """predict_uncertain of VFE, SVGP and GPR with ekernels.Rbf in float64:
    the card (K1 for every Gram) against the CPU, 1e-9."""
    from gptorch_tpu_torch import ekernels

    rng = np.random.RandomState(2)
    x, xq = rng.randn(300, 3), rng.randn(20, 3)
    y = np.sin(x[:, :1]) + 0.1 * rng.randn(300, 1)
    z, a = x[:30] + 0.01, 0.2 * rng.randn(20, 3, 3)
    xv = 0.1 * np.exp(rng.randn(20, 3)) if cov == "diag" else a @ a.transpose(0, 2, 1) + 0.05 * np.eye(3)
    with _float64():
        for make in (lambda d: VFE(x, y, ekernels.Rbf(3, ARD=True), inducing_points=z, device=d),
                     lambda d: SVGP(x, y, ekernels.Rbf(3, ARD=True), inducing_points=z, device=d),
                     lambda d: GPR(x, y, ekernels.Rbf(3, ARD=True), likelihood=likelihoods.Gaussian(0.1), device=d)):
            before = gram.rbf_gram.launches
            card = make("cuda").predict_uncertain(xq, xv)
            assert gram.rbf_gram.launches > before
            for got, want in zip(card, make("cpu").predict_uncertain(xq, xv)):
                np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def _ssgp(device, n=3000, kernel="sum"):
    from gptorch_tpu_torch.models import StateSpaceGPR

    rng = np.random.RandomState(3)
    x = rng.uniform(0.0, 100.0, (n, 1))
    y = np.sin(0.5 * x) + 0.3 * rng.randn(n, 1)
    kern = kernels.Matern32(1, length_scales=0.5) + kernels.Matern52(1) if kernel == "sum" else kernels.Matern32(1)
    return StateSpaceGPR(x, y, kern, likelihood=likelihoods.Gaussian(0.1), device=device)


@pytest.mark.parametrize("chunk", ["0", "512"])
def test_statespace_chunked_scan_card_matches_cpu(cuda, chunk, monkeypatch):
    """The state-space NLML and gradient in float64 (Matern32 + Matern52,
    s = 5: the batched-inverse combine), monolithic and in chunks of 512
    (the three-phase scan): the card against the CPU, 1e-10."""
    monkeypatch.setenv("GPTORCH_TPU_SSM_CHUNK", chunk)
    out = {}
    with _float64():
        for device in ("cuda", "cpu"):
            model = _ssgp(device)
            loss = model.loss()
            loss.backward()
            out[device] = (float(loss.detach()), {k: v.grad.cpu() for k, v in get_trainable(model).items()})
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-10)
    scale = max(float(g.abs().max()) for g in out["cpu"][1].values())
    for k, g in out["cuda"][1].items():
        torch.testing.assert_close(g, out["cpu"][1][k], rtol=0, atol=1e-10 * scale)


def test_statespace_fit_scan_captures_and_matches_eager(cuda):
    """A state-space step holds no host read (closed-form inverses), so
    fit_scan captures it; the captured losses follow the eager loop's in
    float64."""
    with _float64():
        (l0, v0, _, _, _), (l1, v1, _, run, _) = _captured_and_eager(lambda: _ssgp("cuda", kernel="m32"), "Adam", 5,
                                                                     1e-2)
    assert run["captured"]
    torch.testing.assert_close(l1, l0, rtol=1e-10, atol=0)
    for k in v0:
        torch.testing.assert_close(v1[k], v0[k], rtol=1e-9, atol=1e-12)


def _ski(device, n=4000):
    from gptorch_tpu_torch.models import SKIGPR

    rng = np.random.RandomState(4)
    x = rng.uniform(-1.0, 1.0, (n, 3))
    y = np.sin(2.0 * x[:, :1]) + np.cos(3.0 * x[:, 1:2]) + 0.1 * rng.randn(n, 1)
    return SKIGPR(x, y, [kernels.Matern32(1, length_scales=0.5) for _ in range(3)], grid_shape=12,
                  likelihood=likelihoods.Gaussian(0.01), max_cg_iters=64, device=device)


def test_ski_value_and_grad_is_bitwise_repeatable(cuda):
    """Wᵀ sums each grid node's entries in a fixed order, so two identical
    float32 value-and-grads on the card give the same bits, and a
    posterior's means repeat too."""
    model = _ski("cuda")
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss = model.loss()
        loss.backward()
        runs.append((loss.detach().clone(), [p.grad.clone() for p in get_trainable(model).values()]))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    xq = np.random.RandomState(5).uniform(-0.9, 0.9, (64, 3)).astype(np.float32)
    np.testing.assert_array_equal(model.posterior().predict_mean(xq), model.posterior().predict_mean(xq))


def test_ski_card_matches_cpu(cuda):
    """float64, CG to 1e-11 (converged): loss, gradient and predict_f of 8
    on the card against the CPU, 1e-8."""
    from gptorch_tpu_torch.models import SKIGPR

    rng = np.random.RandomState(6)
    x = rng.uniform(-1.0, 1.0, (600, 2))
    y = np.sin(2.0 * x[:, :1]) + 0.1 * rng.randn(600, 1)
    xq = rng.uniform(-0.9, 0.9, (8, 2))
    out = {}
    with _float64():
        for device in ("cuda", "cpu"):
            model = SKIGPR(x, y, [kernels.Matern32(1, length_scales=0.5), kernels.Rbf(1)], grid_shape=20,
                           likelihood=likelihoods.Gaussian(0.1), cg_tol=1e-11, max_cg_iters=300, device=device)
            loss = model.loss()
            loss.backward()
            out[device] = (float(loss.detach()), [p.grad.cpu() for p in get_trainable(model).values()],
                           model.predict_f(xq))
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-8)
    scale = max(float(g.abs().max()) for g in out["cpu"][1])
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-8 * scale)
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8 * np.abs(b).max())


def test_grid_gpr_launches_k1_and_card_matches_cpu(cuda):
    """GridGPR with an Rbf axis: K1 builds the axis Grams and cross Grams on
    the card; loss, gradient and predict_f (diagonal and full) in float64
    against the CPU, 1e-9."""
    from gptorch_tpu_torch.models import GridGPR

    rng = np.random.RandomState(7)
    axes = [np.linspace(0.0, 5.0, 12), np.linspace(0.0, 3.0, 9)]
    y = rng.randn(12 * 9, 1)
    xq = rng.uniform(0.0, 3.0, (10, 2))
    out = {}
    with _float64():
        for device in ("cuda", "cpu"):
            before = gram.rbf_gram.launches
            model = GridGPR(axes, y, [kernels.Rbf(1, length_scales=0.8), kernels.Matern52(1)],
                            likelihood=likelihoods.Gaussian(0.1), device=device)
            loss = model.loss()
            loss.backward()
            out[device] = (float(loss.detach()), [torch.zeros(1) if p.grad is None else p.grad.cpu()
                                                  for p in get_trainable(model).values()],
                           model.predict_f(xq) + model.posterior().predict_f(xq, diag=False),
                           gram.rbf_gram.launches - before)
    assert out["cuda"][3] >= 4 and out["cpu"][3] == 0
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-9)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * np.abs(b).max())


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 2e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("b, n1, n2", [(5, 100, None), (3, 64, 37), (70000, 2, None), (2, 4099, 7)])
def test_batched_kernel_matches_plain(cuda, dtype, tol, b, n1, n2):
    """One launch for a batch of Grams, each with its own var and diag (a
    kernel that read member 0's scalars would fail), against the twin; a
    batch past the grid's 65535 in z too."""
    g = torch.Generator(device="cuda").manual_seed(1)
    x1 = torch.randn(b, n1, 3, generator=g, device="cuda", dtype=dtype)
    x2 = None if n2 is None else torch.randn(b, n2, 3, generator=g, device="cuda", dtype=dtype)
    var = torch.rand(b, generator=g, device="cuda", dtype=dtype) + 0.5
    diag = torch.rand(b, generator=g, device="cuda", dtype=dtype) if n2 is None else None
    before = gram.rbf_gram.launches
    out = gram.rbf_gram(x1, x2, var=var, diag=diag)
    assert gram.rbf_gram.launches == before + 1
    torch.cuda.synchronize()
    want = gram.rbf_gram_plain(x1, x2, var, diag)
    assert float((out - want).abs().max()) <= tol * 2.5


def test_vmap_of_rbf_K_is_one_launch_and_differentiable(cuda):
    """``torch.func.vmap`` over Rbf.K launches K1 once for the mapped Grams;
    the gradient through the map (batched backward) equals autograd through
    the twin, float64, 1e-10."""
    with _float64():
        k = kernels.Rbf(3, ARD=True, length_scales=[0.7, 1.0, 1.4]).to("cuda")
        x = torch.randn(6, 20, 3, device="cuda", dtype=torch.float64, generator=torch.Generator("cuda").manual_seed(2))
        before = gram.rbf_gram.launches
        out = torch.func.vmap(lambda a: k.K(a, diag=torch.tensor(0.1, dtype=torch.float64, device="cuda")))(x)
        assert gram.rbf_gram.launches == before + 1
        ell, var = k.length_scales.value, k.variance.value.reshape(())
        want = gram.rbf_gram_plain(x / ell, None, var.expand(6), torch.full((6,), 0.1, dtype=torch.float64,
                                                                           device="cuda"))
        torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)
        g = torch.randn_like(out)
        got = torch.autograd.grad(out, [k.length_scales.raw, k.variance.raw], g)
        ref = torch.autograd.grad(want, [k.length_scales.raw, k.variance.raw], g)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_ensemble_card_matches_cpu_with_one_launch(cuda):
    """GPEnsemble of 4 members, float64: one K1 launch per value-and-grad;
    losses, gradient and predict_f against the CPU, 1e-9; under the fixed
    policy fit_scan captures the fleet and its losses equal the eager run's."""
    from gptorch_tpu_torch.models import GPEnsemble

    rng = np.random.RandomState(3)
    x = rng.randn(4, 40, 2)
    y = np.sin(x.sum(-1, keepdims=True)) + 0.1 * rng.randn(4, 40, 1)
    xq = rng.randn(7, 2)
    out = {}
    with _float64():
        for device in ("cuda", "cpu"):
            model = GPEnsemble(x, y, kernels.Rbf(2, ARD=True), device=device)
            before = gram.rbf_gram.launches
            loss = model.loss()
            loss.backward()
            launched = gram.rbf_gram.launches - before
            out[device] = (model.losses().detach().cpu(), [p.grad.cpu() for p in get_trainable(model).values()],
                           model.predict_f(xq), launched)
        assert out["cuda"][3] == 1 and out["cpu"][3] == 0
        torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-9, atol=0)
        for a, b in zip(out["cuda"][1], out["cpu"][1]):
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
        for a, b in zip(out["cuda"][2], out["cpu"][2]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * np.abs(b).max())
        runs = []
        for captured in (True, False):
            model = GPEnsemble(x, y, kernels.Rbf(2, ARD=True), device="cuda")
            with settings.override(jitter_policy="fixed"):
                runs.append(fit._fit_scan(model, "Adam", 5, 0.05, None, captured)[1].cpu())
                assert fit.fit_scan.last_run["captured"] == captured
        torch.testing.assert_close(runs[0], runs[1], rtol=1e-10, atol=0)


def test_fleet_adaptive_jitter_on_the_card(cuda):
    """The batched adaptive jitter on the card: only the indefinite member
    is jittered, at the level the probe picks for it alone, and the factors
    equal the CPU's (float64, 1e-10)."""
    from gptorch_tpu_torch import functions

    rng = np.random.RandomState(4)
    mats = []
    for b in range(4):
        q, _ = np.linalg.qr(rng.randn(12, 12))
        lam = np.linspace(0.5, 2.0, 12)
        if b == 2:
            lam[0] = -5e-4
        mats.append((q * lam) @ q.T)
    a = torch.as_tensor(np.stack(mats), device="cuda")
    levels = functions._select_jitter(a).cpu().numpy()
    alone = [float(functions._select_jitter(a[i])) for i in range(4)]
    assert (levels == alone).all() and (levels > 0).tolist() == [False, False, True, False]
    L = functions.cholesky(a, policy="adaptive")
    Lv = torch.func.vmap(lambda m: functions.cholesky(m, policy="adaptive"))(a)
    Lc = functions.cholesky(a.cpu(), policy="adaptive")
    torch.testing.assert_close(L.cpu(), Lc, rtol=0, atol=1e-10)
    torch.testing.assert_close(Lv.cpu(), Lc, rtol=0, atol=1e-10)


@pytest.mark.parametrize("kind", ["changepoints", "multifidelity"])
def test_derivative_gp_wrapped_rbf_card_matches_cpu(cuda, kind):
    """DerivativeGPR whose Rbfs sit inside ChangePoints or MultiFidelity,
    float64: the value block launches K1 on the card, the derivative blocks
    go through the kernels' pair functions (K1 has no forward-mode rule, so
    reaching it would raise here); loss, gradient, predict_f and
    predict_grad against the CPU, 1e-9."""
    from gptorch_tpu_torch.models import DerivativeGPR

    rng = np.random.RandomState(6)
    if kind == "changepoints":
        x, xq = rng.randn(24, 1), rng.randn(5, 1)
    else:
        x, xq = np.c_[rng.randn(24, 2), np.arange(24) % 2], np.c_[rng.randn(5, 2), np.arange(5) % 2]
    y, g = np.sin(x[:, :1]), np.zeros_like(x)
    g[:, 0] = np.cos(x[:, 0])

    def build(device):
        if kind == "changepoints":
            k = kernels.ChangePoints([kernels.Rbf(1), kernels.Rbf(1, variance=0.5)], [0.2], steepness=2.0)
        else:
            k = kernels.MultiFidelity([kernels.Rbf(2, ARD=True), kernels.Rbf(2)], rho=0.7)
        return DerivativeGPR(x, y, k, g, device=device)

    out = {}
    with _float64():
        for device in ("cuda", "cpu"):
            model = build(device)
            before = gram.rbf_gram.launches
            loss = model.loss()
            loss.backward()
            launched = gram.rbf_gram.launches - before
            out[device] = (float(loss.detach()), [p.grad.cpu() for p in get_trainable(model).values()],
                           [*model.predict_f(xq), *model.predict_grad(xq)], launched)
    assert out["cuda"][3] >= 1 and out["cpu"][3] == 0
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-9)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("name", ["icm", "lmc", "derivative", "tpr", "warped", "laplace"])
def test_correlated_derivative_and_variant_models_card_match_cpu(cuda, name):
    """ICM, LMC, the derivative GP, TPR, the warped and the Laplace GP with an
    Rbf kernel, float64: K1 launches on the card and none on the CPU; loss,
    gradient and predict_f against the CPU, 1e-9 (the Laplace GP 1e-7: its
    Newton steps pick their size by the largest ψ on a grid, and near the
    mode the ψ values tie to rounding, so the differentiated path follows
    the device's rounding)."""
    from gptorch_tpu_torch.models import ICM, LMC, TPR, DerivativeGPR, LaplaceGP, WarpedGPR

    rng = np.random.RandomState(5)
    x = rng.randn(30, 2)
    y = np.sin(x[:, :1]) + 0.1 * rng.randn(30, 1)
    xq = rng.randn(6, 2)

    def build(device):
        k = kernels.Rbf(2, ARD=True)
        if name == "icm":
            return ICM(x, np.c_[y, np.cos(x[:, 1:])], k, rank=1, device=device)
        if name == "lmc":
            return LMC(x, np.c_[y, np.cos(x[:, 1:])], k, num_latents=2, inducing_points=x[:8], device=device)
        if name == "derivative":
            return DerivativeGPR(x, y, k, np.cos(x), device=device)
        if name == "tpr":
            return TPR(x, y, k, device=device)
        if name == "warped":
            return WarpedGPR(x, np.exp(y), k, device=device)
        return LaplaceGP(x, (y > 0).astype(float), k, device=device)

    out = {}
    with _float64():
        for device in ("cuda", "cpu"):
            model = build(device)
            before = gram.rbf_gram.launches
            loss = model.loss()
            loss.backward()
            launched = gram.rbf_gram.launches - before
            out[device] = (float(loss.detach()), [p.grad.cpu() for p in get_trainable(model).values()],
                           model.predict_f(xq), launched)
    tol = 1e-7 if name == "laplace" else 1e-9
    assert out["cuda"][3] >= 1 and out["cpu"][3] == 0
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=tol)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    for a, b in zip(out["cuda"][2], out["cpu"][2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-300))


def test_laplace_fit_scan_captures_as_eager(cuda):
    """LaplaceGP's fit_scan on the card replays a captured step (its Newton
    step grid is built on the card and the step picked with no host read)
    and gives the eager loop's losses and values (float64, 1e-7: the two
    Adams round their bias corrections apart, and the Newton steps' ψ ties
    near the mode follow the rounding, as in
    test_correlated_derivative_and_variant_models_card_match_cpu)."""
    from gptorch_tpu_torch.models import LaplaceGP

    rng = np.random.RandomState(5)
    x = rng.randn(40, 1)
    y = (np.sin(2 * x) + 0.3 * rng.randn(40, 1) > 0).astype(float)
    with _float64():
        (el, ev, _, erun, em), (cl, cv, _, crun, cm) = _captured_and_eager(
            lambda: LaplaceGP(x, y, kernels.Rbf(1), likelihoods.Bernoulli(), device="cuda"), "Adam", 10, 0.05,
            policy="adaptive")
    for model in (em, cm):  # free the graph now, not in a later test's capture
        fit.release_graphs(model)
    assert crun["captured"] and not erun["captured"]
    torch.testing.assert_close(cl, el, rtol=1e-7, atol=1e-7)
    for k in ev:
        torch.testing.assert_close(cv[k], ev[k], rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("samples", [1, 3])
def test_deep_gp_one_k1_launch_per_layer_gram(cuda, samples):
    """A DeepGP value-and-grad launches K1 once for each layer's Kuu and once
    for its K(Z, F), whatever the number of samples: a hidden layer's Gram
    of all samples is one batched launch."""
    from gptorch_tpu_torch.models import DeepGP

    rng = np.random.RandomState(6)
    x = rng.randn(64, 2)
    y = np.sin(x[:, :1])
    with _float64():
        model = DeepGP(x, y, widths=(3, 2), num_inducing=8, num_samples=samples, device="cuda")
        before = gram.rbf_gram.launches
        loss = model.loss(generator=torch.Generator(device="cuda").manual_seed(0))
        loss.backward()
    assert gram.rbf_gram.launches - before == 2 * model.num_layers
    assert all(torch.isfinite(p.grad).all() for p in get_trainable(model).values() if p.grad is not None)


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_k1_gradient_into_sample_inputs(cuda, dtype, tol):
    """K1's batched cross Gram of Z, repeated over S samples, against F
    (S, n, d), and its gradient into Z, F, the length scales and the
    variance, against autograd through the plain twin in float64."""
    g = torch.Generator(device="cuda").manual_seed(7)
    z = torch.randn(10, 3, generator=g, device="cuda", dtype=torch.float64)
    F = torch.randn(4, 70, 3, generator=g, device="cuda", dtype=torch.float64)
    cot = torch.randn(4, 10, 70, generator=g, device="cuda", dtype=torch.float64)
    ell = torch.tensor([0.7, 1.1, 1.4], device="cuda", dtype=torch.float64)
    var = torch.tensor(1.3, device="cuda", dtype=torch.float64)
    grads = []
    for fn, dt in ((lambda a, b, v: gram.rbf_gram(a, b, var=v), dtype), (gram.rbf_gram_plain, torch.float64)):
        leaves = [t.to(dt).clone().requires_grad_() for t in (z, F, ell, var)]
        zl, Fl, el, vl = leaves
        before = gram.rbf_gram.launches
        out = fn((zl.expand(4, -1, -1) / el).contiguous(), (Fl / el).contiguous(), vl)
        assert gram.rbf_gram.launches - before == (0 if fn is gram.rbf_gram_plain else 1)
        grads.append([t.double() for t in torch.autograd.grad(out, leaves, cot.to(dt))])
    for a, b in zip(*grads):
        assert float((a - b).abs().max() / b.abs().max()) <= tol


def test_streaming_vfe_stream_replays_as_one_graph(cuda):
    """A stream of equal-sized StreamingVFE updates captured as one CUDA
    graph (no host read in ``update``) replays to the eager statistics."""
    from gptorch_tpu_torch.models import StreamingVFE

    rng = np.random.RandomState(8)
    x = torch.as_tensor(rng.randn(6, 50, 2), device="cuda")
    y = torch.sin(x[..., :1])
    z = rng.randn(12, 2)
    with _float64(), settings.override(jitter_policy="none"), torch.no_grad():
        eager = StreamingVFE(kernels.Rbf(2), z, likelihood=likelihoods.Gaussian(0.1), device="cuda")
        s0 = StreamingVFE(kernels.Rbf(2), z, likelihood=likelihoods.Gaussian(0.1), device="cuda")
        for i in range(6):
            eager = eager.update(x[i], y[i])

        def stream():
            s = s0
            for i in range(6):
                s = s.update(x[i], y[i])
            return s

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            stream()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = gram.rbf_gram.launches
        with torch.cuda.graph(graph):
            captured = stream()
        assert gram.rbf_gram.launches - before == 12  # Kuu and Kuf of each update, recorded once
        graph.replay()
        torch.cuda.synchronize()
        for name in ("phi_w", "r_w", "yy", "kdiag_sum", "n_seen"):
            torch.testing.assert_close(getattr(captured, name), getattr(eager, name), rtol=1e-12, atol=1e-12)
        assert float(captured.log_likelihood()) == pytest.approx(float(eager.log_likelihood()), rel=1e-12)


def test_online_sgpr_step_reuses_its_captured_graph(cuda):
    """OnlineSGPR.step under the fixed jitter policy captures one optimizer
    step per (batch size, has_old) and replays it; the captured steps match
    the CPU's eager ones."""
    from gptorch_tpu_torch.models import OnlineSGPR

    rng = np.random.RandomState(9)
    x = rng.randn(120, 2)
    y = np.sin(x[:, :1]) + 0.1 * rng.randn(120, 1)
    out = {}
    with _float64(), settings.override(jitter_policy="fixed"):
        for device in ("cuda", "cpu"):
            model = OnlineSGPR(kernels.Rbf(2, ARD=True), x[:10], likelihood=likelihoods.Gaussian(0.1), device=device)
            for lo in range(0, 120, 40):
                model.step(x[lo : lo + 40], y[lo : lo + 40], fit_iters=5)
            out[device] = (model, model.predict_f(x[:5]))
    assert len(fit._GRAPHS[out["cuda"][0]]) == 2 and out["cpu"][0] not in fit._GRAPHS
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-8 * np.abs(b).max())


def _held_uniform(monkeypatch, arrays):
    """sampling.uniform returns ``arrays`` in turn, on the caller's device."""
    queue = list(arrays)
    monkeypatch.setattr(sampling, "uniform", lambda generator, shape, like: torch.as_tensor(
        queue.pop(0), dtype=like.dtype, device=like.device))


def _bo_model(device):
    rng = np.random.RandomState(11)
    x = rng.rand(30, 2)
    y = np.sum((x - 0.3) ** 2, axis=1, keepdims=True) + 0.01 * rng.randn(30, 1)
    return GPR(x, y, kernels.Rbf(2, ARD=True), likelihood=likelihoods.Gaussian(1e-3), fast=False, device=device)


def test_suggest_card_matches_cpu(cuda, monkeypatch):
    """bayesopt.suggest on held candidates (64, 8 refinement steps), float64:
    the card's point equals the CPU's to 1e-8, and K1 launched for the
    candidates' cross Gram and every refinement step's."""
    from gptorch_tpu_torch import bayesopt

    u = np.random.RandomState(12).rand(64, 2)
    out = {}
    with _float64():
        for device in ("cuda", "cpu"):
            _held_uniform(monkeypatch, [u])
            model = _bo_model(device)
            before = gram.rbf_gram.launches
            out[device] = (bayesopt.suggest(model, [[0, 1], [0, 1]], n_candidates=64, refine_steps=8,
                                            generator=torch.Generator(device=device)),
                           gram.rbf_gram.launches - before)
    assert out["cuda"][1] >= 10 and out["cpu"][1] == 0  # posterior, candidates, 8 steps and the check
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-8)


def test_alc_acquisition_card_matches_cpu(cuda):
    """design.alc_acquisition on the same posterior, float64: the card's
    scores equal the CPU's (1e-10 of the largest), its three cross Grams on
    K1."""
    from gptorch_tpu_torch import design

    rng = np.random.RandomState(13)
    cand, ref = rng.rand(50, 2), rng.rand(20, 2)
    out = {}
    with _float64():
        for device in ("cuda", "cpu"):
            post = _bo_model(device).posterior()
            before = gram.rbf_gram.launches
            out[device] = (design.alc_acquisition(post, cand, ref).cpu().numpy(), gram.rbf_gram.launches - before)
    assert out["cuda"][1] == 3 and out["cpu"][1] == 0
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-10 * np.abs(out["cpu"][0]).max())


def test_kfold_cv_card_matches_cpu(cuda):
    """metrics.kfold_cv at k = 3, n = 96, 20 Adam iterations, float64: the
    card's fold RMSE and NLPD equal the CPU's (1e-8); the fleet's Grams are
    batched K1 launches."""
    from gptorch_tpu_torch import metrics

    rng = np.random.RandomState(14)
    x = rng.randn(96, 3)
    y = np.sin(x[:, :1]) + 0.1 * rng.randn(96, 1)
    out = {}
    with _float64():
        for device in ("cuda", "cpu"):
            before = gram.rbf_gram.launches
            res = metrics.kfold_cv(x, y, lambda: kernels.Rbf(3, ARD=True), k=3, fit_iters=20, device=device)
            out[device] = (res, gram.rbf_gram.launches - before)
    assert out["cuda"][1] > 0 and out["cpu"][1] == 0
    for key in ("fold_rmse", "fold_nlpd"):
        np.testing.assert_allclose(out["cuda"][0][key], out["cpu"][0][key], rtol=1e-8)


def test_search_candidate_card_matches_cpu(cuda):
    """One kernel_search candidate, Rbf + Linear trained by L-BFGS (10
    iterations), float64: the card's NLML equals the CPU's (1e-8), its Rbf
    term on K1; the kernel it starts from is unchanged."""
    from gptorch_tpu_torch import structure

    rng = np.random.RandomState(15)
    x = np.linspace(0, 4, 40)[:, None]
    y = 0.5 * x + np.sin(3 * x) + 0.1 * rng.randn(40, 1)
    out = {}
    with _float64():
        for device in ("cuda", "cpu"):
            kern = kernels.Rbf(1) + kernels.Linear(1)
            start = {k: v.detach().clone() for k, v in get_trainable(kern).items()}
            before = gram.rbf_gram.launches
            model, nlml = structure._train(x, y, kern, None, method="LBFGS", max_iter=10, learning_rate=None,
                                           restarts=1, generator=torch.Generator(device=device), jitter_scale=0.5,
                                           device=device)
            out[device] = (nlml, gram.rbf_gram.launches - before)
            assert model.device.type == device
            assert all(torch.equal(start[k], v) for k, v in get_trainable(kern).items())
    assert out["cuda"][1] > 0 and out["cpu"][1] == 0
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-8)


def test_checkpoint_load_under_a_cached_graph(cuda, tmp_path):
    """load_trainable into a model whose captured fit_scan graph is cached
    writes in place: the next fit_scan replays that graph (no new capture)
    and gives the losses of a fresh model loaded from the same file."""
    from gptorch_tpu_torch.training import checkpoint

    rng = np.random.RandomState(16)
    x = rng.randn(200, 3)
    y = np.sin(x[:, :1]) + 0.1 * rng.randn(200, 1)
    path = str(tmp_path / "start.npz")
    with _float64(), settings.override(jitter_policy="fixed"):
        def build():
            return GPR(x, y, kernels.Rbf(3, ARD=True), likelihood=likelihoods.Gaussian(0.1), fast=False,
                       device="cuda")

        model = build()
        checkpoint.save_trainable(path, model)
        first = fit.fit_scan(model, "Adam", max_iter=5, learning_rate=0.05)[1].cpu()
        assert fit.fit_scan.last_run["captured"] and len(fit._GRAPHS[model]) == 1
        checkpoint.load_trainable(path, model)
        again = fit.fit_scan(model, "Adam", max_iter=5, learning_rate=0.05)[1].cpu()
        assert len(fit._GRAPHS[model]) == 1  # replayed, not captured anew
        fresh = checkpoint.load_trainable(path, build())
        want = fit.fit_scan(fresh, "Adam", max_iter=5, learning_rate=0.05)[1].cpu()
    torch.testing.assert_close(again, want, rtol=1e-12, atol=0)
    torch.testing.assert_close(first, want, rtol=1e-12, atol=0)


# -- K1's mappings (ops/gram.py:plan): tiles with 16-byte or scalar stores, -----
# -- a symmetric Gram mirrored, members packed a warp each, a thread a row ------

_K1_TOL = {torch.float32: 2e-5 * 1.3, torch.float64: 1e-12 * 1.3}  # chip_smoke.py's TOL, x1.3


def _k1_inputs(b, n1, n2, d, dtype, seed):
    """Inputs of ``b`` Grams (b None: one Gram), a var (and a diag) per
    member."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if b is None else (b,)
    x1 = torch.randn(lead + (n1, d), generator=g, device="cuda", dtype=dtype)
    x2 = None if n2 is None else torch.randn(lead + (n2, d), generator=g, device="cuda", dtype=dtype)
    var = torch.rand(lead, generator=g, device="cuda", dtype=dtype) + 0.5
    diag = torch.rand(lead, generator=g, device="cuda", dtype=dtype) * 0.1 + 0.01
    return x1, x2, var, diag


def _k1_mapping(b, n1, n2, dtype):
    limits = gram._grid_limits(dtype == torch.float64, torch.cuda.current_device())
    n2_ = n1 if n2 is None else n2
    return gram.MAPPINGS[gram.plan(b or 1, n1, n2_, n2 is None, 8 if dtype == torch.float64 else 4, limits)[0]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b, n1, n2, mapping", [
    (None, 130, 1031, "tiles"),        # rows of 1031: not 16-byte aligned in either type
    (None, 70, 4001, "tiles"),
    (None, 65, 1030, {torch.float32: "tiles", torch.float64: "tiles_vec"}),  # even n2: aligned in float64 only
    (None, 129, 1028, "tiles_vec"),
    (None, 1031, None, "half"),        # symmetric, ragged and misaligned
    (None, 300, None, "half_vec"),
    (3, 65, 67, "tiles"),              # members start at misaligned offsets
    (4, 130, 132, "tiles_vec"),
    (5, 67, None, "half"),
    (7, 32, 32, "packed"),             # the Vecchia chunk's members
    (9, 32, None, "packed"),
    (6, 5, 7, "packed"),               # members at misaligned offsets, packed
    (None, 1, 1, "rows"),
    (11, 32, 1, "rows"),
    (13, 1, 1, "rows"),
    (None, 4099, 1, "rows"),
    (None, 1, None, "rows"),
    (None, 4, 32768, "columns"),       # a few queries against many points
    (5, 16, 257, "columns"),
    (None, 1, 4001, "columns"),
    (None, 17, 4001, "tiles"),
])
def test_k1_mappings_match_plain(cuda, dtype, b, n1, n2, mapping):
    """Each mapping against the twin at shapes that break 16-byte alignment
    (rows and members), small members, single columns; one launch each."""
    x1, x2, var, diag = _k1_inputs(b, n1, n2, 9, dtype, seed=n1 + (n2 or 0))
    want_map = mapping[dtype] if isinstance(mapping, dict) else mapping
    assert _k1_mapping(b, n1, n2, dtype) == want_map
    diag = diag if n2 is None else None
    before = gram.rbf_gram.launches
    out = gram.rbf_gram(x1, x2, var=var, diag=diag)
    assert gram.rbf_gram.launches == before + 1
    torch.cuda.synchronize()
    want = gram.rbf_gram_plain(x1, x2, var, diag)
    scale = var if b is None else var[:, None, None]
    assert float(((out - want).abs() / scale).max()) <= _K1_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b, n, noise", [(None, 1000, True), (None, 1000, False), (None, 257, True), (3, 200, True),
                                         (4, 32, True), (None, 20, False)])
def test_k1_symmetric_is_exact(cuda, dtype, b, n, noise):
    """A symmetric Gram is bitwise symmetric and its diagonal exactly var
    (plus diag, added last), in every mapping a symmetric Gram takes."""
    x1, _, var, diag = _k1_inputs(b, n, None, 8, dtype, seed=n)
    diag = diag if noise else None
    out = gram.rbf_gram(x1, var=var, diag=diag)
    assert torch.equal(out, out.mT)
    want = (var + diag if noise else var)[..., None].expand(out.shape[:-1])
    assert torch.equal(out.diagonal(dim1=-2, dim2=-1), want)
    if noise:  # before the diagonal is added: exactly var
        bare = gram.rbf_gram(x1, var=var)
        assert torch.equal(bare.diagonal(dim1=-2, dim2=-1), var[..., None].expand(out.shape[:-1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [0, 1, 8, 9, 33])
@pytest.mark.parametrize("b, n1, n2", [(None, 150, None), (None, 100, 67), (5, 32, 32), (5, 32, 1), (3, 4, 100)])
def test_k1_feature_widths(cuda, dtype, d, b, n1, n2):
    """d = 0 (r² = 0), 1, 8 (one stage), 9 and 33 (stages of 8 and a
    remainder) in every mapping, against the twin."""
    x1, x2, var, diag = _k1_inputs(b, n1, n2, d, dtype, seed=d)
    out = gram.rbf_gram(x1, x2, var=var)
    torch.cuda.synchronize()
    scale = var if b is None else var[:, None, None]
    assert float(((out - gram.rbf_gram_plain(x1, x2, var)).abs() / scale).max()) <= _K1_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b, n1, n2", [(None, 200, None), (None, 200, 130), (3, 32, 32), (3, 32, 1), (2, 8, 300)])
def test_k1_nan_stays_nan(cuda, dtype, b, n1, n2):
    """A NaN coordinate gives NaN in its row (and, symmetric, its column,
    the diagonal too) and nowhere else: the clamp at 0 keeps a NaN a NaN."""
    x1, x2, var, _ = _k1_inputs(b, n1, n2, 4, dtype, seed=7)
    x1[..., 3, 2] = float("nan")
    out = gram.rbf_gram(x1, x2, var=var)
    want = torch.zeros_like(out, dtype=torch.bool)
    want[..., 3, :] = True  # the twin zeroes a symmetric Gram's diagonal r², NaN or not: compare with this
    if x2 is None:
        want[..., :, 3] = True
    assert torch.equal(torch.isnan(out), want)


@pytest.mark.parametrize("b, n1, n2", [(70000, 2, None), (70000, 1, 1), (70000, 3, 65), (70000, 20, 40)])
def test_k1_large_batches(cuda, b, n1, n2):
    """A batch past the old grid's 65535 in every mapping, one launch."""
    x1, x2, var, diag = _k1_inputs(b, n1, n2, 3, torch.float32, seed=b)
    diag = diag if n2 is None else None
    before = gram.rbf_gram.launches
    out = gram.rbf_gram(x1, x2, var=var, diag=diag)
    assert gram.rbf_gram.launches == before + 1
    torch.cuda.synchronize()
    want = gram.rbf_gram_plain(x1, x2, var, diag)
    assert float(((out - want).abs() / var[:, None, None]).max()) <= _K1_TOL[torch.float32]


def test_k1_rows_past_the_old_limit(cuda):
    """n1 past the old launch's 65535 · 64 rows (a cross Gram of 64
    columns): planned and computed; past MAX_ROWS a clear error."""
    n1 = 65535 * 64 + 100
    x1, x2, var, _ = _k1_inputs(None, n1, 64, 2, torch.float32, seed=5)
    out = gram.rbf_gram(x1, x2, var=var)
    torch.cuda.synchronize()
    assert float(((out[-1000:] - gram.rbf_gram_plain(x1[-1000:], x2, var)).abs()).max()) <= _K1_TOL[torch.float32]
    with pytest.raises(ValueError, match="rows exceed"):
        gram.plan(1, gram.MAX_ROWS + 1, 64, False, 4, gram._grid_limits(False, torch.cuda.current_device()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k1_captured_equals_eager(cuda, dtype):
    """K1 calls of each mapping captured in one CUDA graph and replayed equal
    the eager calls bitwise; a Python-number var inside the capture is
    filled in the graph, not taken from the eager cache."""
    shapes = [(None, 300, None), (None, 130, 1031), (6, 32, 32), (6, 32, 1), (3, 100, 64), (None, 4, 3000)]
    inputs = [_k1_inputs(b, n1, n2, 5, dtype, seed=n1) for b, n1, n2 in shapes]

    def calls():
        outs = [gram.rbf_gram(x1, x2, var=var, diag=diag if x2 is None else None) for x1, x2, var, diag in inputs]
        return outs + [gram.rbf_gram(inputs[0][0], var=1.3, diag=0.1)]

    eager = calls()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = calls()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


def test_k1_number_constants_are_per_stream(cuda):
    """A Python-number var is cached as a device scalar for each stream: a
    call on a side stream does not read the current stream's tensor, which
    the allocator could hand to that stream once the cache lets it go."""
    x1, _, _, _ = _k1_inputs(None, 100, None, 3, torch.float32, seed=3)
    main = gram.rbf_gram(x1, var=1.7)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = gram.rbf_gram(x1, var=1.7)
        on_side = gram._scalar(1.7, x1)
    torch.cuda.current_stream().wait_stream(side)
    on_main = gram._scalar(1.7, x1)
    assert on_side.data_ptr() != on_main.data_ptr()
    assert torch.equal(main, other)


def test_k1_one_launch_and_no_side_launches(cuda):
    """A call makes exactly one device launch (the profiler's kernel list):
    no fill, stack or zeros beside it, for a tensor var with and without a
    diagonal and for a Python-number var (cached outside a capture)."""
    x1, x2, var, diag = _k1_inputs(None, 300, 200, 8, torch.float32, seed=1)
    gram.rbf_gram(x1, var=2.0)  # the cached constant is made here
    cases = [lambda: gram.rbf_gram(x1, var=var), lambda: gram.rbf_gram(x1, var=var, diag=diag),
             lambda: gram.rbf_gram(x1, x2, var=var), lambda: gram.rbf_gram(x1, var=2.0)]
    for case in cases:
        torch.cuda.synchronize()
        before = gram.rbf_gram.launches
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            case()
            torch.cuda.synchronize()
        assert gram.rbf_gram.launches == before + 1
        kernels_run = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                       and not getattr(e, "is_user_annotation", False)]
        launched = [k for k in kernels_run if "rbf_gram_kernel" in k]
        assert len(launched) == 1 and len(kernels_run) == 1, kernels_run


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("b, n1, n2", [(None, 1000, None), (None, 4099, 1028), (None, 300, 1031), (4, 130, None)])
def test_k1_grid_choices_equal(cuda, dtype, b, n1, n2):
    """The plan's grid and walks of many tiles a block (grids of 1, 7 and 133
    blocks, stepping across members' ends) give the same Gram bit for bit."""
    x1, x2, var, diag = _k1_inputs(b, n1, n2, 8, dtype, seed=n1)
    diag = diag if n2 is None else None
    want = gram.rbf_gram(x1, x2, var=var, diag=diag)
    for grid in (1, 7, 133):
        assert torch.equal(gram._launch(x1, x2, var, diag, grid=grid), want)


# -- MCMC (gptorch_tpu_torch.mcmc): the JAX tests' statistical assertions at their
# own sizes, captured against eager, and the fused losses' vmap rule -----------------


@pytest.fixture
def f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def test_mcmc_standard_normal_moments(cuda, f64):
    from gptorch_tpu_torch import mcmc

    res, _ = mcmc.hmc(lambda t: -0.5 * torch.sum(t["x"] ** 2), {"x": torch.zeros(5)}, _gen(0), num_samples=1000,
                      num_warmup=500)
    qs = res.samples.cpu().numpy()
    assert qs.shape == (1000, 5) and int(res.divergent.sum()) == 0
    assert 0.6 < float(res.accept_prob.mean()) <= 1.0
    assert np.abs(qs.mean(0)).max() < 0.15 and np.allclose(qs.std(0), 1.0, atol=0.15)


def test_mcmc_mass_adaptation_scales_to_target(cuda, f64):
    from gptorch_tpu_torch import mcmc

    scales = torch.tensor([10.0, 0.1], device="cuda")
    res, _ = mcmc.hmc(lambda t: -0.5 * torch.sum((t["x"] / scales) ** 2), {"x": torch.zeros(2)}, _gen(1),
                      num_samples=1500, num_warmup=1000)
    s = scales.cpu().numpy()
    assert np.allclose(res.samples.cpu().numpy().std(0) / s, 1.0, atol=0.25)
    ratio = res.inv_mass.cpu().numpy() / s**2
    assert np.all(ratio > 0.4) and np.all(ratio < 2.5)


def test_mcmc_nuts_correlated_gaussian_moments(cuda, f64):
    from gptorch_tpu_torch import mcmc

    rng = np.random.RandomState(0)
    A = rng.randn(3, 3)
    cov = A @ A.T + 0.5 * np.eye(3)
    mu = np.array([1.0, -2.0, 0.5])
    prec, mu_t = torch.tensor(np.linalg.inv(cov), device="cuda"), torch.tensor(mu, device="cuda")
    res, unravel = mcmc.nuts(lambda x: -0.5 * (x - mu_t) @ prec @ (x - mu_t), torch.zeros(3), _gen(0),
                             num_samples=3000, num_warmup=1000)
    s = res.samples.cpu().numpy()
    assert unravel(res.samples[0]).shape == (3,)
    assert float(res.divergent.double().mean()) == 0.0
    assert 0.6 < float(res.accept_prob.mean()) < 0.95
    assert np.all(np.abs(s.mean(0) - mu) < 0.2)
    assert np.max(np.abs(np.cov(s.T) - cov)) / np.max(np.abs(cov)) < 0.15


def test_mcmc_nuts_anisotropic_without_mass_adaptation(cuda, f64):
    from gptorch_tpu_torch import mcmc

    scales = torch.tensor([1.0, 30.0], device="cuda")
    res, _ = mcmc.nuts(lambda x: -0.5 * torch.sum((x / scales) ** 2), torch.zeros(2), _gen(4), num_samples=2000,
                       num_warmup=500, adapt_mass=False)
    assert np.allclose(res.samples.cpu().numpy().std(0) / scales.cpu().numpy(), 1.0, atol=0.3)


def _prior_only(prior):
    from gptorch_tpu_torch.module import Module
    from gptorch_tpu_torch.param import positive_param

    class PriorOnly(Module):
        def __init__(self):
            super().__init__()
            self.rate = positive_param(1.0, prior=prior)

        def _loss(self):
            return -self.log_prior()

    return PriorOnly().to("cuda")


@pytest.mark.parametrize("jacobian, mean", [(True, -0.5), (False, -0.5 - 0.7**2)])
def test_mcmc_jacobian_correction(cuda, f64, jacobian, mean):
    """LogNormal(μ, s) prior under the Exp bijector: with the correction the
    raw value is exactly N(μ, s); without it the mode shifts to μ − s²."""
    from gptorch_tpu_torch import mcmc, priors

    model = _prior_only(priors.LogNormal(-0.5, 0.7))
    res, _ = mcmc.hmc(mcmc.log_posterior_fn(model, jacobian=jacobian), get_trainable(model), _gen(3),
                      num_samples=2000, num_warmup=500)
    raw = res.samples[:, 0].cpu().numpy()
    assert abs(raw.mean() - mean) < 0.08
    if jacobian:
        assert abs(raw.std() - 0.7) < 0.08


def _mcmc_gpr():
    from gptorch_tpu_torch import priors
    from gptorch_tpu_torch.param import positive_param

    rng = np.random.RandomState(0)
    x = rng.randn(40, 1)
    y = np.sin(2 * x) + 0.2 * rng.randn(40, 1)
    k = kernels.Rbf(1, variance=1.0, length_scales=0.5)
    k.variance = positive_param(1.0, prior=priors.LogNormal(0.0, 1.0))
    k.length_scales = positive_param(0.5, prior=priors.LogNormal(-1.0, 1.0))
    return GPR(x, y, k, likelihood=likelihoods.Gaussian(variance=0.05), device="cuda")


@pytest.fixture(scope="module")
def mcmc_gpr_samples():
    """The JAX tests' fixture (2 chains x 300 + 300, 16 leapfrogs), captured
    under the fixed jitter policy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    from gptorch_tpu_torch import mcmc

    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        model = _mcmc_gpr()
        with settings.override(jitter_policy="fixed"):
            samples, res = mcmc.sample_posterior(model, _gen(1), num_samples=300, num_warmup=300, num_chains=2,
                                                 num_leapfrog=16)
            assert mcmc.sample_posterior.last_run.capture
            nuts_samples, nuts_res = mcmc.sample_posterior(model, _gen(7), num_samples=300, num_warmup=300,
                                                           num_chains=2, sampler="nuts")
    finally:
        torch.set_default_dtype(old)
    return model, samples, res, nuts_samples, nuts_res


def test_mcmc_model_posterior_shapes_mixing_and_truth(cuda, mcmc_gpr_samples):
    from gptorch_tpu_torch import mcmc

    model, samples, res, _, _ = mcmc_gpr_samples
    assert set(samples) == {"kernel.length_scales", "kernel.variance", "likelihood.variance"}
    ls = samples["kernel.length_scales"]
    assert ls.shape == (2, 300) and bool((ls > 0).all()) and bool((samples["likelihood.variance"] > 0).all())
    assert int(res.divergent.sum()) == 0 and float(res.accept_prob.mean()) > 0.6
    assert float(mcmc.potential_scale_reduction(ls)) < 1.1 and float(mcmc.effective_sample_size(ls)) > 100.0
    assert 0.01 < float(samples["likelihood.variance"].mean()) < 0.1
    assert 0.3 < float(ls.mean()) < 2.0


def test_mcmc_nuts_matches_hmc(cuda, mcmc_gpr_samples):
    from gptorch_tpu_torch import mcmc

    _, hmc_samples, _, samples, res = mcmc_gpr_samples
    assert set(samples) == set(hmc_samples)
    assert int(res.divergent.sum()) == 0 and float(res.accept_prob.mean()) > 0.6
    for name in samples:
        a, b = samples[name].ravel(), hmc_samples[name].ravel()
        assert abs(float(a.mean() - b.mean())) < max(float(a.std()), float(b.std()))
        assert float(mcmc.potential_scale_reduction(samples[name]).max()) < 1.1


def test_mcmc_predict_mixture(cuda, f64, mcmc_gpr_samples, monkeypatch):
    from gptorch_tpu_torch import mcmc

    model, samples, _, _, _ = mcmc_gpr_samples
    xs = np.linspace(-2, 2, 7)[:, None]
    mean, var = mcmc.predict_mixture(model, samples, xs)
    assert mean.shape == (7, 1) and var.shape == (7, 1)
    assert bool(torch.isfinite(mean).all()) and float(var.min()) > 1e-4
    point_mean, _ = model.predict_y(xs)
    assert float((mean.cpu() - torch.as_tensor(point_mean)).abs().max()) < 0.5
    # chunks of draws give the same mixture
    monkeypatch.setattr(mcmc, "_mixture_chunk", lambda model, draws: 7)
    chunked = mcmc.predict_mixture(model, samples, xs)
    for a, b in zip((mean, var), chunked):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def _latent_gpr(n, seed):
    rng = np.random.RandomState(seed)
    x = np.linspace(-2, 2, n)[:, None]
    y = np.sin(2 * x) + 0.1 * rng.randn(n, 1)
    return x, GPR(x, y, kernels.Rbf(1), likelihood=likelihoods.Gaussian(0.01), device="cuda")


def test_mcmc_sample_latent_matches_conjugate_posterior(cuda, f64):
    from gptorch_tpu_torch import mcmc

    x, m = _latent_gpr(30, 0)
    draws = mcmc.sample_latent(m, _gen(0), num_samples=2000, num_burn=300)
    assert draws.shape == (2000, 30, 1)
    mu_exact, var_exact = m.predict_f(x)
    d = draws.cpu().numpy()
    assert (np.abs(d.mean(0) - mu_exact) < np.sqrt(var_exact)).all()
    assert d.var(0) == pytest.approx(var_exact, abs=2e-3)


def test_mcmc_predict_latent_mixture_matches_exact(cuda, f64):
    from gptorch_tpu_torch import mcmc

    _, m = _latent_gpr(25, 1)
    draws = mcmc.sample_latent(m, _gen(2), num_samples=1500, num_burn=300)
    xs = np.linspace(-1.8, 1.8, 9)[:, None]
    mm, vv = mcmc.predict_latent_mixture(m, draws, xs)
    me, ve = m.predict_f(xs)
    assert (np.abs(mm.cpu().numpy() - me) < 2 * np.sqrt(ve) + 0.02).all()
    assert vv.cpu().numpy() == pytest.approx(ve, abs=3e-3)


def test_mcmc_bernoulli_agrees_with_laplace(cuda, f64):
    from gptorch_tpu_torch import mcmc
    from gptorch_tpu_torch.models import LaplaceGP

    x = np.linspace(-2, 2, 30)[:, None]
    y = (np.sin(2 * x) > 0).astype(float)
    m = LaplaceGP(x, y, kernels.Rbf(1), likelihoods.Bernoulli(), device="cuda")
    draws = mcmc.sample_latent(m, _gen(3), num_samples=1500, num_burn=400)
    corr = np.corrcoef(draws.mean(0).cpu().numpy().ravel(), m.predict_f(x)[0].ravel())[0, 1]
    assert corr > 0.99


def test_mcmc_elliptical_slice_reproducible_and_multicolumn(cuda, f64):
    from gptorch_tpu_torch import mcmc

    L = torch.eye(4, device="cuda")
    loglik = lambda f: -0.5 * torch.sum(torch.square(f - 1.0))  # noqa: E731
    f0 = torch.zeros((4, 2), device="cuda")
    d1, d2 = (mcmc.elliptical_slice(loglik, L, f0, _gen(0), num_samples=50, num_burn=10) for _ in range(2))
    assert d1.shape == (50, 4, 2) and torch.equal(d1, d2)
    assert mcmc.elliptical_slice.last_run.capture
    d3 = mcmc.elliptical_slice(loglik, L, f0, _gen(1), num_samples=4000, num_burn=200)
    assert float(d3.mean()) == pytest.approx(0.5, abs=0.05)
    assert float(d3.var()) == pytest.approx(0.5, abs=0.05)


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_mcmc_captured_equals_eager(cuda, f64, sampler, monkeypatch):
    """The captured transitions replay the eager run bit for bit on the same
    draws (the private generator registered with the graphs continues the
    caller's stream), on the GPR's log posterior under the fixed policy."""
    from gptorch_tpu_torch import mcmc

    model = _mcmc_gpr()
    logpi = mcmc.log_posterior_fn(model)
    fn = mcmc.hmc if sampler == "hmc" else mcmc.nuts
    kw = {"num_leapfrog": 8} if sampler == "hmc" else {"max_depth": 6}
    runs = []
    with settings.override(jitter_policy="fixed"):
        for capture in (True, False):
            monkeypatch.setattr(mcmc, "captures", lambda device, reads_host=False: capture)
            gen = _gen(5)
            res, _ = fn(logpi, get_trainable(model), gen, num_samples=20, num_warmup=20, **kw)
            runs.append((res, gen.get_state()))
    (cap, cap_state), (eager, eager_state) = runs
    for a, b in zip(cap, eager):
        if a is not None:
            assert torch.equal(a, b)
    assert torch.equal(cap_state, eager_state)  # the caller's generator advanced alike


@pytest.mark.parametrize("kind", ["rbf", "matern32", "composite"])
def test_fused_loss_vmap_rule_matches_a_loop_of_chains(cuda, f64, kind):
    """The fused losses' vmap rule on the card (K1 and K2 once per mapped
    member for rbf) against a loop over the members, values and gradients."""
    from gptorch_tpu_torch import ops
    from gptorch_tpu_torch.module import call_with_trainable

    rng = np.random.RandomState(0)
    x, y = rng.randn(512, 8), rng.randn(512, 1)
    k = {"rbf": lambda: kernels.Rbf(8, ARD=True), "matern32": lambda: kernels.Matern32(8, ARD=True),
         "composite": lambda: kernels.Rbf(8, ARD=True) + kernels.Linear(8)}[kind]()
    m = GPR(x, y, k, likelihood=likelihoods.Gaussian(0.1), fast=True, fast_block=128, device="cuda")
    start = get_trainable(m)
    raws = {key: torch.stack([v.detach(), v.detach() + 0.1, v.detach() - 0.2]).requires_grad_()
            for key, v in start.items()}
    ops.reset_launch_counts()
    got = torch.func.vmap(lambda v: call_with_trainable(m, v, "_loss"))(raws)
    grads = torch.autograd.grad(torch.sum(got), list(raws.values()))
    counts = ops.launch_counts()
    if kind == "rbf":
        assert counts["rbf_gram"] == 3 and counts["radial_contractions"] == 3
    loop = torch.stack([call_with_trainable(m, {key: v[i] for key, v in raws.items()}, "_loss") for i in range(3)])
    loop_grads = torch.autograd.grad(torch.sum(loop), list(raws.values()))
    torch.testing.assert_close(got, loop, rtol=1e-12, atol=1e-10)
    for a, b in zip(grads, loop_grads):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)
