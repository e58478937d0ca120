"""Three repairs of the port, each held against the JAX package on the CPU
in float64 (tolerance rel 1e-9 unless a test says otherwise).

1. A posterior is frozen: training the model in place after ``posterior()``
   or ``for_serving()`` leaves the posterior's predictions as they were,
   as in the JAX package, where training replaces the model's modules.
2. A training loop that raises ``FloatingPointError`` on a non-finite loss
   leaves the model with the values it had on entry, as the JAX loops do.
3. Off the CPU, inputs wider than the contraction kernel takes (d > 32 or
   dy > 32) route to the kernel-general path; the CPU route is unchanged.

And two gaps of the port's surface against the JAX package:

4. ``kernels.SquaredExponential`` is the alias of ``kernels.Rbf``.
5. ``Param`` has ``transform()`` (the reference-API alias of ``value``),
   ``dtype`` and ``numel()``, and the functional updates ``with_raw`` and
   ``with_value``, which return a new Param and leave the old one as it
   was (in the port a new module, whose raw is a detached copy).

And two repairs that the fleet of GPs needs (the JAX package ``vmap``s
both):

6. The adaptive jitter runs batched: one batched ``cholesky_ex`` per level
   tried over the matrices still failing, one host read per level, and
   each matrix gets the level the JAX package's probe picks for it (also
   under ``torch.func.vmap``); a matrix's factor is differentiated only
   through the branch it took.
7. K1's autograd function has the ``setup_context`` form and a ``vmap``
   rule (tests/test_torch_gram.py holds the rule; here ``torch.func.grad``
   runs through it).

And one gap of the prediction decorator:

8. ``_coerce_io`` casts a numpy input to the dtype and device of
   ``_input_reference()``; StreamingVFE (which has no X) and OnlineSGPR
   (whose X is empty between steps) take Z's (Z_old's once OnlineSGPR has
   absorbed a batch), as the JAX package's decorator falls back to
   ``Z.raw``: a numpy ``predict_f`` returns numpy of Z's dtype, before and
   after a batch.

And one repair that the MCMC chains need (the JAX package ``vmap``s a
``custom_vjp`` loss):

9. The fused exact-GP losses (``radial_nlml`` of each kind, and
   ``general_nlml``) run under ``torch.func.vmap``: their autograd
   functions have the ``setup_context`` form and a ``vmap`` rule that runs
   the mapped members one after the other; ``vmap`` over a ``fast=True``
   GPR's ``_loss`` and its gradient equal the JAX package's ``jax.vmap``
   (1e-9).

And one repair that the serving example needs (the JAX package saves
every leaf of a posterior's pytree):

10. ``checkpoint.save`` stores the tensors a module holds as plain
    attributes -- a posterior's factors (X, L⁻¹ and α of a serving
    posterior) -- and ``checkpoint.load`` restores them: a posterior loaded
    into one of another model predicts as the saved one, as in the JAX
    package (1e-12).

And one repair that the Laplace classification example needs (the JAX
package's ``fit_scan`` compiles the Laplace evidence):

11. ``LaplaceGP``'s loss builds no tensor from host data and reads none
    back (its Newton step grid was a ``torch.tensor`` of a Python list, a
    copy from the host, and the step was picked by indexing with a 0-d
    tensor, a read to the host: a captured training step holds neither,
    so ``fit_scan`` raised on the card);
    the grid is exact, so the evidence equals the JAX package's as before
    (tests/test_torch_exact_variants.py), and the card test
    ``test_laplace_fit_scan_captures_as_eager`` replays a captured step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu import param as jax_param
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.models import SVGP as JaxSVGP
from gptorch_tpu.module import get_trainable as jax_get_trainable
from gptorch_tpu.module import with_trainable as jax_with_trainable
from gptorch_tpu_torch import bijectors, convert, kernels, likelihoods, module, param, settings
from gptorch_tpu_torch.models import GPR, SVGP
from gptorch_tpu_torch.module import get_trainable
from gptorch_tpu_torch.ops import contract
from gptorch_tpu_torch.training import fit, natgrad

RTOL = 1e-9
N, D = 50, 2
XS = np.random.RandomState(4).randn(7, D)


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data(n=N, d=D, dy=1, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    return x, np.sin(x[:, :1] * np.arange(1, dy + 1)) + 0.1 * rng.randn(n, dy)


def _pair(kind):
    """The same model in both packages: an Rbf-ARD GPR with the default
    noise heuristic (ROADMAP's reproduction of faults 1 and 2), or a
    whitened SVGP on full batches."""
    x, y = _data()
    if kind == "gpr":
        return (JaxGPR(x, y, jax_kernels.Rbf(D, ARD=True)),
                GPR(x, y, kernels.Rbf(D, ARD=True), device="cpu"))
    z = x[::5] + 0.05
    jm = JaxSVGP(x, y, jax_kernels.Rbf(D, ARD=True), inducing_points=z, whiten=True,
                 likelihood=jax_likelihoods.Gaussian(0.1))
    tm = SVGP(x, y, kernels.Rbf(D, ARD=True), inducing_points=z, whiten=True,
              likelihood=likelihoods.Gaussian(0.1), device="cpu")
    convert.load_trainable(tm, {k: np.asarray(v) for k, v in jax_get_trainable(jm).items()})
    return jm, tm


def _raws(values):
    return {k: np.array(v.detach() if isinstance(v, torch.Tensor) else v) for k, v in values.items()}


@pytest.mark.parametrize("kind", ["gpr", "svgp_white"])
def test_posterior_is_frozen_against_training(kind):
    """posterior() and its for_serving() twin, then optimize("Adam", 50
    steps, lr 0.05) on both models: the old posteriors still agree with
    JAX's, while the trained models' own predictions have moved."""
    jm, tm = _pair(kind)
    jpost, tpost = jm.posterior(), tm.posterior()
    pairs = [(jpost, tpost), (jpost.for_serving(), tpost.for_serving())]
    before = tm.predict_f(XS)
    jm.optimize("Adam", max_iter=50, learning_rate=0.05, verbose=False)
    tm.optimize("Adam", max_iter=50, learning_rate=0.05, verbose=False)
    for jp, tp in pairs:
        for got, want, was in zip(tp.predict_f(XS), jp.predict_f(XS), before):
            np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=1e-12)
            np.testing.assert_allclose(got, was, rtol=RTOL, atol=1e-12)
        assert all(not p.requires_grad for p in tp.parameters())
    assert np.abs(tm.predict_f(XS)[0] - before[0]).max() > 1e-3


@pytest.mark.parametrize("loop", ["fit_scan", "optimize"])
def test_nonfinite_loss_leaves_starting_values(loop):
    """SGD at lr 1e4 for 30 steps diverges in both packages; after the
    FloatingPointError each model holds its starting raw values."""
    jm, tm = _pair("gpr")
    start = _raws(jax_get_trainable(jm))
    for model in (jm, tm):
        with pytest.raises(FloatingPointError):
            if loop == "fit_scan":
                model.fit_scan("SGD", max_iter=30, learning_rate=1e4)
            else:
                model.optimize("SGD", max_iter=30, learning_rate=1e4, verbose=False)
    want = _raws(jax_get_trainable(jm))
    got = _raws(get_trainable(tm))
    assert set(got) == set(start)
    for path in start:
        np.testing.assert_array_equal(want[path], start[path])
        np.testing.assert_allclose(got[path], start[path], rtol=RTOL, atol=0)


def test_fit_torch_restores_on_entry_values_not_last_step():
    """The values put back are those on entry, also after finite steps."""
    _, tm = _pair("gpr")
    start = _raws(get_trainable(tm))
    seen = []
    with pytest.raises(FloatingPointError):
        fit.fit_torch(tm, "SGD", max_iter=30, learning_rate=1e4, verbose=False,
                      callback=lambda i, v: seen.append(v))
    assert seen, "the first steps were finite"
    for path, raw in _raws(get_trainable(tm)).items():
        np.testing.assert_array_equal(raw, start[path])


def test_natgrad_collapse_leaves_starting_values():
    """A loss that is never finite (a NaN target) drives the natural step's
    γ below 1e-5; the model then holds its starting values, the JAX
    model's (carried across by load_trainable)."""
    jm, tm = _pair("svgp_white")
    tm.Y[3, 0] = float("nan")
    start = _raws(jax_get_trainable(jm))
    with pytest.raises(FloatingPointError, match="collapsed"):
        natgrad.fit_svgp_natgrad(tm, n_steps=5, nat_lr=0.1)
    for path, raw in _raws(get_trainable(tm)).items():
        np.testing.assert_allclose(raw, start[path], rtol=RTOL, atol=0)


WIDE = [(33, 1), (2, 33)]


@pytest.mark.parametrize("d, dy", WIDE, ids=["d=33", "dy=33"])
def test_wide_inputs_keep_the_fused_route_on_the_cpu(d, dy):
    """On the CPU the fused path's backward is the plain contraction, which
    takes any width: the route and the numbers are the JAX package's."""
    x, y = _data(n=40, d=d, dy=dy, seed=1)
    common = dict(fast=True, fast_block=16)
    jm = JaxGPR(x, y, jax_kernels.Rbf(d, ARD=True), likelihood=jax_likelihoods.Gaussian(0.1), **common)
    tm = GPR(x, y, kernels.Rbf(d, ARD=True), likelihood=likelihoods.Gaussian(0.1), device="cpu", **common)
    rng = np.random.RandomState(2)
    values = {k: np.asarray(v) + 0.1 * rng.randn(*np.shape(v)) for k, v in jax_get_trainable(jm).items()}
    convert.load_trainable(tm, values)
    big = torch.zeros(4096, d), torch.zeros(4096, dy)
    assert tm._fast_eligible(tm.X, tm.Y) and tm._fast_eligible(*big)
    want, want_grads = jax.jit(jax.value_and_grad(lambda v: jax_with_trainable(jm, v)._loss()))(
        {k: jnp.asarray(v) for k, v in values.items()})
    got = tm.loss()
    got.backward()
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-10)
    # gradients within 1e-8 of the largest entry: the two packages'
    # factorizations round differently, and the length scales' gradients
    # at d = 33 are five orders below the largest
    scale = max(np.abs(np.asarray(g)).max() for g in want_grads.values())
    for path, raw in get_trainable(tm).items():
        np.testing.assert_allclose(raw.grad.numpy(), np.asarray(want_grads[path]), rtol=0, atol=1e-8 * scale)


@pytest.mark.parametrize("d, dy, fused", [(33, 1, False), (2, 33, False), (32, 32, True), (8, 1, True)])
def test_off_cpu_routing_follows_the_contraction_kernel(d, dy, fused):
    """Off the CPU (meta tensors stand in for the card's: the routing reads
    only device and shapes) the fused path needs d <= 32 and dy <= 32;
    wider shapes take the kernel-general path, which computes the same NLML
    and gradient (held on the card in tests/test_torch_cuda.py)."""
    x, y = _data(n=8, d=d, dy=dy)
    tm = GPR(x, y, kernels.Rbf(d, ARD=True), likelihood=likelihoods.Gaussian(0.1), device="cpu")
    xm, ym = torch.empty(4096, d, device="meta"), torch.empty(4096, dy, device="meta")
    assert contract.kernel_takes(d, dy) == fused
    assert tm._fast_eligible(xm, ym) == fused
    assert tm._general_eligible(xm)


def test_squared_exponential_is_the_rbf_alias():
    x = np.random.RandomState(3).randn(6, D)
    assert kernels.SquaredExponential is kernels.Rbf
    want = np.asarray(jax_kernels.SquaredExponential(D, ARD=True, length_scales=np.array([0.6, 1.4])).K(x))
    got = kernels.SquaredExponential(D, ARD=True, length_scales=np.array([0.6, 1.4])).K(torch.as_tensor(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12, atol=0)


PARAM_CASES = {
    "vector": (lambda p: p.positive_param, np.array([0.3, 1.7, 2.5])),
    "scalar": (lambda p: p.positive_param, 0.4),
    "matrix": (lambda p: p.Param, np.arange(6.0).reshape(2, 3) - 2.0),
}


@pytest.mark.parametrize("case", sorted(PARAM_CASES))
def test_param_transform_dtype_numel_match_jax(case):
    make, value = PARAM_CASES[case]
    jp, tp = make(jax_param)(value), make(param)(value)
    np.testing.assert_allclose(tp.transform().detach().numpy(), np.asarray(jp.transform()), rtol=1e-15)
    assert torch.equal(tp.transform(), tp.value)
    assert tp.numel() == jp.numel() and isinstance(tp.numel(), int)
    assert tp.dtype == torch.float64 and str(jp.dtype) == "float64"


@pytest.mark.parametrize("case", sorted(PARAM_CASES))
def test_param_functional_updates_match_jax(case):
    make, value = PARAM_CASES[case]
    jp, tp = make(jax_param)(value), make(param)(value)
    new_value = 1.5 * np.abs(np.asarray(value, dtype=float)) + 0.2
    jv, tv = jp.with_value(new_value), tp.with_value(new_value)
    np.testing.assert_allclose(tv.value.detach().numpy(), np.asarray(jv.value), rtol=1e-14)
    np.testing.assert_allclose(tv.raw.detach().numpy(), np.asarray(jv.raw), rtol=1e-14)
    # the raw is taken as given, and the old Param is unchanged
    raw = np.asarray(jv.raw) - 0.3
    np.testing.assert_array_equal(tp.with_raw(raw).raw.detach().numpy(), np.asarray(jp.with_raw(raw).raw))
    np.testing.assert_allclose(tp.value.detach().numpy(), np.asarray(jp.value), rtol=1e-15)
    assert tv is not tp and tv.raw is not tp.raw
    assert tv.bijector == tp.bijector and tv.trainable == tp.trainable and tv.raw.is_leaf


def test_with_value_replaces_a_models_param():
    """A model's Param is replaced by assignment, as in the JAX tests
    (``model.Xmean = model.Xmean.with_value(x)``); the trainability and the
    bijector carry over, and the model's trainables follow."""
    tm = SVGP(*_data(), kernels.Rbf(D), inducing_points=np.zeros((3, D)), device="cpu")
    tm.kernel.variance.trainable = False
    old = tm.kernel.variance
    tm.kernel.variance = tm.kernel.variance.with_value(np.array([2.5]))
    assert float(tm.kernel.variance.value) == pytest.approx(2.5, rel=1e-15)
    assert float(old.value) == pytest.approx(1.0, rel=1e-15)
    assert not tm.kernel.variance.trainable and "kernel.variance" not in get_trainable(tm)
    assert isinstance(tm.kernel.variance.bijector, bijectors.Exp)
    z = tm.Z.with_raw(np.ones((3, D)))
    tm.Z = z
    assert get_trainable(tm)["Z"] is z.raw


# -- 6. the batched adaptive jitter ------------------------------------------------


def _fleet_matrices():
    """Four symmetric 12² matrices: three SPD, the third with one eigenvalue
    at −5e-4, so the adaptive policy must jitter it alone (the bare factor
    and the levels up to 1e-4 fail; 1e-3 leaves it SPD, conditioned ~4e3)."""
    rng = np.random.RandomState(11)
    out = []
    for b in range(4):
        q, _ = np.linalg.qr(rng.randn(12, 12))
        lam = np.linspace(0.5, 2.0, 12)
        if b == 2:
            lam[0] = -5e-4
        out.append((q * lam) @ q.T)
    return np.stack(out)


@pytest.fixture
def cholesky_ex_calls(monkeypatch):
    calls = []
    real = torch.linalg.cholesky_ex

    def counted(a, *args, **kwargs):
        calls.append(tuple(a.shape))
        return real(a, *args, **kwargs)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", counted)
    return calls


@pytest.mark.parametrize("mapped", [False, True])
def test_fleet_adaptive_jitter_is_each_members_level(cholesky_ex_calls, mapped):
    """Only the singular member is jittered, at the level the JAX package's
    vmapped probe picks; the factors equal the JAX ones (1e-10).
    The probe factors the whole batch once, then the failing member once
    per level tried: cholesky_ex runs levels tried + 1 times (the last the
    factor itself), not once per member."""
    from gptorch_tpu import functions as jax_functions
    from gptorch_tpu_torch import functions

    a = _fleet_matrices()
    want_levels = [float(jax_functions._select_jitter(jnp.asarray(m))) for m in a]
    assert want_levels[2] > 0 and want_levels[0] == want_levels[1] == want_levels[3] == 0.0
    t = torch.as_tensor(a)
    if mapped:
        L = torch.func.vmap(lambda m: functions.cholesky(m, policy="adaptive"))(t)
    else:
        L = functions.cholesky(t, policy="adaptive")
    tried = 2 + int(round(np.log10(want_levels[2]))) + settings.config.max_jitter_tries  # bare, then levels
    assert want_levels[2] == pytest.approx(1e-3) and tried == 9
    assert len(cholesky_ex_calls) == tried + 1
    assert cholesky_ex_calls[0] == (4, 12, 12) and all(c == (1, 12, 12) for c in cholesky_ex_calls[1:-1])
    assert cholesky_ex_calls[-1] == ((12, 12) if mapped else (4, 12, 12))  # the factor (mapped: its logical shape)
    np.testing.assert_array_equal(functions._select_jitter(t).numpy(), want_levels)
    want = np.asarray(jax_functions.cholesky(jnp.asarray(a), policy="adaptive"))
    got = L.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got[2] @ got[2].T, a[2] + want_levels[2] * np.eye(12), rtol=0, atol=1e-13)


def test_fleet_adaptive_jitter_gradient_follows_each_branch():
    """d/ds Σ log diag chol(s·A_b) through the adaptive policy, per member,
    against the JAX package's (the jittered member differentiates the
    jittered factor, the others the bare one), 1e-9 relative; the same
    under ``torch.func.vmap``."""
    from gptorch_tpu import functions as jax_functions
    from gptorch_tpu_torch import functions

    a = _fleet_matrices()

    def jax_f(s):
        L = jax_functions.cholesky(s[:, None, None] * jnp.asarray(a), policy="adaptive")
        return jnp.sum(jnp.log(jnp.diagonal(L, axis1=-2, axis2=-1)))

    want = np.asarray(jax.grad(jax_f)(jnp.ones(4)))
    for mapped in (False, True):
        s = torch.ones(4, dtype=torch.float64, requires_grad=True)
        m = s[:, None, None] * torch.as_tensor(a)
        if mapped:
            L = torch.func.vmap(lambda x: functions.cholesky(x, policy="adaptive"))(m)
        else:
            L = functions.cholesky(m, policy="adaptive")
        torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1))).backward()
        assert np.isfinite(s.grad.numpy()).all()
        np.testing.assert_allclose(s.grad.numpy(), want, rtol=1e-9)


def test_fixed_and_none_policies_read_no_host_under_vmap():
    """The fixed and none policies map with no host read (so a captured
    fleet step holds them): vmap of a probe-free cholesky equals the
    batched call."""
    from gptorch_tpu_torch import functions

    t = torch.as_tensor(_fleet_matrices()[[0, 1, 3]])
    for policy in ("fixed", "none"):
        got = torch.func.vmap(lambda m: functions.cholesky(m, policy=policy))(t)
        np.testing.assert_allclose(got.numpy(), functions.cholesky(t, policy=policy).numpy(), rtol=0, atol=1e-15)


# -- 7. K1 under torch.func.grad ----------------------------------------------------


def test_rbf_gram_function_runs_under_func_grad(monkeypatch):
    """``torch.func.grad`` through K1's autograd function (its launch
    replaced by the twin, as on the card) equals the twin's gradient."""
    from gptorch_tpu_torch.ops import gram

    monkeypatch.setattr(gram, "_launch", lambda x1, x2, v, d: gram.rbf_gram_plain(x1, x2, v, d))
    x = torch.as_tensor(np.random.RandomState(12).randn(6, 2))

    def via_function(v):
        return torch.sum(gram._RbfGram.apply(x, None, v, torch.zeros((), dtype=torch.float64)) ** 2)

    def via_twin(v):
        return torch.sum(gram.rbf_gram_plain(x, None, v) ** 2)

    v = torch.tensor(1.3, dtype=torch.float64)
    assert float(torch.func.grad(via_function)(v)) == pytest.approx(float(torch.func.grad(via_twin)(v)), rel=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_streaming_models_cast_numpy_inputs_like_z(dtype):
    from gptorch_tpu_torch.models import OnlineSGPR, StreamingVFE

    rng = np.random.RandomState(5)
    x, z, xq = rng.randn(30, D), rng.randn(6, D), rng.randn(4, D)
    y = np.sin(x[:, :1])
    torch.set_default_dtype(dtype)
    stream = StreamingVFE(kernels.Rbf(D), z, likelihood=likelihoods.Gaussian(0.1), device="cpu")
    online = OnlineSGPR(kernels.Rbf(D), z, likelihood=likelihoods.Gaussian(0.1), device="cpu")
    assert stream.Z.dtype == dtype
    want_dtype = np.float32 if dtype == torch.float32 else np.float64
    for model, absorb in ((stream, lambda: stream.observe(x, y)), (online, lambda: online.step(x, y, fit_iters=2))):
        if model is stream:  # before a batch: the prior
            mean, var = model.predict_f(xq)
            assert mean.dtype == var.dtype == want_dtype and np.allclose(var, 1.0, atol=1e-6)
        absorb()
        mean, var = model.predict_f(xq)
        assert isinstance(mean, np.ndarray) and mean.dtype == var.dtype == want_dtype
        tmean, tvar = model.predict_f(torch.as_tensor(xq, dtype=dtype))
        np.testing.assert_array_equal(mean, tmean.detach().numpy())
    assert online._input_reference() is online.Z_old and stream._input_reference() is stream.Z.raw


def test_array_like_queries_match_jax():
    """ROADMAP 3.1: a Python list as the query of a cached posterior (its
    predict_f, predict_y, predict_f_batched, predict_log_density), of its
    for_serving() twin (mean_only too), and of StreamingVFE's and
    OnlineSGPR's predictions, in both packages (float64, n = 40, d = 2, Rbf):
    the JAX package answers with arrays, the port with tensors, equal to
    1e-9.  GPR.predict_f still refuses a list in both."""
    from gptorch_tpu.models import OnlineSGPR as JaxOnline
    from gptorch_tpu.models import StreamingVFE as JaxStreaming
    from gptorch_tpu_torch.models import OnlineSGPR, StreamingVFE

    x, y = _data(n=40)
    z = x[::5] + 0.05
    xs = XS[:3].tolist()
    ys = [[0.1], [-0.2], [0.3]]
    jm, tm = JaxGPR(x, y, jax_kernels.Rbf(D)), GPR(x, y, kernels.Rbf(D), device="cpu")
    jp, tp = jm.posterior(), tm.posterior()
    pairs = [(jp, tp), (jp.for_serving(), tp.for_serving())]
    js = JaxStreaming(jax_kernels.Rbf(D), z, likelihood=jax_likelihoods.Gaussian(0.1)).update(x, y)
    ts = StreamingVFE(kernels.Rbf(D), z, likelihood=likelihoods.Gaussian(0.1), device="cpu").update(x, y)
    jo = JaxOnline(jax_kernels.Rbf(D), z, likelihood=jax_likelihoods.Gaussian(0.1)).step(x, y, fit_iters=0)
    to = OnlineSGPR(kernels.Rbf(D), z, likelihood=likelihoods.Gaussian(0.1), device="cpu").step(x, y, fit_iters=0)
    calls = {
        "predict_f": lambda m: m.predict_f(xs),
        "predict_f full": lambda m: m.predict_f(xs, diag=False),
        "predict_y": lambda m: m.predict_y(xs),
        "predict_f_batched": lambda m: m.predict_f_batched(xs, batch_size=2),
        "predict_log_density": lambda m: m.predict_log_density(xs, ys),
    }
    cases = [(j, t, calls) for j, t in pairs]
    cases.append((pairs[1][0], pairs[1][1], {"mean_only": lambda m: m.mean_only(xs)}))
    cases += [(j, t, {k: calls[k] for k in ("predict_f", "predict_f full", "predict_y")}) for j, t in
              ((js, ts), (jo, to))]
    for j, t, fns in cases:
        for name, fn in fns.items():
            want, got = fn(j), fn(t)
            want, got = (want, got) if isinstance(got, tuple) else ((want,), (got,))
            assert all(isinstance(g, torch.Tensor) for g in got), (type(t).__name__, name)
            for g, w in zip(got, want):
                assert isinstance(w, jax.Array)
                np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-9, atol=1e-12,
                                           err_msg=f"{type(t).__name__}.{name}")
    for model in (jm, tm):
        with pytest.raises((TypeError, AttributeError)):
            model.predict_f(xs)


# -- 9. the fused losses under torch.func.vmap -------------------------------------------


def _fused_pair(kind):
    """A fast=True GPR of each package (n = 64, d = 2, ARD), and three
    stacked raw values around its start."""
    x, y = _data(n=64)
    if kind == "composite":
        jk = jax_kernels.Rbf(D, ARD=True) + jax_kernels.Linear(D)
        k = kernels.Rbf(D, ARD=True) + kernels.Linear(D)
    else:
        name = {"rbf": "Rbf", "matern12": "Matern12", "matern32": "Matern32", "matern52": "Matern52",
                "rq": "RationalQuadratic"}[kind]
        jk, k = getattr(jax_kernels, name)(D, ARD=True), getattr(kernels, name)(D, ARD=True)
    jm = JaxGPR(x, y, jk, likelihood=jax_likelihoods.Gaussian(0.1), fast=True, fast_block=32)
    m = GPR(x, y, k, likelihood=likelihoods.Gaussian(0.1), fast=True, fast_block=32, device="cpu")
    start = {key: np.asarray(v) for key, v in jax_get_trainable(jm).items()}
    rng = np.random.RandomState(9)
    stacked = {key: np.stack([v, v + 0.1 * rng.randn(*v.shape), v - 0.2 * rng.rand(*v.shape)])
               for key, v in start.items()}
    return jm, m, stacked


@pytest.mark.parametrize("kind", ["rbf", "matern12", "matern32", "matern52", "rq", "composite"])
def test_fused_losses_map_under_vmap_as_jax(kind):
    jm, m, stacked = _fused_pair(kind)
    assert m._fast_eligible(m.X) == (kind != "composite") and m._general_eligible(m.X)
    want, want_grads = jax.jit(jax.vmap(jax.value_and_grad(lambda v: jax_with_trainable(jm, v)._loss())))(
        {key: jnp.asarray(v) for key, v in stacked.items()})
    raws = {key: torch.tensor(v, requires_grad=True) for key, v in stacked.items()}
    got = torch.func.vmap(lambda v: module.call_with_trainable(m, v, "_loss"))(raws)
    grads = torch.autograd.grad(torch.sum(got), list(raws.values()))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL)
    for key, g in zip(raws, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_grads[key]), rtol=RTOL, atol=RTOL)
    # a second backward refactors (the first dropped each member's L)
    got = torch.func.vmap(lambda v: module.call_with_trainable(m, v, "_loss"))(raws)
    twice = [torch.autograd.grad(torch.sum(got), list(raws.values()), retain_graph=True) for _ in range(2)]
    for a, b in zip(*twice):
        assert torch.equal(a, b)


# -- 10. checkpoints of posteriors ------------------------------------------------------


def _posterior_pair(kind, seed):
    """A posterior of each package (``kind``: "gpr" or "gpr serving", or
    "vfe serving" / "svgp serving") on data from ``seed``, n = 30, d = 2."""
    from gptorch_tpu.models import VFE as JaxVFE
    from gptorch_tpu_torch.models import VFE

    x, y = _data(n=30, seed=seed)
    z = x[::3] + 0.05
    if kind.startswith("gpr"):
        jm, tm = JaxGPR(x, y, jax_kernels.Rbf(D)), GPR(x, y, kernels.Rbf(D), device="cpu")
    elif kind.startswith("vfe"):
        jm = JaxVFE(x, y, jax_kernels.Rbf(D), inducing_points=z, likelihood=jax_likelihoods.Gaussian(0.1))
        tm = VFE(x, y, kernels.Rbf(D), inducing_points=z, likelihood=likelihoods.Gaussian(0.1), device="cpu")
    else:
        jm = JaxSVGP(x, y, jax_kernels.Rbf(D), inducing_points=z, likelihood=jax_likelihoods.Gaussian(0.1))
        tm = SVGP(x, y, kernels.Rbf(D), inducing_points=z, likelihood=likelihoods.Gaussian(0.1), device="cpu")
        convert.load_trainable(tm, {k: np.asarray(v) for k, v in jax_get_trainable(jm).items()})
    jp, tp = jm.posterior(), tm.posterior()
    if kind.endswith("serving"):
        jp, tp = jp.for_serving(), tp.for_serving()
    return jp, tp


@pytest.mark.parametrize("kind", ["gpr", "gpr serving", "vfe serving", "svgp serving"])
def test_checkpoint_restores_posterior_factors_as_jax(tmp_path, kind):
    """A posterior saved and loaded into the same kind of posterior of other
    data predicts as the saved one in both packages (float64, 1e-12), and
    the port's file holds its factors (the parent saved only the kernel's
    and likelihood's parameters)."""
    from gptorch_tpu.training import checkpoint as jax_checkpoint
    from gptorch_tpu_torch.training import checkpoint

    jp, tp = _posterior_pair(kind, seed=0)
    jother, tother = _posterior_pair(kind, seed=1)
    jax_checkpoint.save(str(tmp_path / "jax.npz"), jp)
    checkpoint.save(str(tmp_path / "port.npz"), tp)
    factors = {k for k, v in vars(tp).items() if isinstance(v, torch.Tensor)}
    assert factors and factors <= set(np.load(tmp_path / "port.npz").files)
    jloaded = jax_checkpoint.load(str(tmp_path / "jax.npz"), jother)
    tloaded = checkpoint.load(str(tmp_path / "port.npz"), tother)
    for j, t in ((jp, tp), (jloaded, tloaded)):
        want, got = j.predict_f(XS), t.predict_f(XS)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-9, atol=1e-12)
    for w, g in zip(tp.predict_f(XS), tloaded.predict_f(XS)):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


# -- 11. the Laplace GP's loss reads no host data ----------------------------------------


def test_laplace_loss_builds_no_tensor_from_host_data(monkeypatch):
    """The Laplace evidence and its gradient run with torch.tensor and
    torch.as_tensor made to raise on host data (a Python or numpy value),
    and give the values they give without that guard (float64, bit for
    bit); tests/test_torch_exact_variants.py holds them to the JAX
    package's."""
    from gptorch_tpu_torch.models import LaplaceGP

    x, y = _data(n=30)
    tm = LaplaceGP(x, (y > 0).astype(float), kernels.Rbf(D), likelihood=likelihoods.Bernoulli(), device="cpu")

    def value_and_grad():
        loss = tm.loss()
        grads = torch.autograd.grad(loss, list(get_trainable(tm).values()))
        return float(loss.detach()), [g.numpy() for g in grads]

    want = value_and_grad()

    def refusing(build):
        def built(data, *args, **kwargs):
            if not isinstance(data, torch.Tensor):
                raise AssertionError(f"a tensor built from host data inside the loss: {data!r}")
            return build(data, *args, **kwargs)

        return built

    monkeypatch.setattr(torch, "tensor", refusing(torch.tensor))
    monkeypatch.setattr(torch, "as_tensor", refusing(torch.as_tensor))
    got = value_and_grad()
    monkeypatch.undo()
    assert got[0] == want[0] and np.isfinite(got[0])
    for g, w in zip(got[1], want[1]):
        np.testing.assert_array_equal(g, w)
