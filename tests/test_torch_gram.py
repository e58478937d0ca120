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


# -- a batch of Grams (one launch on the card) -----------------------------------


def _batch(seed, b=3, n1=7, n2=5, d=3):
    rng = np.random.RandomState(seed)
    return (torch.as_tensor(rng.randn(b, n1, d)), torch.as_tensor(rng.randn(b, n2, d)),
            torch.as_tensor(rng.uniform(0.5, 2.0, b)), torch.as_tensor(rng.uniform(0.01, 0.3, b)))


@pytest.mark.parametrize("sym", [True, False])
def test_batched_plain_is_each_members_gram(sym):
    """The twin on (B, n, d) inputs with a var and diag per member, against
    the JAX package's Rbf of each member (float64, 1e-12) and the explicit
    differences: a twin that read member 0's scalars would fail."""
    x1, x2, var, diag = _batch(3)
    out = gram.rbf_gram(x1, None if sym else x2, var=var, diag=diag if sym else None)
    assert out.shape == (3, 7, 7 if sym else 5)
    for b in range(3):
        k = jax_kernels.Rbf(3, variance=float(var[b]))
        want = np.asarray(k.K(jnp.asarray(x1[b].numpy()), None if sym else jnp.asarray(x2[b].numpy())))
        if sym:
            want = want + float(diag[b]) * np.eye(7)
        np.testing.assert_allclose(out[b].numpy(), want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(out[b].numpy(), _direct(x1[b].numpy(), (x1 if sym else x2)[b].numpy(),
                                                           float(var[b]), float(diag[b]) if sym else None),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sym", [True, False])
def test_batched_backward_formula_matches_autograd_of_plain(sym):
    """_gram_vjp over the last two axes: each member's cotangents against
    autograd through the batched twin (float64, 1e-10)."""
    x1, x2, var, diag = _batch(5)
    leaves = [x1, None if sym else x2, var, diag if sym else None]
    leaves = [None if t is None else t.clone().requires_grad_() for t in leaves]
    out = gram.rbf_gram_plain(*leaves)
    g = torch.as_tensor(np.random.RandomState(6).randn(*out.shape))
    inputs = [t for t in leaves if t is not None]
    want = torch.autograd.grad(out, inputs, grad_outputs=g)
    got = [t for t in gram._gram_vjp(g, out.detach(), *[None if t is None else t.detach() for t in leaves])
           if t is not None]
    assert [t.shape for t in got] == [t.shape for t in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-12)


@pytest.fixture
def twin_launch(monkeypatch):
    """The kernel's launch replaced by the twin, recording each launch's
    shapes: the autograd function and its vmap rule run here as on the card."""
    launches = []

    def launch(x1, x2, var, diag):
        launches.append((tuple(x1.shape), None if x2 is None else tuple(x2.shape), tuple(var.shape),
                         None if diag is None else tuple(diag.shape)))
        return gram.rbf_gram_plain(x1, x2, var, diag)

    monkeypatch.setattr(gram, "_launch", launch)
    return launches


@pytest.mark.parametrize("sym", [True, False])
def test_vmap_rule_makes_one_batched_launch(twin_launch, sym):
    """``torch.func.vmap`` over the one-Gram function launches once for the
    mapped Grams, with each member's var and diag; the gradient through the
    map equals autograd through the batched twin (float64, 1e-10)."""
    x1, x2, var, diag = _batch(7)
    var.requires_grad_()
    diag.requires_grad_()
    x1.requires_grad_()
    if sym:
        out = torch.func.vmap(lambda a, v, s: gram._RbfGram.apply(a, None, v, s))(x1, var, diag)
        want = gram.rbf_gram_plain(x1, None, var, diag)
    else:  # x2 shared by every member, diag absent
        out = torch.func.vmap(lambda a, v: gram._RbfGram.apply(a, x2[0], v, None))(x1, var)
        want = gram.rbf_gram_plain(x1, x2[0].expand(3, 5, 3), var)
    assert twin_launch == [((3, 7, 3), None if sym else (3, 5, 3), (3,), (3,) if sym else None)]
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(), rtol=0, atol=0)
    g = torch.as_tensor(np.random.RandomState(8).randn(*out.shape))
    inputs = [x1, var, diag] if sym else [x1, var]
    for a, b in zip(torch.autograd.grad(out, inputs, g), torch.autograd.grad(want, inputs, g)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-12)


def test_nested_vmap_and_mapped_axis(twin_launch):
    """Nested maps join the mapped axes into one launch; a mapped axis other
    than the first is moved in front."""
    rng = np.random.RandomState(9)
    x = torch.as_tensor(rng.randn(2, 4, 6, 3))
    v = torch.as_tensor(rng.uniform(0.5, 2.0, (2, 4)))
    out = torch.func.vmap(torch.func.vmap(lambda a, s: gram._RbfGram.apply(a, None, s, torch.zeros(()))))(x, v)
    assert twin_launch == [((8, 6, 3), None, (8,), (8,))]
    want = gram.rbf_gram_plain(x.reshape(8, 6, 3), None, v.reshape(8)).reshape(2, 4, 6, 6)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=0)
    out = torch.func.vmap(lambda a: gram._RbfGram.apply(a, None, torch.ones(()), torch.zeros(())),
                          in_dims=1)(x[0].transpose(0, 1).contiguous())
    np.testing.assert_allclose(out.numpy(), gram.rbf_gram_plain(x[0], None, 1.0).numpy(), rtol=0, atol=0)


def test_vmap_of_rbf_K_on_the_cpu_takes_the_twin():
    """``vmap(kernel.K)`` over CPU tensors runs the twin (no launch)."""
    from gptorch_tpu_torch import kernels

    x1, _, _, _ = _batch(10)
    k = kernels.Rbf(3, variance=1.4, length_scales=0.8)
    before = gram.rbf_gram.launches
    out = torch.func.vmap(k.K)(x1)
    assert gram.rbf_gram.launches == before
    np.testing.assert_allclose(out.detach().numpy(), np.stack([k.K(x).detach().numpy() for x in x1]),
                               rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize(
    "x1, x2",
    [
        (torch.zeros(2, 4, 2), torch.zeros(3, 3, 2)),  # batch sizes differ
        (torch.zeros(2, 4, 2), torch.zeros(3, 2)),  # a batch against one Gram
        (torch.zeros(2, 2, 4, 2), None),  # two batch axes
    ],
)
def test_batched_rejects(x1, x2):
    with pytest.raises(ValueError):
        gram.rbf_gram(x1, x2, var=1.0)


# -- the launch's plan and arguments (ops/gram.py:plan, _launch) ------------------

#: Resident blocks of each mapping on an H100 (132 SMs; the occupancy API's
#: figures for float32 and float64) and a smaller card's.
H100_LIMITS = {4: (528, 528, 528, 528, 660, 1056, 1056), 8: (396, 396, 264, 264, 396, 1056, 1056)}
SMALL_LIMITS = (8, 8, 8, 8, 16, 16, 16)


def _chip_smoke_cases():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return ([(1, n1, n2, sym) for _, n1, n2, sym, _, _ in cs.GRAM_CASES]
            + [(b, n1, n2, sym) for _, b, n1, n2, sym, _, _ in cs.GRAM_BATCHED_CASES])


def _check_plan(b, n1, n2, sym, itemsize, limits):
    mapping, grid = gram.plan(b, n1, n2, sym, itemsize, limits)
    vec = n2 % (16 // itemsize) == 0
    if n2 == 1:
        assert mapping == gram.ROWS
        work = -(-b * n1 // gram.THREADS)
    elif n1 <= gram.PACKED_MAX and n2 <= gram.PACKED_MAX:
        assert mapping == gram.PACKED
        work = -(-b * -(-n1 // (32 if b >= 1024 else 8)) // 8)  # a warp a member's 32 or 8 rows
    elif n1 <= gram.COLUMNS_MAX and not sym:
        assert mapping == gram.COLUMNS
        work = -(-b * n2 // gram.THREADS)
    else:
        assert mapping == (gram.HALF if sym else gram.TILES) + vec
        rows = 64 if sym or itemsize == 8 or n1 <= 64 else 128
        rt, ct = -(-n1 // rows), -(-n2 // 64)
        work = b * (rt * (rt + 1) // 2 if sym else rt * ct)
        assert work <= gram.MAX_TILES
        if not (vec and rows == 128 and work > gram.PERSISTENT_WAVES * limits[mapping]):  # a block a tile
            assert grid == work
            return mapping
    assert 1 <= grid <= limits[mapping] and grid <= work  # a grid past the work or the resident blocks is waste
    assert grid == min(work, limits[mapping])
    return mapping


@pytest.mark.parametrize("itemsize", [4, 8])
def test_every_chip_smoke_shape_gets_a_valid_plan(itemsize):
    """Every K1 shape that chip_smoke.py holds against the twin gets a plan
    whose mapping fits the shape (16-byte stores only where every row is
    aligned, packed members only up to 32 x 32, a thread a row only for
    one column), whose grid is within the resident blocks where the walk is
    persistent and one block a tile elsewhere."""
    cases = _chip_smoke_cases()
    assert len(cases) > 50
    seen = set()
    for b, n1, n2, sym in cases:
        for limits in (H100_LIMITS[itemsize], SMALL_LIMITS):
            seen.add(gram.MAPPINGS[_check_plan(b, n1, n2, sym, itemsize, limits)])
    assert {"tiles_vec", "half_vec", "packed", "rows", "columns"} <= seen


@pytest.mark.parametrize("b, n1, n2, sym, mapping", [
    (1, 4099, 1031, False, "tiles"), (1, 1000, 4001, False, "tiles"), (3, 65, 67, False, "tiles"),
    (1, 1031, 1031, True, "half"), (4, 130, 132, False, "tiles_vec"), (70000, 2, 2, True, "packed"),
    (8192, 32, 32, True, "packed"), (8192, 32, 1, False, "rows"), (1, 1, 1, True, "rows"),
    (1, 32768, 32768, True, "half_vec"), (256, 512, 512, True, "half_vec"), (1, 4194241, 64, False, "tiles_vec"),
    (1, 4, 32768, False, "columns"), (20, 16, 257, False, "columns"), (1, 17, 32768, False, "tiles_vec"),
])
def test_plan_mapping_by_shape(b, n1, n2, sym, mapping):
    """Misaligned rows (n2 % 4 in float32) and misaligned members take scalar
    stores; small members are packed; a single column is a thread a row;
    rows past the old launch's 65535 · 64 plan."""
    assert gram.MAPPINGS[_check_plan(b, n1, n2, sym, 4, H100_LIMITS[4])] == mapping


@pytest.mark.parametrize("b, n1, n2, sym, itemsize, persistent", [
    (1, 32768, 256, False, 4, False),   # 1024 tiles, under two waves of 528
    (1, 256, 32768, False, 4, False),
    (4, 100, 10000, False, 4, False),   # 628 tiles
    (5, 4096, 1024, False, 4, True),    # 2560 tiles, past four waves
    (1, 2048, 32768, False, 4, True),
    (1, 32768, 32768, False, 4, True),
    (1, 2048, 32768, False, 8, False),  # float64's tiles: a block a tile
    (1, 4099, 1031, False, 4, False),   # scalar stores
    (1, 32768, 32768, True, 4, False),  # mirrored
])
def test_plan_grid_by_tile_waves(b, n1, n2, sym, itemsize, persistent):
    """Float32's 16-byte 128-row tiles walk a persistent grid (the resident
    blocks) only past four waves of them; fewer tiles, and every other
    tile, take a block a tile."""
    limits = H100_LIMITS[itemsize]
    mapping, grid = gram.plan(b, n1, n2, sym, itemsize, limits)
    assert _check_plan(b, n1, n2, sym, itemsize, limits) in (gram.TILES, gram.TILES_VEC, gram.HALF, gram.HALF_VEC)
    assert (grid == limits[mapping]) == persistent


def test_plan_rejects_past_one_launch():
    with pytest.raises(ValueError, match="rows exceed"):
        gram.plan(1, gram.MAX_ROWS + 1, 64, False, 4, H100_LIMITS[4])
    with pytest.raises(ValueError, match="rows exceed"):
        gram.plan(1, 64, gram.MAX_ROWS + 1, False, 4, H100_LIMITS[4])
    with pytest.raises(ValueError, match="tiles"):
        gram.plan(1, 2**22, 2**22, False, 4, H100_LIMITS[4])


@pytest.fixture
def recorded_launch(monkeypatch):
    """``_launch`` run on CPU tensors against a recorder in place of the
    library: the ctypes call's arguments; torch.stack, cat, full and
    zeros_like made to fail, so a side tensor built per call would raise."""
    from types import SimpleNamespace

    calls = []

    def record(*args):
        calls.append(args)
        return 0

    lib = SimpleNamespace(rbf_gram_f32=record, rbf_gram_f64=record)
    monkeypatch.setattr(gram, "_kernel_library", lambda: lib)
    monkeypatch.setattr(gram, "_grid_limits", lambda f64, device: H100_LIMITS[8 if f64 else 4])
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: SimpleNamespace(cuda_stream=7))

    def forbidden(*args, **kwargs):
        raise AssertionError("a side tensor built for the launch")

    for name in ("stack", "cat", "full", "zeros_like"):
        monkeypatch.setattr(torch, name, forbidden)
    return calls


@pytest.mark.parametrize("sym", [True, False])
def test_launch_passes_var_and_diag_as_pointers(recorded_launch, sym):
    """The launch hands the kernel var's and diag's own storage with their
    strides (0 for one value shared by a batch, None for no diagonal): no
    (B, 2) array or other tensor besides the output is made per call."""
    rng = np.random.RandomState(11)
    x1 = torch.as_tensor(rng.randn(3, 40, 2))
    x2 = None if sym else torch.as_tensor(rng.randn(3, 36, 2))
    var = torch.as_tensor(rng.uniform(0.5, 2.0, 3))
    shared = torch.tensor(0.1, dtype=torch.float64).expand(3)
    out = gram._launch(x1, x2, var, shared if sym else None)
    assert out.shape == (3, 40, 40 if sym else 36)
    (args,) = recorded_launch
    assert args[0] == x1.data_ptr() and args[1] == (x1 if sym else x2).data_ptr()
    assert args[2:4] == (var.data_ptr(), 1)
    assert args[4:6] == ((shared.data_ptr(), 0) if sym else (None, 0))
    assert args[6] == out.data_ptr() and args[7:12] == (3, 40, 40 if sym else 36, 2, int(sym))
    assert args[12:14] == gram.plan(3, 40, 40 if sym else 36, sym, 8, H100_LIMITS[8])
    assert args[14] == 7  # the current stream
    gram._launch(x1[0], None, torch.tensor(1.3, dtype=torch.float64), None)  # one Gram: 0-d var, stride 0
    assert recorded_launch[1][2:6] == (recorded_launch[1][2], 0, None, 0)
    gram._launch(x1, x2, var, shared if sym else None, grid=5)  # a grid in place of the plan's
    assert recorded_launch[2][12:14] == (args[12], 5)


@pytest.mark.parametrize("sym", [True, False])
def test_eager_function_matches_setup_context_form(twin_launch, sym):
    """The ctx-form function (calls outside torch.func) and the
    setup_context form (its vmap rule) give the same output and gradients,
    with or without a diagonal (float64, on the twin)."""
    x1, x2, var, diag = _batch(12)
    for d in ((diag, None) if sym else (None,)):
        grads = []
        for fn in (gram._RbfGramEager, gram._RbfGram):
            leaves = [t.clone().requires_grad_() for t in (x1, var)] + ([] if d is None else [d.clone().requires_grad_()])
            out = fn.apply(leaves[0], None if sym else x2, leaves[1], leaves[2] if len(leaves) > 2 else None)
            g = torch.as_tensor(np.random.RandomState(13).randn(*out.shape))
            grads.append([out.detach()] + list(torch.autograd.grad(out, leaves, g)))
        for a, b in zip(*grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-14)
