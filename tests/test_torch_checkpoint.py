"""The port's checkpoints (gptorch_tpu_torch.training.checkpoint) and
profiling hooks (gptorch_tpu_torch.profiling), float64 on the CPU, data
from numpy seeds.

Checkpoints (mirrors the JAX package's tests/test_training.py
TestCheckpoint and test_checkpoint_roundtrip_new_model_families,
tests/test_streaming.py and tests/test_online.py's round trips):

* save / load restores every parameter and buffer in place (an exact GPR
  loss after a perturbation; X), save_trainable / load_trainable restores
  the trainables, and a resumed fit starts from the saved values;
* LMC, HeteroscedasticSVGP, StreamingVFE and OnlineSGPR built afresh and
  loaded give the saved model's loss and predictions to 1e-12 relative
  (OnlineSGPR's predict_f to 1e-10, as its JAX test);
* a file written by the JAX package's save_trainable loads into the port's
  twin, whose loss then equals the JAX model's (1e-12);
* a buffer of another shape takes the file's; a missing leaf raises
  KeyError; a load writes in place, so the tensors keep their storage.

Profiling (mirrors tests/test_aux.py TestProfiling): annotate and trace
run and trace writes a file naming the annotated range;
device_memory_stats is {} without a card; StepMetrics sums up a fit.
"""

import json
import os

import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu.training import checkpoint as jax_checkpoint
from gptorch_tpu_torch import ekernels, kernels, likelihoods, profiling
from gptorch_tpu_torch.models import GPR, LMC, HeteroscedasticSVGP, OnlineSGPR, StreamingVFE
from gptorch_tpu_torch.training import checkpoint
from gptorch_tpu_torch.training.fit import fit_scan

REL = 1e-12


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data(n=20, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 2)
    return x, np.sin(x[:, :1]) + 0.1 * rng.randn(n, 1)


def _model(seed=0):
    x, y = _data(seed=seed)
    return GPR(x, y, kernels.Rbf(2), likelihood=likelihoods.Gaussian(0.05), device="cpu")


def _loss(model):
    with torch.no_grad():
        return float(model.loss())


def test_full_roundtrip(tmp_path):
    model = _model()
    path = os.path.join(tmp_path, "ckpt.npz")
    checkpoint.save(path, model)
    model.kernel.variance = model.kernel.variance.with_raw(model.kernel.variance.raw + 1.0)
    x0 = model.X.clone()
    restored = checkpoint.load(path, model)
    assert restored is model
    assert float(restored.kernel.variance.value.detach()[0]) == pytest.approx(1.0)
    np.testing.assert_array_equal(restored.X.numpy(), x0.numpy())


def test_trainable_roundtrip(tmp_path):
    model = _model()
    loss0 = _loss(model)
    path = os.path.join(tmp_path, "tr.npz")
    checkpoint.save_trainable(path, model)
    model.optimize(method="Adam", max_iter=5, verbose=False)
    assert _loss(model) != pytest.approx(loss0)
    restored = checkpoint.load_trainable(path, model)
    assert _loss(restored) == pytest.approx(loss0, rel=REL)


def test_resume_training(tmp_path):
    model = _model()
    model.optimize(method="Adam", max_iter=5, verbose=False)
    path = os.path.join(tmp_path, "mid.npz")
    checkpoint.save(path, model)
    l_mid = _loss(model)
    tail = fit_scan(model, "Adam", max_iter=10)[1]
    assert _loss(checkpoint.load(path, model)) == pytest.approx(l_mid, rel=REL)
    # the same steps again from the loaded values give the same losses
    again = fit_scan(model, "Adam", max_iter=10)[1]
    np.testing.assert_allclose(again.numpy(), tail.numpy(), rtol=REL)


def test_load_writes_in_place_and_keeps_storage(tmp_path):
    model = _model()
    path = os.path.join(tmp_path, "p.npz")
    checkpoint.save(path, model)
    ptrs = {k: t.data_ptr() for k, t in [*model.named_parameters(), *model.named_buffers()]}
    with torch.no_grad():
        model.kernel.length_scales.raw.add_(0.3)
    checkpoint.load(path, model)
    assert ptrs == {k: t.data_ptr() for k, t in [*model.named_parameters(), *model.named_buffers()]}
    assert model.kernel.length_scales.raw.requires_grad


def test_missing_leaf_raises(tmp_path):
    model = _model()
    path = os.path.join(tmp_path, "m.npz")
    np.savez(path, X=model.X.numpy())
    with pytest.raises(KeyError, match="Checkpoint missing leaf"):
        checkpoint.load(path, model)
    with pytest.raises(KeyError, match="Checkpoint missing leaf"):
        checkpoint.load_trainable(path, model)


def test_buffer_of_another_shape_takes_the_files(tmp_path):
    x, y = _data(n=30)
    big = GPR(x, y, kernels.Rbf(2), likelihood=likelihoods.Gaussian(0.05), device="cpu")
    path = os.path.join(tmp_path, "big.npz")
    checkpoint.save(path, big)
    small = _model()
    checkpoint.load(path, small)
    assert small.X.shape == (30, 2) and small.X.dtype == torch.float64
    assert _loss(small) == pytest.approx(_loss(big), rel=REL)


def test_jax_save_trainable_loads_into_the_port(tmp_path):
    x, y = _data()
    jm = JaxGPR(x, y, jax_kernels.Rbf(2, ARD=True, length_scales=[0.7, 1.3], variance=1.4),
                likelihood=jax_likelihoods.Gaussian(0.07))
    path = os.path.join(tmp_path, "jax.npz")
    jax_checkpoint.save_trainable(path, jm)
    tm = GPR(x, y, kernels.Rbf(2, ARD=True), likelihood=likelihoods.Gaussian(0.05), device="cpu")
    checkpoint.load_trainable(path, tm)
    assert _loss(tm) == pytest.approx(float(jm.loss()), rel=REL)


def test_roundtrip_new_model_families(tmp_path):
    rng = np.random.RandomState(0)
    x = np.linspace(-2, 2, 50)[:, None]
    f = np.sin(2 * x)
    y2 = np.concatenate([f, -f], axis=1) + 0.05 * rng.randn(50, 2)

    lmc = LMC(x, y2, kernels.Rbf(1), num_latents=2, num_inducing_points=8, device="cpu")
    lmc.optimize(method="Adam", max_iter=20, verbose=False)
    p = str(tmp_path / "lmc.npz")
    checkpoint.save(p, lmc)
    restored = checkpoint.load(p, LMC(x, y2, kernels.Rbf(1), num_latents=2, num_inducing_points=8, device="cpu"))
    assert _loss(restored) == pytest.approx(_loss(lmc), rel=REL)

    het = HeteroscedasticSVGP(x, y2[:, :1], kernels.Rbf(1), num_inducing_points=8, device="cpu")
    het.optimize(method="Adam", max_iter=20, learning_rate=0.005, verbose=False)
    p2 = str(tmp_path / "het.npz")
    checkpoint.save(p2, het)
    restored2 = checkpoint.load(p2, HeteroscedasticSVGP(x, y2[:, :1], kernels.Rbf(1), num_inducing_points=8,
                                                        device="cpu"))
    assert _loss(restored2) == pytest.approx(_loss(het), rel=REL)
    np.testing.assert_allclose(restored2.predict_y(x[:5])[0], het.predict_y(x[:5])[0], rtol=REL)


def _stream_data():
    rng = np.random.RandomState(0)
    x = rng.randn(240, 2)
    y = np.sin(x.sum(-1, keepdims=True)) + 0.1 * rng.randn(240, 1)
    return x, y, x[rng.permutation(240)[:20]].copy(), rng


def test_streaming_roundtrip(tmp_path):
    x, y, z, rng = _stream_data()
    ls = 0.8 + 0.2 * rng.rand(2)

    def fresh():
        return StreamingVFE(ekernels.Rbf(2, ARD=True, length_scales=ls), z, likelihood=likelihoods.Gaussian(0.05),
                            jitter=1e-6, device="cpu")

    stream = fresh()
    for lo in range(0, 240, 64):
        stream = stream.update(x[lo : lo + 64], y[lo : lo + 64])
    path = str(tmp_path / "stream.npz")
    checkpoint.save(path, stream)
    loaded = checkpoint.load(path, fresh())
    with torch.no_grad():
        assert float(loaded.log_likelihood()) == pytest.approx(float(stream.log_likelihood()), rel=REL)
    assert float(loaded.n_seen) == float(stream.n_seen) == 240.0
    xq = np.random.RandomState(9).randn(5, 2)
    np.testing.assert_allclose(loaded.predict_f(xq)[0], stream.predict_f(xq)[0], rtol=1e-10)


def test_online_roundtrip(tmp_path):
    x, y, z, _ = _stream_data()

    def fresh():
        return OnlineSGPR(kernels.Rbf(2, ARD=True, length_scales=0.8), z, likelihood=likelihoods.Gaussian(0.05),
                          jitter=1e-6, device="cpu")

    o = fresh().step(x[:100], y[:100], fit_iters=20)
    path = str(tmp_path / "online.npz")
    checkpoint.save(path, o)
    target = fresh().step(x[:10], y[:10], fit_iters=0)  # make the old-state slots
    loaded = checkpoint.load(path, target)
    xq = np.random.RandomState(9).randn(5, 2)
    np.testing.assert_allclose(loaded.predict_f(xq)[0], o.predict_f(xq)[0], rtol=1e-10)
    np.testing.assert_allclose(loaded.predict_f(xq)[1], o.predict_f(xq)[1], rtol=1e-10)


def test_annotate_and_trace_write_the_range(tmp_path):
    logdir = os.path.join(tmp_path, "tb")
    with profiling.trace(logdir) as prof:
        with profiling.annotate("gram"):
            x = torch.ones((4, 4))
            _ = x @ x
    files = [os.path.join(root, f) for root, _, names in os.walk(logdir) for f in names]
    assert files and all(f.endswith(".pt.trace.json") for f in files)
    events = json.load(open(files[0]))["traceEvents"]
    assert any(e.get("name") == "gram" for e in events)
    assert any(e.key == "gram" for e in prof.key_averages())


def test_device_memory_stats_shape():
    stats = profiling.device_memory_stats()
    assert isinstance(stats, dict)
    if not torch.cuda.is_available():
        assert stats == {}


def test_step_metrics_summary():
    m = profiling.StepMetrics()
    for i in range(3):
        m(i, 10.0 - i)
    s = m.summary()
    assert s["steps"] == 3 and s["final_loss"] == 8.0 and s["best_loss"] == 8.0
    assert s["mean_step_time_s"] is not None


def test_step_metrics_as_a_fit_callback():
    model = _model()
    metrics = profiling.StepMetrics()
    losses, _ = model.optimize(method="Adam", max_iter=4, verbose=False, callback=metrics)
    np.testing.assert_array_equal(metrics.losses, losses)
    assert len(metrics.step_times) == 3
