"""The port's compositional kernel search (gptorch_tpu_torch.structure)
against the JAX package, float64 on the CPU, data from a numpy seed
(n = 40, 1-D, a trend plus a wiggle).

* bic and aic of a GPR and a composite equal the JAX package's (1e-12),
  and penalize the parameter count as its tests/test_structure.py checks;
* a search over bases Rbf and Linear to depth 2 (six candidates, 20 Adam
  steps each at lr 0.05) gives the JAX package's expression, and every
  candidate's score and NLML to 1e-6 relative, in the same order.  Adam
  keeps the JAX side to one compiled scan per structure (its L-BFGS
  compiles for about 3 s per candidate on the CPU); the port's L-BFGS is
  held to optax's in test_torch_lbfgs.py;
* copy before train: with the default L-BFGS, training a candidate leaves
  the kernel and likelihood it starts from -- the trained parent's, for a
  child -- as they were, and every candidate's model keeps the NLML it was
  scored at, the incumbent's loss() among them; with the copies taken out
  the same check fails;
* restarts draw their perturbations through sampling.standard_normal, one
  draw per trainable in sorted path order; unknown criteria and bases
  raise; max_candidates bounds the sweep.
"""

import jax
import numpy as np
import pytest
import torch

from gptorch_tpu import kernels as jax_kernels
from gptorch_tpu import likelihoods as jax_likelihoods
from gptorch_tpu import structure as jax_structure
from gptorch_tpu.models import GPR as JaxGPR
from gptorch_tpu_torch import kernels, likelihoods, sampling, structure
from gptorch_tpu_torch.models import GPR
from gptorch_tpu_torch.module import get_trainable

SEARCH = dict(bases=("Rbf", "Linear"), max_depth=2, max_iter=20, method="Adam", learning_rate=0.05)


_JAX_LOSS = jax.jit(JaxGPR.loss)


@pytest.fixture(autouse=True)
def _compiled_jax_loss(monkeypatch):
    """The JAX model's loss (the criteria's NLML) as one compiled program
    per structure: op by op, each new structure costs seconds of compiles."""
    monkeypatch.setattr(JaxGPR, "loss", _JAX_LOSS)


@pytest.fixture(autouse=True)
def _float64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


def _data():
    rng = np.random.RandomState(0)
    x = np.linspace(0, 4, 40)[:, None]
    return x, 0.5 * x + np.sin(3 * x) + 0.1 * rng.randn(40, 1)


@pytest.mark.parametrize("composite", [False, True])
def test_criteria_match_jax(composite):
    rng = np.random.RandomState(0)
    x = rng.randn(50, 2)
    y = np.sin(x[:, :1]) + 0.1 * rng.randn(50, 1)
    jk = jax_kernels.Rbf(2) + jax_kernels.Linear(2) if composite else jax_kernels.Rbf(2)
    tk = kernels.Rbf(2) + kernels.Linear(2) if composite else kernels.Rbf(2)
    jm = JaxGPR(x, y, jk, likelihood=jax_likelihoods.Gaussian(0.05))
    tm = GPR(x, y, tk, likelihood=likelihoods.Gaussian(0.05), device="cpu")
    for name in ("bic", "aic"):
        assert getattr(structure, name)(tm) == pytest.approx(getattr(jax_structure, name)(jm), rel=1e-12)
    nlml = float(tm.loss().detach())
    assert structure.bic(tm) - 2 * nlml > structure.aic(tm) - 2 * nlml  # log 50 > 2 per parameter


def test_search_matches_jax():
    x, y = _data()
    jax_search = jax_structure.kernel_search(x, y, **SEARCH)
    got = structure.kernel_search(x, y, device="cpu", **SEARCH)
    assert got.expression == jax_search.expression
    assert got.score == pytest.approx(jax_search.score, rel=1e-6)
    assert [s.expression for s in got.history] == [s.expression for s in jax_search.history]
    assert len(got.history) == 6
    for g, w in zip(got.history, jax_search.history):
        assert g.depth == w.depth
        assert g.score == pytest.approx(w.score, rel=1e-6), g.expression
        assert g.nlml == pytest.approx(w.nlml, rel=1e-6), g.expression
    assert isinstance(got.model, GPR) and got.model.device.type == "cpu"


def _spied_search(monkeypatch):
    """The default search (L-BFGS) with ``_train`` checked: the kernel and
    likelihood it starts from are unchanged after it trains, and every
    model it returns keeps the NLML it returned.  Returns (result, calls)."""
    calls = []
    train = structure._train

    def spy(x, y, kern, likelihood, **kw):
        start = [{k: v.detach().clone() for k, v in get_trainable(m).items()} for m in (kern, likelihood)
                 if m is not None]
        model, nlml = train(x, y, kern, likelihood, **kw)
        for before, m in zip(start, (kern, likelihood)):
            after = get_trainable(m)
            assert all(torch.equal(before[k], after[k]) for k in before), "training moved its start"
        calls.append((model, nlml))
        return model, nlml

    monkeypatch.setattr(structure, "_train", spy)
    x, y = _data()
    result = structure.kernel_search(x, y, bases=("Rbf", "Linear"), max_depth=2, max_iter=20, device="cpu")
    return result, calls


def test_copy_before_train(monkeypatch):
    result, calls = _spied_search(monkeypatch)
    assert len(calls) == 6
    for model, nlml in calls:
        if model is not None:
            assert float(model.loss().detach()) == nlml
    incumbent = next(s for s in result.history if s.expression == result.expression)
    assert float(result.model.loss().detach()) == incumbent.nlml
    assert structure.bic(result.model) == result.score


def test_copy_before_train_fails_without_the_copies(monkeypatch):
    monkeypatch.setattr(structure.copy, "deepcopy", lambda m: m)
    with pytest.raises(AssertionError, match="training moved its start"):
        _spied_search(monkeypatch)


def test_restarts_draw_per_trainable_in_sorted_order(monkeypatch):
    shapes = []

    def normal(generator, shape, like):
        shapes.append(tuple(shape))
        return torch.zeros(tuple(shape), dtype=like.dtype, device=like.device)

    monkeypatch.setattr(sampling, "standard_normal", normal)
    x, y = _data()
    one = structure.kernel_search(x, y, bases=("Rbf",), max_depth=1, max_iter=5, device="cpu")
    two = structure.kernel_search(x, y, bases=("Rbf",), max_depth=1, max_iter=5, restarts=2, device="cpu")
    trainables = get_trainable(one.model)
    assert shapes == [tuple(trainables[k].shape) for k in sorted(trainables)]
    assert two.score == pytest.approx(one.score, rel=1e-12)  # zero perturbations: the same run twice


def test_validation_and_budget():
    with pytest.raises(ValueError):
        structure.kernel_search(np.zeros((4, 1)), np.zeros((4, 1)), criterion="elpd", device="cpu")
    with pytest.raises(ValueError):
        structure.kernel_search(np.zeros((4, 1)), np.zeros((4, 1)), bases=("NotAKernel",), device="cpu")
    x, y = _data()
    res = structure.kernel_search(x, y, bases=("Rbf", "Linear"), max_depth=3, max_iter=5, max_candidates=3,
                                  device="cpu")
    assert len(res.history) == 3
