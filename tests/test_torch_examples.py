"""The PyTorch twins of the examples (examples_torch/) on the CPU, in process.

* test_example: every twin at the arguments of tests/test_examples.py
  (``main([..., "--device", "cpu"])``, float64, one CPU thread), holding
  the JAX test's assertions: its marker strings (where a JAX line names a
  JAX mechanism, the replacement in REPLACED) and its numeric checks.
* test_parity: the deterministic twins against the numbers the JAX script
  prints on the same arguments, the JAX script run in this process (x64,
  as tests/conftest.py sets it).  Each number is held to half a unit of
  its last printed digit plus the example's tolerance in PARITY.
  ``kernel_discovery`` has no JAX rerun (its JAX test takes up to 900 s),
  and the draw-based twins none either: their draws come from a
  ``torch.Generator`` (ROADMAP §3, "Random draws").
* test_notebook: the notebook twin's code cells, its plotting cells (tag
  "plot") left out, with ``device = "cpu"`` injected after its
  "parameters" cell.

Each twin runs once; test_parity reads the run of test_example.  Parity
cases whose JAX script takes over 30 s here (its compiles) are marked
``slow``.
"""

import contextlib
import importlib
import importlib.util
import io
import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from gptorch_tpu_torch import settings

ROOT = pathlib.Path(__file__).resolve().parents[1]

# case (the twin's name and what tells its runs apart) -> (the arguments
# of tests/test_examples.py, the JAX test's markers)
CASES = {
    "regression_1d GPR": (["--model-type", "GPR", "--no-plot"], ["predictive mean range"]),
    "regression_1d VFE": (["--model-type", "VFE", "--no-plot"], ["predictive mean range"]),
    "classification_1d": (["--no-plot"], ["train accuracy"]),
    "svgp_natgrad": (["--no-plot", "--n", "128", "--steps", "30"], ["serving: predict_y"]),
    "multioutput": (["--no-plot", "--n", "80", "--steps", "200"], ["LMC mixing ratio"]),
    "heteroscedastic": (["--no-plot", "--n", "120", "--steps", "600"], ["noise-profile correlation"]),
    "timeseries_statespace": (["--no-plot", "--n", "4000", "--steps", "40"], ["dense GPR NLML", "rel diff"]),
    "classification_laplace": (["--no-plot", "--optimize-iters", "30"], ["Laplace evidence", "train accuracy"]),
    "hyperparameter_mcmc": (["--no-plot", "--num-samples", "150", "--num-warmup", "150"],
                            ["divergences=0", "posterior-mixture"]),
    "multiclass_1d": (["--no-plot", "--steps", "400"], ["train accuracy"]),
    "bayesopt_loop": (["--no-plot", "--iters", "18"], ["regret", "parallel proposals"]),
    "streaming_gp": (["--no-plot", "--batches", "8"], ["restart fleet", "one compiled program"]),
    "active_learning": (["--no-plot", "--rounds", "3"], ["ALC beats random: True"]),
    "derivative_gp": (["--no-plot"], ["improvement factor"]),
    "kernel_discovery": (["--no-plot"], ["discovered kernel: (Rbf + Linear)"]),
    "serving": (["--no-plot", "--n", "512", "--queries", "32"], ["exported serving posterior", "serve (mean only)"]),
}

# JAX markers that name a JAX mechanism, and what the twin prints on the CPU
# instead (on the card: "one captured CUDA graph").
REPLACED = {"one compiled program": "one eager loop"}


def _number(text):
    return float(text.rstrip("%x"))


def _half_unit(text):
    """Half a unit of the last printed digit of ``text`` (a share's, for a
    percentage)."""
    number = text.rstrip("%x")
    mantissa = number.split("e")[0]
    half = 0.5 * 10.0 ** -(len(mantissa.split(".")[1]) if "." in mantissa else 0)
    if "e" in number:
        half *= 10.0 ** int(number.split("e")[1])
    return half / 100.0 if text.endswith("%") else half


# case -> (the JAX script's printed numbers: a regex per line, the twin's
# result keys in the order of the regex's groups (a "%" group is a share),
# the tolerance beyond the printed rounding: absolute, relative)
PARITY = {
    "regression_1d GPR": ([(r"predictive mean range \[(\S+), (\S+)\]", ["mean_min", "mean_max"])], 1e-6, 0.0),
    "regression_1d VFE": ([(r"predictive mean range \[(\S+), (\S+)\]", ["mean_min", "mean_max"])], 1e-6, 0.0),
    "serving": ([(r"NLML (\S+) -> (\S+)", ["nlml_first", "nlml_last"]),
                 (r"exported serving posterior: (\S+) MB", ["exported_mb"]),
                 (r"max rel err: (\S+)", ["err"])], 0.0, 1e-6),
    "derivative_gp": ([(r"value-only GPR\s+: (\S+)", ["rmse_value_only"]),
                       (r"gradient-enhanced\s+: (\S+)", ["rmse_gradient"]),
                       (r"improvement factor\s+: (\S+)", ["improvement"]),
                       (r"gradient-field RMSE \(rel\)\s+: (\S+)", ["grad_rel_rmse"])], 0.0, 1e-6),
    "timeseries_statespace": ([(r"NLML (\S+) -> (\S+)", ["nlml_first", "nlml_last"]),
                               (r"dense GPR NLML (\S+) vs state-space (\S+)", ["dense_nlml", "statespace_nlml"]),
                               (r"coverage of the true function (\S+)", ["coverage"])], 0.0, 1e-6),
    "classification_laplace": ([(r"Laplace evidence: (\S+) -> (\S+);", ["evidence_before", "evidence_after"]),
                                (r"train accuracy: (\S+);", ["accuracy"]),
                                (r"p range \[(\S+), (\S+)\]", ["p_min", "p_max"])], 0.0, 1e-6),
}
SLOW_PARITY = {"derivative_gp", "timeseries_statespace", "classification_laplace"}

_RUNS = {}


@pytest.fixture(autouse=True)
def _cpu_float64_one_thread():
    dtype, threads = torch.get_default_dtype(), torch.get_num_threads()
    torch.set_default_dtype(torch.float64)
    torch.set_num_threads(1)
    yield
    torch.set_default_dtype(dtype)
    torch.set_num_threads(threads)
    assert settings.config.device == "cuda"


def _twin(case):
    """(stdout, result) of the twin of ``case`` on the CPU, run once."""
    if case not in _RUNS:
        args = CASES[case][0]
        module = importlib.import_module(f"examples_torch.{case.split()[0]}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            result = module.main(args + ["--device", "cpu"])
        _RUNS[case] = out.getvalue(), result
    return _RUNS[case]


def _jax_script(case):
    """The stdout of the JAX script of ``case`` on the same arguments, run
    in this process."""
    name, args = case.split()[0], CASES[case][0]
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        spec.loader.exec_module(module)
        if name == "derivative_gp":  # its main() reads sys.argv
            argv, sys.argv = sys.argv, [name] + args
            try:
                module.main()
            finally:
                sys.argv = argv
        else:
            module.main(args)
    return out.getvalue()


@pytest.mark.parametrize("case", sorted(CASES))
def test_example(case):
    text, result = _twin(case)
    for marker in CASES[case][1]:
        assert REPLACED.get(marker, marker) in text, text
    assert isinstance(result, dict) and result
    if case == "streaming_gp":
        assert result["rel_diff"] < 1e-3, text
        assert "one compiled program" not in text
    if case == "derivative_gp":
        assert result["improvement"] > 2.0, text
    if case == "hyperparameter_mcmc":
        assert result["divergences"] == 0
    if case == "active_learning":
        assert result["alc_beats_random"] is True


def test_replaced_markers_name_the_card_counterpart():
    from examples_torch import _runtime

    assert _runtime.mechanism(torch.device("cpu")) == REPLACED["one compiled program"]
    assert _runtime.mechanism(torch.device("cuda")) == "one captured CUDA graph"


@pytest.mark.parametrize("case", [pytest.param(c, marks=pytest.mark.slow) if c in SLOW_PARITY else c
                                  for c in sorted(PARITY)])
def test_parity(case):
    lines, atol, rtol = PARITY[case]
    jax_text = _jax_script(case)
    _, result = _twin(case)
    for pattern, keys in lines:
        match = re.search(pattern, jax_text)
        assert match, (pattern, jax_text)
        for printed, key in zip(match.groups(), keys):
            want, got = _number(printed), result[key]
            if printed.endswith("%"):
                want /= 100.0
            tol = _half_unit(printed) + atol + rtol * abs(want)
            assert abs(got - want) <= tol, f"{case} {key}: twin {got!r}, JAX printed {printed} (tol {tol:.2e})"


def test_notebook():
    nb = json.loads((ROOT / "examples_torch" / "notebooks" / "regression_1d.ipynb").read_text())
    tags = [c["metadata"].get("tags", []) for c in nb["cells"]]
    assert any("parameters" in t for t in tags) and any("plot" in t for t in tags)
    ns = {}
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            for cell, cell_tags in zip(nb["cells"], tags):
                if cell["cell_type"] != "code" or "plot" in cell_tags:
                    continue
                exec("".join(cell["source"]), ns)
                if "parameters" in cell_tags:
                    exec('device = "cpu"', ns)
    finally:
        settings.config.device = "cuda"
    assert "learned mean slope" in out.getvalue()
    _, result = _twin("regression_1d GPR")
    np.testing.assert_allclose(ns["mean"], result["mean"], rtol=1e-12, atol=1e-12)
    for key in ("mean", "var", "mean_s", "var_s"):
        assert np.all(np.isfinite(ns[key]))
    assert ns["samples"].shape == (5, 201, 1)
