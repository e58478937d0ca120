"""Rules of the PyTorch/CUDA port.

* Neither the package gptorch_tpu_torch, nor chip_smoke.py, nor the example
  twins under examples_torch/ (scripts and the notebook's code cells)
  import jax or anything of the JAX package gptorch_tpu (an AST scan of
  every import).
* Entry points run on the card unless the caller asks for the CPU: with no
  card present, GPR without a device raises instead of falling back, and
  so does an example twin run without ``--device cpu``.
"""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from gptorch_tpu_torch import kernels, settings
from gptorch_tpu_torch.models import GPR

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (
    sorted((ROOT / "gptorch_tpu_torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py"]
    + sorted((ROOT / "examples_torch").rglob("*.py"))
    + sorted((ROOT / "examples_torch").rglob("*.ipynb"))
)


def _source(path):
    """A file's Python source; a notebook's code cells, one after another."""
    if path.suffix == ".ipynb":
        cells = json.loads(path.read_text())["cells"]
        return "\n".join("".join(c["source"]) for c in cells if c["cell_type"] == "code")
    return path.read_text()


def _imported_modules(path):
    tree = ast.parse(_source(path), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "gptorch_tpu")


def test_scan_sees_the_package():
    names = {p.name for p in PORT_FILES}
    assert {"gram.py", "gpr.py", "posterior.py", "chip_smoke.py", "serving.py", "regression_1d.ipynb"} <= names
    assert len([p for p in PORT_FILES if p.parent.name == "examples_torch" and not p.name.startswith("_")]) == 15
    assert "gptorch_tpu_torch.models" in set(_imported_modules(ROOT / "examples_torch/notebooks/regression_1d.ipynb"))
    assert _forbidden("jax.numpy") and _forbidden("gptorch_tpu.ops")
    assert not _forbidden("gptorch_tpu_torch.ops")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [name for name in _imported_modules(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_gpr_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    x, y = np.zeros((4, 1)), np.zeros((4, 1))
    assert settings.config.device == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPR(x, y, kernels.Rbf(1))
    model = GPR(x, y, kernels.Rbf(1), device="cpu")
    assert model.device.type == "cpu"
    assert model.kernel.variance.raw.device.type == "cpu"


@pytest.mark.parametrize("name, args", [("regression_1d", ["--no-plot"]), ("serving", ["--no-plot", "--n", "16"])])
def test_example_without_device_needs_a_card(name, args):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    module = importlib.import_module(f"examples_torch.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(args)
    assert settings.config.device == "cuda"


def test_cuda_device_pins_full_float32(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert settings.resolve_device("cuda").type == "cuda"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
