"""Rules of the PyTorch/CUDA port.

* Neither the package gptorch_tpu_torch nor chip_smoke.py imports jax or
  anything of the JAX package gptorch_tpu (an AST scan of every import).
* Entry points run on the card unless the caller asks for the CPU: with no
  card present, GPR without a device raises instead of falling back.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from gptorch_tpu_torch import kernels, settings
from gptorch_tpu_torch.models import GPR

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "gptorch_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
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
    assert {"gram.py", "gpr.py", "posterior.py", "chip_smoke.py"} <= names
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


def test_cuda_device_pins_full_float32(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert settings.resolve_device("cuda").type == "cuda"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
