"""Training loops (counterpart of ``gptorch_tpu/training``; the
checkpoint and natural-gradient modules are not ported yet)."""

from . import fit
from .fit import fit_scan, fit_scipy, fit_torch, make_optimizer

__all__ = ["fit", "fit_scan", "fit_scipy", "fit_torch", "make_optimizer"]
