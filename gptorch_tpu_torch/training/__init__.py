"""Training loops and checkpoints (counterpart of ``gptorch_tpu/training``)."""

from . import checkpoint, fit, lbfgs, natgrad
from .fit import fit_scan, fit_scipy, fit_torch, make_optimizer
from .lbfgs import LBFGS
from .natgrad import fit_svgp_natgrad, make_natgrad_step

__all__ = [
    "LBFGS",
    "checkpoint",
    "fit",
    "fit_scan",
    "fit_scipy",
    "fit_svgp_natgrad",
    "fit_torch",
    "lbfgs",
    "make_natgrad_step",
    "make_optimizer",
    "natgrad",
]
