"""Training loops (counterpart of ``gptorch_tpu/training``; the checkpoint
module is not ported yet)."""

from . import fit, natgrad
from .fit import fit_scan, fit_scipy, fit_torch, make_optimizer
from .natgrad import fit_svgp_natgrad, make_natgrad_step

__all__ = [
    "fit",
    "fit_scan",
    "fit_scipy",
    "fit_svgp_natgrad",
    "fit_torch",
    "make_natgrad_step",
    "make_optimizer",
    "natgrad",
]
