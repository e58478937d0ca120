from .base import GPModel
from .gpr import GPR
from .posterior import (
    FantasyGPRChain,
    GPRPosterior,
    IterativeGPRPosterior,
    LowRankPosterior,
    Posterior,
    ServingGPRPosterior,
    ServingLowRankPosterior,
    ServingSVGPPosterior,
    SVGPPosterior,
    fitc_posterior,
    gpr_posterior,
    iterative_gpr_posterior,
    svgp_posterior,
    vfe_posterior,
)
from .sparse_gpr import FITC, SVGP, VFE

__all__ = [
    "FITC",
    "FantasyGPRChain",
    "GPModel",
    "GPR",
    "GPRPosterior",
    "IterativeGPRPosterior",
    "LowRankPosterior",
    "Posterior",
    "SVGP",
    "SVGPPosterior",
    "ServingGPRPosterior",
    "ServingLowRankPosterior",
    "ServingSVGPPosterior",
    "VFE",
    "fitc_posterior",
    "gpr_posterior",
    "iterative_gpr_posterior",
    "svgp_posterior",
    "vfe_posterior",
]
