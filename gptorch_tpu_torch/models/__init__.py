from .base import GPModel
from .gplvm import GPLVM
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
    gplvm_posterior,
    gpr_posterior,
    iterative_gpr_posterior,
    svgp_posterior,
    vfe_posterior,
)
from .sparse_gpr import FITC, SVGP, VFE
from .vecchia import VecchiaGPR

__all__ = [
    "FITC",
    "FantasyGPRChain",
    "GPLVM",
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
    "VecchiaGPR",
    "fitc_posterior",
    "gplvm_posterior",
    "gpr_posterior",
    "iterative_gpr_posterior",
    "svgp_posterior",
    "vfe_posterior",
]
