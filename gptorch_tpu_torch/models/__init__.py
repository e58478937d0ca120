from .base import GPModel
from .gplvm import GPLVM
from .gpr import GPR
from .kronecker import GridGPR
from .posterior import (
    FantasyGPRChain,
    GPRPosterior,
    GridGPRPosterior,
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
from .ski import SKIGPR, SKIPosterior
from .sparse_gpr import FITC, SVGP, VFE
from .statespace import StateSpaceGPR
from .vecchia import VecchiaGPR

__all__ = [
    "FITC",
    "FantasyGPRChain",
    "GPLVM",
    "GPModel",
    "GPR",
    "GPRPosterior",
    "GridGPR",
    "GridGPRPosterior",
    "IterativeGPRPosterior",
    "LowRankPosterior",
    "Posterior",
    "SKIGPR",
    "SKIPosterior",
    "SVGP",
    "SVGPPosterior",
    "ServingGPRPosterior",
    "ServingLowRankPosterior",
    "ServingSVGPPosterior",
    "StateSpaceGPR",
    "VFE",
    "VecchiaGPR",
    "fitc_posterior",
    "gplvm_posterior",
    "gpr_posterior",
    "iterative_gpr_posterior",
    "svgp_posterior",
    "vfe_posterior",
]
