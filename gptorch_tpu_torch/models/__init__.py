from .base import GPModel
from .deep import DeepGP
from .derivative import DerivativeGPR
from .ensemble import GPEnsemble
from .gplvm import GPLVM
from .gpr import GPR
from .heteroscedastic import HeteroscedasticSVGP
from .kronecker import GridGPR
from .laplace import LaplaceGP
from .multioutput import ICM, LMC
from .online import OnlineSGPR
from .posterior import (
    FantasyGPRChain,
    GPRPosterior,
    GridGPRPosterior,
    ICMPosterior,
    IterativeGPRPosterior,
    LMCPosterior,
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
    lmc_posterior,
    svgp_posterior,
    vfe_posterior,
)
from .ski import SKIGPR, SKIPosterior
from .sparse_gpr import FITC, SVGP, VFE
from .statespace import StateSpaceGPR
from .streaming import StreamingVFE
from .studentt import TPR
from .vecchia import VecchiaGPR
from .warped import TanhWarp, WarpedGPR

__all__ = [
    "DeepGP",
    "DerivativeGPR",
    "FITC",
    "FantasyGPRChain",
    "GPEnsemble",
    "GPLVM",
    "GPModel",
    "GPR",
    "GPRPosterior",
    "GridGPR",
    "GridGPRPosterior",
    "HeteroscedasticSVGP",
    "ICM",
    "ICMPosterior",
    "IterativeGPRPosterior",
    "LMC",
    "LMCPosterior",
    "LaplaceGP",
    "LowRankPosterior",
    "OnlineSGPR",
    "Posterior",
    "SKIGPR",
    "SKIPosterior",
    "SVGP",
    "SVGPPosterior",
    "ServingGPRPosterior",
    "ServingLowRankPosterior",
    "ServingSVGPPosterior",
    "StateSpaceGPR",
    "StreamingVFE",
    "TPR",
    "TanhWarp",
    "VFE",
    "VecchiaGPR",
    "WarpedGPR",
    "fitc_posterior",
    "gplvm_posterior",
    "gpr_posterior",
    "iterative_gpr_posterior",
    "lmc_posterior",
    "svgp_posterior",
    "vfe_posterior",
]
