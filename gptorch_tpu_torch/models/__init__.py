from .base import GPModel
from .gpr import GPR
from .posterior import GPRPosterior, Posterior, ServingGPRPosterior, gpr_posterior

__all__ = ["GPModel", "GPR", "GPRPosterior", "Posterior", "ServingGPRPosterior", "gpr_posterior"]
