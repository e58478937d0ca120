"""gptorch_tpu_torch: the PyTorch/CUDA port of gptorch_tpu.

Module names follow the JAX package, so each module's counterpart is easy
to find.  Entry points run on the CUDA card unless the caller passes
``device="cpu"``; every TPU kernel of the JAX package becomes a
hand-written Hopper kernel under ``csrc/`` with a plain PyTorch twin.
"""

from . import (
    bijectors,
    convert,
    ekernels,
    functions,
    kernels,
    likelihoods,
    mean_functions,
    models,
    nn,
    ops,
    priors,
    sampling,
    settings,
    training,
    util,
)
from . import bayesopt  # noqa: E402  (after models)
from . import mcmc  # noqa: E402
from . import structure  # noqa: E402  (after models, training)
from .module import Module, get_trainable, pack_vector, set_trainable, unpack_vector, with_trainable
from .param import Param, positive_param

__all__ = [
    "bayesopt",
    "mcmc",
    "structure",
    "bijectors",
    "convert",
    "ekernels",
    "functions",
    "kernels",
    "likelihoods",
    "mean_functions",
    "models",
    "nn",
    "ops",
    "priors",
    "sampling",
    "settings",
    "training",
    "util",
    "Module",
    "Param",
    "get_trainable",
    "pack_vector",
    "positive_param",
    "set_trainable",
    "unpack_vector",
    "with_trainable",
]
