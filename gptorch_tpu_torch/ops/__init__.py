"""Compute primitives: the hand-written Hopper kernels, their plain twins,
and the blocked factorizations and fused NLMLs built on them.

* :mod:`gram`        -- the radial Gram matrix (``csrc/rbf_gram.cu``, K1).
* :mod:`contract`    -- the backward contraction of the fused radial NLML
  (``csrc/radial_contract.cu``, K2).
* :mod:`mvm`         -- the matrix-free product with the noisy radial Gram
  (``csrc/radial_mvm.cu``, K3).
* :mod:`lowrank_contract` -- the backward contraction of the matrix-free
  NLML (``csrc/lowrank_contract.cu``, K4).
* :mod:`blocked`     -- blocked Cholesky, triangular solves and inverses.
* :mod:`gpr_fast`    -- the fused radial NLML with its closed-form backward.
* :mod:`gpr_general` -- the fused NLML for any kernel.
* :mod:`iterative`   -- the matrix-free exact GP (mBCG, SLQ, pivoted
  Cholesky, LOVE) on K3 and K4.
* :mod:`vecchia`, :mod:`ssm`, :mod:`ski` -- the Vecchia conditionals, the
  state-space GP's parallel Kalman scans and SKI's interpolation and
  Toeplitz products (torch ops, no hand kernel).

:func:`launch_counts` reads the kernels' launch counters and
:func:`reset_launch_counts` sets them to 0.
"""

from .blocked import blocked_cholesky, blocked_ltrsm, blocked_trtri, cholesky_blocked, tril_square_rec
from .contract import radial_contractions, radial_contractions_plain
from .gpr_fast import radial_nlml, rbf_nlml, rbf_nlml_value_and_grad
from .gpr_general import general_nlml
from .gram import rbf_gram, rbf_gram_plain
from .iterative import (
    lanczos_root_inverse,
    mbcg,
    pivoted_cholesky,
    radial_mvm,
    radial_nlml_iterative,
    radial_slq_diagnostics,
    woodbury_logdet,
    woodbury_solve,
)
from .lowrank_contract import lowrank_contractions, lowrank_contractions_plain
from .mvm import gram_mvm, gram_mvm_plain

#: Every hand-written kernel's wrapper, by name (each counts its launches).
_WRAPPERS = {
    "rbf_gram": rbf_gram,
    "radial_contractions": radial_contractions,
    "gram_mvm": gram_mvm,
    "lowrank_contractions": lowrank_contractions,
}


def launch_counts() -> dict:
    """Each hand-written kernel's launch counter, by wrapper name.  A
    counter counts the launches its wrapper made from the host; inside a
    captured CUDA graph that is one per capture, not one per replay."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for fn in _WRAPPERS.values():
        fn.launches = 0


__all__ = [
    "blocked_cholesky",
    "blocked_ltrsm",
    "blocked_trtri",
    "cholesky_blocked",
    "general_nlml",
    "gram_mvm",
    "gram_mvm_plain",
    "lanczos_root_inverse",
    "launch_counts",
    "lowrank_contractions",
    "lowrank_contractions_plain",
    "mbcg",
    "pivoted_cholesky",
    "radial_contractions",
    "radial_contractions_plain",
    "radial_mvm",
    "radial_nlml",
    "radial_nlml_iterative",
    "radial_slq_diagnostics",
    "rbf_gram",
    "rbf_gram_plain",
    "rbf_nlml",
    "rbf_nlml_value_and_grad",
    "reset_launch_counts",
    "tril_square_rec",
    "woodbury_logdet",
    "woodbury_solve",
]
