"""Compute primitives: the hand-written Hopper kernels, their plain twins,
and the blocked factorizations and fused NLMLs built on them.

* :mod:`gram`        -- the radial Gram matrix (``csrc/rbf_gram.cu``, K1).
* :mod:`contract`    -- the backward contraction of the fused radial NLML
  (``csrc/radial_contract.cu``, K2).
* :mod:`blocked`     -- blocked Cholesky, triangular solves and inverses.
* :mod:`gpr_fast`    -- the fused radial NLML with its closed-form backward.
* :mod:`gpr_general` -- the fused NLML for any kernel.

:func:`launch_counts` reads the kernels' launch counters.
"""

from .blocked import blocked_cholesky, blocked_ltrsm, blocked_trtri, cholesky_blocked, tril_square_rec
from .contract import radial_contractions, radial_contractions_plain
from .gpr_fast import radial_nlml, rbf_nlml, rbf_nlml_value_and_grad
from .gpr_general import general_nlml
from .gram import rbf_gram, rbf_gram_plain


def launch_counts() -> dict:
    """Each hand-written kernel's launch counter, by wrapper name.  A
    counter counts the launches its wrapper made from the host; inside a
    captured CUDA graph that is one per capture, not one per replay."""
    return {"rbf_gram": rbf_gram.launches, "radial_contractions": radial_contractions.launches}

__all__ = [
    "blocked_cholesky",
    "blocked_ltrsm",
    "blocked_trtri",
    "cholesky_blocked",
    "general_nlml",
    "launch_counts",
    "radial_contractions",
    "radial_contractions_plain",
    "radial_nlml",
    "rbf_gram",
    "rbf_gram_plain",
    "rbf_nlml",
    "rbf_nlml_value_and_grad",
    "tril_square_rec",
]
