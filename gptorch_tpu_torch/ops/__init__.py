"""Compute primitives: the hand-written Hopper kernels and their plain twins.

* :mod:`gram`    -- the radial Gram matrix (``csrc/rbf_gram.cu``).
* :mod:`blocked` -- the blocked triangular inverse.
"""

from .blocked import blocked_trtri
from .gram import rbf_gram, rbf_gram_plain

__all__ = ["blocked_trtri", "rbf_gram", "rbf_gram_plain"]
