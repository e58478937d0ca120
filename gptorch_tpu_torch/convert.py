"""Carry trained weights across from the JAX package.

The JAX package's ``gptorch_tpu.module.get_trainable(model)`` maps dotted
paths (``"kernel.length_scales"``, ``"likelihood.variance"``, an SVGP's
``"Z"``, ``"induced_output_mean"`` and ``"induced_output_chol_cov"``, a deep
kernel's ``"kernel.net.layer0.w"``, a SpectralMixture's
``"kernel.weights"``/``"means"``/``"scales"``, ``"likelihood.df"``, ...)
to raw, unconstrained arrays (a LowerCholesky parameter's raw value is
``tril(L, -1) + diag(log diag L)`` in both packages).  :func:`load_trainable` loads such a dictionary, as
numpy arrays, into the port's model built with the same structure.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .module import Module, get_trainable, set_trainable


def load_trainable(model: Module, values: Mapping[str, np.ndarray]) -> Module:
    """Overwrite the raw value of every trainable Param of ``model`` from
    ``values``, in place; returns ``model``.

    The two sets of paths must match exactly and each array must have the
    Param's shape: a model built with another structure raises
    ``ValueError`` instead of loading a subset.
    """
    own = get_trainable(model)
    if set(own) != set(values):
        raise ValueError(
            f"trainable paths differ: missing {sorted(set(own) - set(values))}, "
            f"unexpected {sorted(set(values) - set(own))}"
        )
    for path, raw in own.items():
        shape = np.shape(values[path])
        if tuple(shape) != tuple(raw.shape):
            raise ValueError(f"{path}: shape {tuple(shape)} != {tuple(raw.shape)}")
    return set_trainable(model, {k: np.array(v) for k, v in values.items()})
