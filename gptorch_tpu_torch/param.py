"""Constrained parameters.

Counterpart of ``gptorch_tpu/param.py``.  A :class:`Param` is an
``nn.Module`` holding one ``nn.Parameter``, ``raw``, in unconstrained space,
plus a bijector that maps it to the constrained value on read and an
optional prior.  ``trainable`` is ``raw.requires_grad``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from . import bijectors as _bij
from . import settings


class Param(nn.Module):
    """A (possibly constrained) parameter.

    :param value: initial *constrained* value (array-like or tensor).
    :param transform: a :class:`~gptorch_tpu_torch.bijectors.Bijector`;
        defaults to Identity.
    :param prior: optional :class:`~gptorch_tpu_torch.priors.Prior`.
    :param trainable: if False the raw value does not require grad.
    """

    def __init__(
        self,
        value: Any,
        transform: Optional[_bij.Bijector] = None,
        prior=None,
        trainable: bool = True,
    ):
        super().__init__()
        self.bijector = transform if transform is not None else _bij.Identity()
        self.prior = prior
        value = torch.as_tensor(value, dtype=_param_dtype(value))
        raw = self.bijector.inverse(value).detach().clone()
        self.raw = nn.Parameter(raw, requires_grad=bool(trainable))

    @property
    def value(self) -> torch.Tensor:
        """The constrained value."""
        return self.bijector.forward(self.raw)

    @property
    def trainable(self) -> bool:
        return self.raw.requires_grad

    @trainable.setter
    def trainable(self, flag: bool):
        self.raw.requires_grad_(bool(flag))

    @property
    def shape(self):
        return self.raw.shape

    @torch.no_grad()
    def set_raw(self, raw):
        """Overwrite the unconstrained value in place (same shape)."""
        raw = torch.as_tensor(raw, dtype=self.raw.dtype, device=self.raw.device)
        if raw.shape != self.raw.shape:
            raise ValueError(f"raw shape {tuple(raw.shape)} != {tuple(self.raw.shape)}")
        self.raw.copy_(raw)

    def extra_repr(self):
        return f"value={self.value.detach()}, bijector={self.bijector!r}, trainable={self.trainable}"


def _param_dtype(value):
    """Floating tensors keep their dtype; everything else takes the library
    default float."""
    if isinstance(value, torch.Tensor) and value.is_floating_point():
        return value.dtype
    return settings.default_float()


def positive_param(value, prior=None, trainable: bool = True) -> Param:
    """A Param constrained positive by the configured default bijector."""
    return Param(value, transform=_bij.positive(), prior=prior, trainable=trainable)
