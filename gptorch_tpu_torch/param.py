"""Constrained parameters.

Counterpart of ``gptorch_tpu/param.py``.  A :class:`Param` is an
``nn.Module`` holding one ``nn.Parameter``, ``raw``, in unconstrained space,
plus a bijector that maps it to the constrained value on read and an
optional prior.  ``trainable`` is ``raw.requires_grad``.

The JAX package's functional updates ``with_raw``/``with_value`` return a
new Param and leave the old one as it was; here they do the same (a new
module on the old one's device, its raw a detached copy), so
``model.Xmean = model.Xmean.with_value(x)`` replaces the submodule.
:meth:`Param.set_raw` is the in-place update.
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

    def transform(self) -> torch.Tensor:
        """Reference-API alias for :attr:`value`."""
        return self.value

    @property
    def shape(self):
        return self.raw.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.raw.dtype

    def numel(self) -> int:
        return self.raw.numel()

    @torch.no_grad()
    def set_raw(self, raw):
        """Overwrite the unconstrained value in place (same shape)."""
        raw = torch.as_tensor(raw, dtype=self.raw.dtype, device=self.raw.device)
        if raw.shape != self.raw.shape:
            raise ValueError(f"raw shape {tuple(raw.shape)} != {tuple(self.raw.shape)}")
        self.raw.copy_(raw)

    def with_raw(self, raw) -> "Param":
        """A new Param with this one's bijector, prior and trainability and
        the unconstrained value ``raw`` (any shape); ``self`` is unchanged."""
        raw = torch.as_tensor(raw, device=self.raw.device)
        if not raw.is_floating_point():
            raw = raw.to(self.raw.dtype)
        out = Param(self.bijector.forward(raw.detach()), transform=self.bijector, prior=self.prior,
                    trainable=self.trainable)
        out.set_raw(raw)  # the raw itself: inverse(forward(raw)) may round
        return out

    def with_value(self, value) -> "Param":
        """:meth:`with_raw` at the constrained ``value``."""
        value = torch.as_tensor(value, device=self.raw.device)
        if not value.is_floating_point():
            value = value.to(self.raw.dtype)
        return self.with_raw(self.bijector.inverse(value))

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
