"""Global configuration for gptorch_tpu_torch.

One small, mutable-but-explicit config object, with the same fields as the
JAX package's ``gptorch_tpu/settings.py`` plus the device policy:

* ``positive_bijector`` -- name of the bijector for positive parameters;
  ``"exp"`` matches the reference gptorch exactly.
* dtype policy -- computation runs in :func:`default_float`, which is
  ``torch.get_default_dtype()``: float32 unless the caller (the tests) sets
  float64 with ``torch.set_default_dtype``, the counterpart of JAX's x64 flag.
* jitter policy -- ``"adaptive"`` retries a failed Cholesky with escalating
  absolute jitter ``10**(-max_jitter_tries+i)``; ``"fixed"`` adds one relative
  jitter ``fixed_jitter * mean(diag)``; ``"none"`` factors as is
  (see :mod:`gptorch_tpu_torch.functions`).
* ``device`` -- where entry points put their tensors when the caller names
  no device.  The default is the card; with no card present,
  :func:`resolve_device` raises instead of quietly running on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass
class Config:
    positive_bijector: str = "exp"
    jitter_policy: str = "adaptive"
    fixed_jitter: float = 1e-6
    max_jitter_tries: int = 10
    default_seed: int = 0
    device: str = "cuda"


config = Config()


def default_float() -> torch.dtype:
    """The library-wide default float dtype (``torch.get_default_dtype()``)."""
    return torch.get_default_dtype()


@contextlib.contextmanager
def override(**kwargs):
    """Temporarily override config fields.

    >>> with settings.override(jitter_policy="fixed"):
    ...     ...
    """
    old = {k: getattr(config, k) for k in kwargs}
    try:
        for k, v in kwargs.items():
            if not hasattr(config, k):
                raise AttributeError(f"No config field {k!r}")
            setattr(config, k, v)
        yield config
    finally:
        for k, v in old.items():
            setattr(config, k, v)


def trace_key() -> tuple:
    """The config fields that the factorizations read (the jitter policy
    family).  A cache of a captured or compiled callable that runs
    :func:`gptorch_tpu_torch.functions.cholesky` must key on this tuple."""
    return (
        config.jitter_policy,
        float(config.fixed_jitter),
        int(config.max_jitter_tries),
    )


def next_seed() -> int:
    """A seed for convenience APIs that take no explicit ``torch.Generator``;
    increments ``config.default_seed``."""
    seed = config.default_seed
    config.default_seed += 1
    return seed


def next_default_generator(device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (the CPU if None), seeded from
    :func:`next_seed`: the counterpart of the JAX package's
    ``next_default_key`` for APIs called without an explicit generator
    (a minibatched model's loss).  Explicit generators are preferred; the
    two packages draw different numbers from the same seed."""
    return torch.Generator(device=device if device is not None else "cpu").manual_seed(next_seed())


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else
    ``config.device``.

    A CUDA device with no card present raises ``RuntimeError`` -- nothing
    falls back to the CPU silently.  On the card, float32 matrix products
    and convolutions are pinned to full float32:
    ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False`` (TF32 keeps about three
    decimal digits, too few for Cholesky factors of a Gram matrix).
    """
    dev = torch.device(device if device is not None else config.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA card is available; "
                "pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
