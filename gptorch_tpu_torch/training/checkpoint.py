"""Checkpointing: save and restore a model's state.

Counterpart of ``gptorch_tpu/training/checkpoint.py``.  :func:`save`
stores every parameter and buffer of a model -- the trainable raws and the
buffers such as X, Y, Z, a streaming model's statistics or ``n_seen`` --
and every tensor a module holds as a plain attribute (a posterior's
factors: a serving posterior's X, L⁻¹ and α), as the JAX package saves
every leaf of the pytree, in one ``.npz`` keyed by dotted names
(``"kernel.variance.raw"``, ``"X"``, ``"Linv"``, ...); the file is the
port's own format (the JAX package keys its leaves by pytree path).  :func:`save_trainable` / :func:`load_trainable` store only
:func:`~gptorch_tpu_torch.module.get_trainable`'s dictionary, whose keys
are the JAX package's: a file written by its ``save_trainable`` loads here.

The loads work in place and return the model.  A tensor whose shape
matches the file's is overwritten in its own storage, so a training step
captured as a CUDA graph (``fit_scan``), which reads fixed addresses,
replays against the loaded values; a tensor of another shape is replaced
by one of the file's shape, in the old tensor's dtype and on its device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..module import Module, get_trainable, set_trainable


def _state(model: Module):
    """(name, owner module, attribute, tensor) of every parameter, buffer
    and tensor held as a plain attribute, a tensor shared by two paths
    listed under each."""
    for prefix, mod in model.named_modules(remove_duplicate=False):
        plain = {attr: t for attr, t in vars(mod).items() if isinstance(t, torch.Tensor)}
        for kind in (mod._parameters, mod._buffers, plain):
            for attr, t in kind.items():
                if t is not None:
                    yield (f"{prefix}.{attr}" if prefix else attr), mod, attr, t


def _read(path: str):
    return np.load(path if path.endswith(".npz") else path + ".npz")


def save(path: str, model: Module) -> None:
    """Save every parameter and buffer of ``model`` to ``path``."""
    np.savez(path, **{name: t.detach().cpu().numpy() for name, _, _, t in _state(model)})


@torch.no_grad()
def load(path: str, model: Module) -> Module:
    """Restore into ``model`` (built the same way) the state saved by
    :func:`save`, in place; returns ``model``.  Raises ``KeyError`` for a
    tensor the file lacks."""
    data = _read(path)
    for name, mod, attr, t in list(_state(model)):
        if name not in data:
            raise KeyError(f"Checkpoint missing leaf {name}")
        value = torch.as_tensor(data[name], dtype=t.dtype, device=t.device)
        if value.shape == t.shape:
            t.copy_(value)
        elif attr in mod._parameters:
            setattr(mod, attr, nn.Parameter(value, requires_grad=t.requires_grad))
        elif attr in mod._buffers:
            mod._buffers[attr] = value
        else:
            setattr(mod, attr, value)
    return model


def save_trainable(path: str, model: Module) -> None:
    """Save the raw value of every trainable Param, keyed by its path."""
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in get_trainable(model).items()})


def load_trainable(path: str, model: Module) -> Module:
    """Restore the raw trainables saved by :func:`save_trainable` (this
    package's or the JAX package's) into ``model``, in place; returns
    ``model``.  Raises ``KeyError`` for a trainable the file lacks."""
    data = _read(path)
    missing = sorted(set(get_trainable(model)) - set(data.files))
    if missing:
        raise KeyError(f"Checkpoint missing leaf {missing[0]}")
    return set_trainable(model, {k: data[k] for k in get_trainable(model)})
