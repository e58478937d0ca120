"""The module base and the flat named views of its parameters.

Counterpart of ``gptorch_tpu/module.py``.  :class:`Module` is an
``nn.Module``; its :class:`~gptorch_tpu_torch.param.Param` children are
found by :meth:`Module.named_params` under the same dotted paths the JAX
package uses (``"kernel.variance"``, ``"likelihood.variance"``, ...), so
:func:`get_trainable` dictionaries of the two packages share their keys.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Iterator, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from . import settings
from .param import Param


class Module(nn.Module):
    """Base class of kernels, likelihoods, mean functions and models."""

    def named_params(self) -> Iterator[Tuple[str, Param]]:
        """Yield (dotted_path, Param) pairs in registration order.  A Param
        shared by two children is yielded under both paths, as in the JAX
        package."""
        for path, mod in self.named_modules(remove_duplicate=False):
            if isinstance(mod, Param):
                yield path, mod

    def log_prior(self) -> torch.Tensor:
        """Sum of prior log-probs over the Params that carry a prior,
        evaluated on the constrained value with no Jacobian term (the
        reference gptorch's convention)."""
        first = next(self.parameters(), None)
        device = first.device if first is not None else None
        total = torch.zeros((), dtype=settings.default_float(), device=device)
        for _, p in self.named_params():
            if p.prior is not None:
                total = total + torch.sum(p.prior.log_prob(p.value))
        return total

    def gradcheck(self, eps=1e-6, atol=1e-5, rtol=1e-3, order=1) -> bool:
        """Finite-difference check of the gradient of ``_loss`` in the
        trainable raw values: ``torch.autograd.gradcheck`` (and, for
        ``order=2``, ``gradgradcheck``) on a float64 copy, the loss
        evaluated through :func:`call_with_trainable`.  Returns True or
        raises ``torch.autograd.gradcheck.GradcheckError``."""
        model = copy.deepcopy(self).to(torch.float64)
        values = get_trainable(model)
        keys = list(values)
        inputs = tuple(values[k].detach().clone().requires_grad_() for k in keys)

        def loss(*raws):
            return call_with_trainable(model, dict(zip(keys, raws)), "_loss")

        torch.autograd.gradcheck(loss, inputs, eps=eps, atol=atol, rtol=rtol)
        if order >= 2:
            torch.autograd.gradgradcheck(loss, inputs, eps=eps, atol=atol, rtol=rtol)
        return True


def get_trainable(module: Module) -> Dict[str, torch.Tensor]:
    """The raw (unconstrained) ``nn.Parameter`` of every trainable Param,
    keyed by dotted path."""
    return {path: p.raw for path, p in module.named_params() if p.trainable}


def trainable_parameters(*modules: nn.Module) -> List[nn.Parameter]:
    """Every ``nn.Parameter`` of ``modules`` that requires grad, each once
    (one shared by two paths or two modules counts once): the raw values
    of the trainable Params, and any plain parameter a module holds.  What
    an optimizer or ``torch.autograd.grad`` takes."""
    return list({id(p): p for m in modules for p in m.parameters() if p.requires_grad}.values())


def set_trainable(module: Module, values: Dict[str, torch.Tensor]) -> Module:
    """In-place inverse of :func:`get_trainable`: overwrite the raw value of
    each trainable Param whose path is in ``values``.  Returns ``module``."""
    for path, p in module.named_params():
        if p.trainable and path in values:
            p.set_raw(values[path])
    return module


def with_trainable(module: Module, values: Mapping[str, torch.Tensor]) -> Module:
    """A copy of ``module`` with the raw value of each trainable Param whose
    path is in ``values`` replaced (the copying counterpart of
    :func:`set_trainable`); ``module`` does not change."""
    return set_trainable(copy.deepcopy(module), values)


def tree_map_params(fn: Callable, module: Module) -> Module:
    """A copy of ``module`` with every Param ``p`` (of the copy) replaced by
    ``fn(p)``; ``module`` does not change."""
    out = copy.deepcopy(module)
    for path, p in list(out.named_params()):
        parent, _, name = path.rpartition(".")
        setattr(out.get_submodule(parent), name, fn(p))
    return out


class _Bound(nn.Module):
    """A method of a module as a module call, so that ``functional_call``
    can stand tensors in for the module's parameters."""

    def __init__(self, module, method: str):
        super().__init__()
        self.module = module
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.module, self.method)(*args, **kwargs)


def call_with_parameters(module: nn.Module, tensors: Mapping[str, torch.Tensor], method: str, *args, **kwargs):
    """``module.<method>(*args, **kwargs)`` with the ``nn.Parameter``s named
    in ``tensors`` (names as ``module.named_parameters()`` gives them)
    replaced by those tensors, through ``torch.func.functional_call``."""
    swap = {f"module.{name}": t for name, t in tensors.items()}
    return functional_call(_Bound(module, method), swap, args, kwargs)


def call_with_trainable(module: Module, values: Mapping[str, torch.Tensor], method: str, *args, **kwargs):
    """``module.<method>(*args, **kwargs)`` evaluated with the raw value of
    each trainable Param whose path is in ``values`` replaced by that
    tensor (``torch.func.functional_call``): the result is differentiable
    in the given tensors, and ``module`` does not change.  Values that are
    not tensors are converted to the raw value's dtype and device."""
    swap = {}
    for path, p in module.named_params():
        if p.trainable and path in values:
            v = values[path]
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v), dtype=p.raw.dtype, device=p.raw.device)
            swap[f"{path}.raw"] = v
    return call_with_parameters(module, swap, method, *args, **kwargs)


def pack_vector(values: Dict[str, torch.Tensor]) -> np.ndarray:
    """Flatten a trainable dict to one float64 numpy vector, sorted by key."""
    if not values:
        return np.zeros((0,), dtype=np.float64)
    return np.concatenate(
        [
            np.asarray(torch.as_tensor(values[k]).detach().cpu(), dtype=np.float64).ravel()
            for k in sorted(values)
        ]
    )


def unpack_vector(vector: np.ndarray, like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pack_vector`: tensors shaped, typed and placed like
    the entries of ``like``."""
    out = {}
    idx = 0
    for k in sorted(like):
        template = like[k]
        size = template.numel()
        chunk = np.asarray(vector[idx : idx + size]).reshape(tuple(template.shape))
        out[k] = torch.as_tensor(chunk, dtype=template.dtype, device=template.device)
        idx += size
    return out
