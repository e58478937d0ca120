"""GPEnsemble: a batch of independent exact GPs trained as one program.

Counterpart of ``gptorch_tpu/models/ensemble.py``: per-entity forecasting
(one small GP per sensor, SKU or cell line), per-output independent GPs and
random-restart hyperparameter optimisation, without a Python loop over
models.

A member is one :class:`~gptorch_tpu_torch.models.gpr.GPR` whose Params
and buffers carry a leading B axis; ``torch.func.vmap`` over
``torch.func.functional_call`` turns the member's loss and predictions into
fleet-wide ones, as the JAX package ``vmap``s its member pytree.  On the
card the member's Rbf Gram goes through K1's ``vmap`` rule, one launch for
the fleet's B Grams (:mod:`~gptorch_tpu_torch.ops.gram`), and the adaptive
jitter probes the fleet's B matrices together, one host read per level
tried (:func:`~gptorch_tpu_torch.functions.cholesky`).  The fleet's loss is
the sum of the members' losses: the members share no parameter, so its
gradient is each member's own, and the trainers
(:func:`~gptorch_tpu_torch.training.fit.fit_scan`, ``fit_torch``) take the
fleet as they take any model.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Optional

import numpy as np
import torch
from torch.func import vmap

from .. import settings
from ..module import Module, call_with_parameters
from ..util import as_array
from .gpr import GPR


class GPEnsemble(Module):
    """B independent exact GPs over batched data.

    :param x: (B, n, d) inputs; every member sees the same n.
    :param y: (B, n, dy) targets.
    :param kernel: the per-member template; its hyperparameters are
        broadcast to a leading B axis and train independently per member
        (:meth:`diversify` spreads the starts).
    :param likelihood: optional template likelihood.  Default: Gaussian with
        σ² = 0.001·var(y) per member.
    :param gpr_kwargs: forwarded to the member :class:`GPR` (``objective``,
        ``device``, ...).  Members run the generic dense path: ``fast=False``
        is forced and another solver raises.
    """

    def __init__(self, x, y, kernel, likelihood=None, mean_function=None, name: str = "ensemble", **gpr_kwargs):
        super().__init__()
        x = x if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y if isinstance(y, torch.Tensor) else np.asarray(y)
        if x.ndim != 3 or y.ndim != 3:
            raise ValueError(
                f"GPEnsemble takes batched data: x (B, n, d), y (B, n, dy); got x{tuple(x.shape)}, y{tuple(y.shape)}"
            )
        if tuple(x.shape[:2]) != tuple(y.shape[:2]):
            raise ValueError("x and y must agree on (B, n).")
        if gpr_kwargs.get("solver", "dense") != "dense":
            raise ValueError(
                "GPEnsemble members run the dense path (the matrix-free solver targets single large-n models)"
            )
        gpr_kwargs["fast"] = False
        b = x.shape[0]
        member = GPR(x[0], y[0], kernel, likelihood=likelihood, mean_function=mean_function, name=name + "_member",
                     **gpr_kwargs)
        x = as_array(x, dtype=member.X.dtype, device=member.device)
        y = as_array(y, dtype=member.Y.dtype, device=member.device)
        # every Param and buffer gets the leading B axis
        for path, p in list(member.named_params()):
            parent, _, attr = path.rpartition(".")
            setattr(member.get_submodule(parent), attr, p.with_raw(p.raw.detach().expand((b,) + p.shape).clone()))
        for mod in member.modules():
            for attr, buf in list(mod._buffers.items()):
                if buf is not None:
                    mod._buffers[attr] = buf.expand((b,) + buf.shape).clone()
        if likelihood is None:
            # the default noise of each member's own data, one value per member
            # (raw shape (B,), as the JAX package builds it)
            p = member.likelihood.variance
            var_b = torch.clamp(torch.var(y, dim=(1, 2), unbiased=False), min=torch.finfo(y.dtype).tiny)
            member.likelihood.variance = p.with_raw(p.bijector.inverse(0.001 * var_b))
        member.X, member.Y = x, y
        self.member = member
        self.name = name

    # -- basic properties ----------------------------------------------------

    @property
    def num_members(self) -> int:
        return self.member.X.shape[0]

    @property
    def num_data(self) -> int:
        return self.member.X.shape[1]

    @property
    def X(self) -> torch.Tensor:
        return self.member.X

    @property
    def Y(self) -> torch.Tensor:
        return self.member.Y

    @property
    def device(self) -> torch.device:
        return self.member.X.device

    def _reads_jitter_policy(self) -> bool:
        """The members' generic path factors through ``functions.cholesky``."""
        return True

    def _capturable(self) -> bool:
        return True

    # -- the members, mapped -----------------------------------------------------

    def _map(self, method, *args, **kwargs):
        """``member_i.<method>(*args_i, **kwargs)`` for every member i,
        stacked on a leading axis: ``torch.func.vmap`` over the member's
        Params and buffers (and over ``args``, each batched on its first
        axis), each call through ``torch.func.functional_call``."""
        state = dict(self.member.named_parameters())
        state.update(self.member.named_buffers())
        return vmap(lambda s, *a: call_with_parameters(self.member, s, method, *a, **kwargs))(state, *args)

    def _batched_inputs(self, input_new):
        input_new = torch.as_tensor(input_new, dtype=self.X.dtype, device=self.device)
        if input_new.ndim == 2:  # shared query points
            input_new = input_new[None].expand((self.num_members,) + tuple(input_new.shape))
        if input_new.ndim != 3 or input_new.shape[0] != self.num_members:
            raise ValueError(
                f"expected (m, d) or (B={self.num_members}, m, d) query points; got {tuple(input_new.shape)}"
            )
        return input_new

    # -- initialization spread (random restarts) ----------------------------------

    def diversify(self, generator: Optional[torch.Generator] = None, scale: float = 0.5) -> "GPEnsemble":
        """A copy whose members' trainable raws are perturbed by independent
        N(0, scale²) draws in unconstrained space, drawn from ``generator``
        (default :func:`~gptorch_tpu_torch.settings.next_default_generator`
        on the fleet's device) in the order of the trainable paths; member
        0 keeps its start.  Each Param is rebuilt by ``with_raw``."""
        if generator is None:
            generator = settings.next_default_generator(self.device)
        out = copy.deepcopy(self)
        for path, p in list(out.member.named_params()):
            if not p.trainable:
                continue
            eps = scale * torch.randn(p.shape, generator=generator, dtype=p.dtype, device=p.raw.device)
            eps[0] = 0.0
            parent, _, attr = path.rpartition(".")
            setattr(out.member.get_submodule(parent), attr, p.with_raw(p.raw.detach() + eps))
        return out

    # -- loss ------------------------------------------------------------------

    def losses(self, generator=None):
        """(B,) per-member losses (NLML or LOO per the member objective);
        ``generator`` is accepted for the common signature and unused (the
        members draw nothing)."""
        return self._map("_loss")

    def log_likelihood(self, x=None, y=None, generator=None):
        if x is not None or y is not None:
            raise ValueError("GPEnsemble trains on its constructor data (minibatch the members' rows upstream if needed)")
        return -torch.sum(self.losses(generator=generator))

    def _loss(self, x=None, y=None, generator=None):
        """The sum of the members' losses."""
        if x is not None or y is not None:
            raise ValueError("GPEnsemble trains on its constructor data (minibatch the members' rows upstream if needed)")
        return torch.sum(self.losses(generator=generator))

    def loss(self, generator=None):
        """:meth:`_loss`; a non-finite value raises ``FloatingPointError``."""
        out = self._loss(generator=generator)
        if not bool(torch.isfinite(out)):
            from ..training.fit import _nonfinite_loss_error

            raise _nonfinite_loss_error()
        return out

    # -- training -------------------------------------------------------------

    def fit(self, method: str = "Adam", max_iter: int = 500, learning_rate: Optional[float] = None,
            generator: Optional[torch.Generator] = None, scan: bool = True):
        """Train every member in place; returns the fleet loss per iteration
        (``scan=True``: :func:`~gptorch_tpu_torch.training.fit.fit_scan`, a
        tensor on the fleet's device; else ``fit_torch``, a numpy array)."""
        from ..training import fit as _fit

        if scan:
            return _fit.fit_scan(self, method=method, max_iter=max_iter, learning_rate=learning_rate,
                                 generator=generator)[1]
        return _fit.fit_torch(self, method=method, max_iter=max_iter, learning_rate=learning_rate,
                              generator=generator, verbose=False)[1]

    # -- member access -----------------------------------------------------------

    def member_at(self, i: int) -> GPR:
        """Member ``i`` as a standalone GPR (its own copy of every Param and
        buffer), with the full single-model API."""
        b = self.num_members
        if not -b <= i < b:
            raise IndexError(f"member {i} out of range for B={b}")
        out = copy.deepcopy(self.member)
        for path, p in list(out.named_params()):
            parent, _, attr = path.rpartition(".")
            setattr(out.get_submodule(parent), attr, p.with_raw(p.raw.detach()[i]))
        for mod in out.modules():
            for attr, buf in list(mod._buffers.items()):
                if buf is not None:
                    mod._buffers[attr] = buf[i].clone()
        return out

    def best(self, generator=None):
        """(best member as a GPR, its index): the member with the lowest
        loss, the random-restart selection step."""
        with torch.no_grad():
            idx = int(torch.argmin(self.losses(generator=generator)))
        return self.member_at(idx), idx

    # -- prediction -----------------------------------------------------------

    def predict_f(self, input_new, diag: bool = True):
        """Latent posterior moments for every member: mean (B, m, dy) and var
        (B, m, dy) (or covariance (B, m, m) with ``diag=False``).
        ``input_new`` is (m, d) (shared) or (B, m, d); numpy in, numpy out."""
        return self._predict_call("_predict", input_new, diag=diag)

    def predict_y(self, input_new, diag: bool = True):
        """Observation posterior moments per member (the likelihood's noise
        added)."""
        return self._predict_call("_predict_y", input_new, diag=diag)

    def predict_log_density(self, input_new, y_new):
        """Held-out log predictive density per member: (B, m, dy)."""
        y_new = torch.as_tensor(np.asarray(y_new) if not isinstance(y_new, torch.Tensor) else y_new,
                                dtype=self.Y.dtype, device=self.device)
        if y_new.ndim == 2:
            y_new = y_new[None].expand((self.num_members,) + tuple(y_new.shape))
        return self._predict_call("predict_log_density", input_new, y_new)

    def _predict_call(self, method, input_new, *args, **kwargs):
        from_numpy = isinstance(input_new, np.ndarray)
        xb = self._batched_inputs(input_new)
        with torch.no_grad() if from_numpy else contextlib.nullcontext():
            out = self._map(method, xb, *args, **kwargs)
        if not from_numpy:
            return out
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy() for o in out)
        return out.cpu().numpy()

    def __repr__(self):
        return f"GPEnsemble(B={self.num_members}, n={self.num_data}, member={type(self.member).__name__})"
