"""Fully-Bayesian hyperparameter inference: HMC / NUTS over unconstrained
space, and elliptical slice sampling of latent functions.

Counterpart of ``gptorch_tpu/mcmc.py``.  The reference attaches priors to
parameters but only uses them for MAP fitting; this module samples the
hyperparameter *posterior* with Hamiltonian Monte Carlo and averages
predictions over it.

The target density on the *unconstrained* raw values (the coordinates the
optimizers use) is

    log pi(raw) = log_likelihood(constrained) + log_prior(constrained)
                + sum_p log|d constrained_p / d raw_p|

(the reference's Jacobian-free prior convention plus the change-of-variables
correction; ``jacobian=False`` samples the literal uncorrected density).

Design on the card.  The chains are one state of shape (chains, dim), the
chains leading.  All chains' log densities are one ``torch.func.vmap`` of
the single-chain density (for a model, ``call_with_trainable`` of its
``_loss``: K1's batched launch on the generic path, the fused losses'
``vmap`` rules on the fused one), and their gradients one
``torch.autograd.grad`` of the sum (the chains share no parameter, so each
row is its chain's own gradient).  A sampler's steps write into the state
tensors in place, so that each step can be captured once as a CUDA graph
and replayed: an HMC transition (momentum draw, leapfrogs, accept/reject,
adaptation) is one graph replayed ``num_iters`` times with no host read; a
NUTS transition reads one flag per doubling ("does any chain still build")
and one per chunk of ``NUTS_CHUNK`` leapfrogs past the first; an elliptical
slice transition reads one flag per chunk of ``ESS_CHUNK`` shrinks.  Chains
that have stopped are frozen by ``torch.where``: each chain ends exactly as
if it ran alone (every chain waits for the slowest, as under the JAX
package's ``vmap`` of a ``while_loop``).  Steps are captured on the card
where :func:`captures` says so, and run eagerly otherwise.

Draws come from one ``torch.Generator`` through :func:`sampling.uniform`
and :func:`sampling.standard_normal`, a whole tensor at fixed points, so a
test can feed the JAX package's draws in:

* HMC, per transition: the step-size jitter (chains,), the momentum
  (chains, dim), the accept uniform (chains,);
* NUTS, per transition the momentum (chains, dim); per doubling of depth d
  the direction uniform (chains,) (right below 0.5), the biased-progressive
  uniform (chains,) and the leaf uniforms (2^d, chains);
* elliptical slice, per transition ξ (f's shape), the slice uniform and the
  first angle's uniform (both 0-d); then ``ESS_CHUNK`` uniforms per chunk.

The two packages draw different numbers from the same seed.  Flat vectors
order a dict's entries by sorted key, as JAX's ``ravel_pytree`` does.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from . import ops, sampling, settings
from .functions import add_diag, cholesky, trtrs
from .module import call_with_trainable, get_trainable

__all__ = [
    "log_posterior_fn",
    "hmc",
    "nuts",
    "sample_posterior",
    "predict_mixture",
    "elliptical_slice",
    "latent_prior_chol",
    "sample_latent",
    "predict_latent_mixture",
    "potential_scale_reduction",
    "effective_sample_size",
    "HMCResult",
]

#: Leapfrogs of one captured NUTS chunk (a doubling of 2^d < NUTS_CHUNK
#: leaves runs as one chunk of 2^d).
NUTS_CHUNK = 8

#: Shrinks of one captured elliptical-slice chunk.
ESS_CHUNK = 8

#: Dual averaging's constants (Hoffman & Gelman 2014, Alg. 5).
_GAMMA, _T0, _KAPPA = 0.05, 10.0, 0.75


class HMCResult(NamedTuple):
    """Chain output. ``samples`` has a leading (num_chains?, num_samples)
    axis; ``accept_prob`` / ``divergent`` align with it."""

    samples: torch.Tensor  # (..., num_samples, dim) flat unconstrained draws
    accept_prob: torch.Tensor  # (..., num_samples)
    divergent: torch.Tensor  # (..., num_samples) bool
    step_size: torch.Tensor  # (...,) adapted step size
    inv_mass: torch.Tensor  # (..., dim) adapted diagonal inverse mass
    tree_depth: Optional[torch.Tensor] = None  # (..., num_samples) NUTS only;
    # values pinned at max_depth mean trajectories are being truncated --
    # each such transition costs up to 2^max_depth gradient evaluations,
    # and every chain pays the slowest chain's doublings.


# ---------------------------------------------------------------------------
# flat vectors, the target density and its batched gradient


def _ravel(tree, device):
    """(flat 1-D tensor, unravel) of a tensor / array or a dict of them,
    the dict's entries in sorted key order; ``unravel`` restores the shapes
    (and works on a ``vmap``-ped vector)."""
    is_dict = isinstance(tree, dict)
    items = sorted(tree.items()) if is_dict else [(None, tree)]
    leaves = []
    for _, v in items:
        t = torch.as_tensor(v.detach() if isinstance(v, torch.Tensor) else np.asarray(v), device=device)
        leaves.append(t if t.is_floating_point() else t.to(settings.default_float()))
    shapes = [tuple(t.shape) for t in leaves]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([t.reshape(-1) for t in leaves]) if leaves else torch.zeros(0, device=device)

    def unravel(q):
        parts, start = [], 0
        for shape, size in zip(shapes, sizes):
            parts.append(q[..., start : start + size].reshape(q.shape[:-1] + shape))
            start += size
        if not is_dict:
            return parts[0]
        return {k: part for (k, _), part in zip(items, parts)}

    return flat, unravel


def _trainable_bijectors(model):
    return {name: p.bijector for name, p in model.named_params() if p.trainable}


def log_posterior_fn(model, jacobian: bool = True) -> Callable:
    """Return ``logpi(values_dict) -> scalar`` for a model's trainables.

    ``-model._loss()`` (through :func:`~gptorch_tpu_torch.module.call_with_trainable`)
    is log_likelihood + log_prior; with ``jacobian=True`` (default) the
    bijector log-det of every trainable parameter is added so the density
    is the correct pushforward onto unconstrained coordinates.
    ``logpi.reads_host()`` says whether the model's loss reads the host
    under the current settings (:func:`hmc` and :func:`nuts` then run
    eagerly).
    """
    bijectors = _trainable_bijectors(model)

    def logpi(values: Dict[str, torch.Tensor]):
        out = torch.reshape(-call_with_trainable(model, values, "_loss"), ())
        if jacobian:
            for name, bij in bijectors.items():
                out = out + torch.sum(bij.forward_log_det_jacobian(torch.as_tensor(values[name])))
        return out

    logpi.reads_host = lambda: _model_reads_host(model)
    return logpi


def _batched_value_and_grad(logdensity_flat):
    """(chains, dim) -> (log densities (chains,), gradients (chains, dim)):
    one ``torch.func.vmap`` of the single-chain density and one
    ``torch.autograd.grad`` of the sum."""
    mapped = torch.func.vmap(logdensity_flat)

    def value_and_grad(q):
        with torch.enable_grad():
            q = q.detach().requires_grad_(True)
            logp = mapped(q)
            (grad,) = torch.autograd.grad(torch.sum(logp), q, allow_unused=True)
        return logp.detach(), torch.zeros_like(q) if grad is None else grad

    return value_and_grad


# ---------------------------------------------------------------------------
# running steps: eagerly, or captured once and replayed


def captures(device, reads_host: bool = False) -> bool:
    """Whether the samplers capture their steps as CUDA graphs: on the card,
    unless the density reads the host (``reads_host``; for a model, the
    ``adaptive`` jitter policy when its loss factors through
    :func:`~gptorch_tpu_torch.functions.cholesky`, or a loss with a host
    read of its own: training/fit.py's rule)."""
    return torch.device(device).type == "cuda" and not reads_host


def _model_reads_host(model) -> bool:
    """training/fit.py's rule for a GP model; a module that is not one (a
    prior alone) reads nothing."""
    if not getattr(model, "_capturable", lambda: True)():
        return True
    reads_policy = getattr(model, "_reads_jitter_policy", lambda: False)()
    return settings.config.jitter_policy == "adaptive" and reads_policy


class _Runner:
    """Runs a sampler's steps on its state tensors, each by a key: eagerly,
    or (``capture``) the first time a key runs, eagerly on a side stream and
    then captured as a CUDA graph that every later call replays.  The
    graphs draw from a private generator registered with them; entering
    the runner copies the caller's generator state into it, leaving copies
    it back (so the draws are the eager run's) and frees the graphs.
    ``reads`` counts the sampler's host reads, ``calls`` each key's runs;
    ``launches`` the kernel launches each graph recorded, ``replays`` its
    replays."""

    def __init__(self, device, generator, capture: bool):
        self.device = torch.device(device)
        self.capture = bool(capture)
        if generator is None:
            generator = settings.next_default_generator(self.device)
        self.caller = generator
        self.generator = torch.Generator(device=self.device) if self.capture else generator
        self.graphs, self.launches = {}, {}
        self.calls, self.replays = collections.Counter(), collections.Counter()
        self.reads = 0
        self.shrinks = None  # elliptical_slice: each transition's shrinks

    def __enter__(self):
        if self.capture:
            self.generator.set_state(self.caller.get_state())
        return self

    def __exit__(self, *exc):
        if self.capture:
            self.caller.set_state(self.generator.get_state())
        self.graphs = {}

    def __call__(self, key, fn):
        self.calls[key] += 1
        if not self.capture:
            fn()
            return
        graph = self.graphs.get(key)
        if graph is not None:
            graph.replay()
            self.replays[key] += 1
            return
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = ops.launch_counts()
        with torch.cuda.graph(graph):
            fn()
        after = ops.launch_counts()
        self.launches[key] = {k: after[k] - before[k] for k in after}
        self.graphs[key] = graph

    def read(self, flag) -> bool:
        """``flag`` (a device bool) on the host, counted."""
        self.reads += 1
        return bool(flag)

    def replayed_launches(self) -> dict:
        """Kernel launches of the replays: each graph's recorded launches
        times its replays."""
        out = dict.fromkeys(ops.launch_counts(), 0)
        for key, n in self.replays.items():
            for k, v in self.launches[key].items():
                out[k] += v * n
        return out


# ---------------------------------------------------------------------------
# HMC and NUTS on a (chains, dim) state


def _kinetic(p, inv_mass):
    return 0.5 * torch.sum(p * p * inv_mass, dim=-1)


def _is_turning(p_sum, p_a, p_b, inv_mass):
    """Generalized U-turn test over a trajectory interval: the interval's
    momentum sum projected on either edge velocity is negative."""
    return (torch.sum(p_sum * (inv_mass * p_a), dim=-1) < 0.0) | (torch.sum(p_sum * (inv_mass * p_b), dim=-1) < 0.0)


def _popcount(n):
    """Set-bit count of each entry of an integer tensor (leaf indices < 2^15)."""
    bits = torch.arange(16, device=n.device)
    return torch.sum((n[..., None] >> bits) & 1, dim=-1)


def _trailing_ones(n):
    """Number of consecutive low 1-bits: popcount of n & ~(n+1)."""
    return _popcount(n & ~(n + 1))


def _where(cond, new, old):
    """``new`` where ``cond`` (per chain, broadcast over trailing axes)."""
    return torch.where(cond.reshape(cond.shape + (1,) * (new.ndim - cond.ndim)), new, old)


class _Chains:
    """The chains' state, (chains, dim), and the steps of their HMC and NUTS
    transitions.  Every step writes its results into the state tensors in
    place, so a graph captured from it reads and writes the same memory at
    every replay."""

    def __init__(self, value_and_grad, q0, runner, target_accept, max_depth=1):
        c, dim = q0.shape
        dt, dev = q0.dtype, q0.device
        self.vg, self.runner, self.target = value_and_grad, runner, float(target_accept)
        self.max_depth = int(max_depth)
        self.q = q0.detach().clone()
        logp, grad = value_and_grad(self.q)
        self.logp, self.grad = logp.clone(), grad.clone()
        zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
        falses = lambda *shape: torch.zeros(shape, dtype=torch.bool, device=dev)  # noqa: E731
        self.inv_mass = torch.ones((c, dim), dtype=dt, device=dev)
        # dual averaging and Welford moments; count and n are shared by the chains
        self.mu, self.log_eps, self.log_eps_bar, self.h_bar = zeros(c), zeros(c), zeros(c), zeros(c)
        self.count, self.n = zeros(), zeros()
        self.mean, self.m2 = zeros(c, dim), zeros(c, dim)
        self.index = torch.zeros((), dtype=torch.long, device=dev)  # the next recorded draw
        # NUTS: the transition, the doubling and the subtree being built
        m = self.max_depth
        self.p0, self.h0, self.eps = zeros(c, dim), zeros(c), zeros(c)
        self.depth = torch.zeros(c, dtype=torch.long, device=dev)
        self.turning, self.divergent, self.building, self.go_right = falses(c), falses(c), falses(c), falses(c)
        self.edges = {k: zeros(c, dim) for k in ("ql", "pl", "gl", "qr", "pr", "gr", "psum", "zq", "zgrad")}
        self.edges.update({k: zeros(c) for k in ("lpl", "lpr", "zlogp", "logw", "sum_acc", "n_leaves")})
        self.sub = {k: zeros(c, dim) for k in ("q", "p", "grad", "psum", "zq", "zgrad")}
        self.sub.update({k: zeros(c) for k in ("logp", "zlogp", "logw", "sum_acc", "n")})
        self.sub.update({k: falses(c) for k in ("turning", "divergent")})
        self.sub.update(ckpt_p=zeros(c, m, dim), ckpt_s=zeros(c, m, dim))
        self.eps_signed, self.u_bias = zeros(c), zeros(c)
        self.u_leaf = zeros(2 ** (m - 1), c)
        self.leaf = torch.zeros((), dtype=torch.long, device=dev)
        self.more = falses()  # some chain builds on (a doubling) / in its subtree (a chunk)

    # -- phases -------------------------------------------------------------

    def start_phase(self, eps0, inv_mass):
        """Dual averaging from step size ``eps0`` (chains,) and fresh Welford
        moments, under the diagonal inverse mass ``inv_mass``."""
        log_eps0 = torch.log(eps0)
        self.mu.copy_(torch.log(10.0 * eps0))
        self.log_eps.copy_(log_eps0)
        self.log_eps_bar.copy_(log_eps0)
        for t in (self.h_bar, self.count, self.mean, self.m2, self.n, self.index):
            t.zero_()
        self.inv_mass.copy_(inv_mass)

    def adapted(self):
        """(step size exp(log ε̄), Welford variance) of the phase so far."""
        return torch.exp(self.log_eps_bar), self.m2 / torch.clamp(self.n - 1.0, min=1.0)

    def _adapt(self, accept_stat):
        count = self.count + 1.0
        h_bar = (1.0 - 1.0 / (count + _T0)) * self.h_bar + (self.target - accept_stat) / (count + _T0)
        log_eps = self.mu - torch.sqrt(count) / _GAMMA * h_bar
        w = count ** -_KAPPA
        self.log_eps_bar.copy_(w * log_eps + (1.0 - w) * self.log_eps_bar)
        self.log_eps.copy_(log_eps)
        self.h_bar.copy_(h_bar)
        self.count.copy_(count)
        n = self.n + 1.0
        delta = self.q - self.mean
        self.mean.add_(delta / n)
        self.m2.add_(delta * (self.q - self.mean))
        self.n.copy_(n)

    def _record(self, out, values):
        for buf, v in zip(out, values):
            buf.index_copy_(0, self.index.reshape(1), v[None])
        self.index.add_(1)

    def _leapfrog(self, q, p, grad, eps):
        e = eps[:, None]
        p = p + 0.5 * e * grad
        q = q + e * self.inv_mass * p
        logp, grad = self.vg(q)
        return q, p + 0.5 * e * grad, grad, logp

    # -- HMC ----------------------------------------------------------------

    def hmc_transition(self, num_leapfrog, adapt, out=None):
        gen, q = self.runner.generator, self.q
        c, dim = q.shape
        eps = torch.exp(self.log_eps)
        # jitter the trajectory length +-20% to break resonances
        eps = eps * (0.8 + 0.4 * sampling.uniform(gen, (c,), q))
        p0 = sampling.standard_normal(gen, (c, dim), q) / torch.sqrt(self.inv_mass)
        h0 = -self.logp + _kinetic(p0, self.inv_mass)
        q1, p1, grad1, logp1 = q, p0, self.grad, self.logp
        for _ in range(num_leapfrog):
            q1, p1, grad1, logp1 = self._leapfrog(q1, p1, grad1, eps)
        delta_h = h0 - (-logp1 + _kinetic(p1, self.inv_mass))
        divergent = ~torch.isfinite(delta_h) | (delta_h < -1000.0)
        accept_prob = torch.where(
            divergent, 0.0, torch.clamp(torch.exp(torch.clamp(delta_h, max=0.0)), max=1.0)
        )
        accept = sampling.uniform(gen, (c,), q) < accept_prob
        self.q.copy_(_where(accept, q1, q))
        self.logp.copy_(torch.where(accept, logp1, self.logp))
        self.grad.copy_(_where(accept, grad1, self.grad))
        if adapt:
            self._adapt(accept_prob)
        if out is not None:
            self._record(out, (self.q, accept_prob, divergent))

    def hmc_phase(self, num_iters, num_leapfrog, adapt, out=None):
        for _ in range(num_iters):
            self.runner(("hmc", num_leapfrog, adapt, out is not None),
                        lambda: self.hmc_transition(num_leapfrog, adapt, out))

    # -- NUTS ---------------------------------------------------------------

    def _nuts_start(self):
        gen, q, e = self.runner.generator, self.q, self.edges
        p0 = sampling.standard_normal(gen, q.shape, q) / torch.sqrt(self.inv_mass)
        self.p0.copy_(p0)
        self.h0.copy_(-self.logp + _kinetic(p0, self.inv_mass))
        self.eps.copy_(torch.exp(self.log_eps))
        for t in (self.depth, self.turning, self.divergent):
            t.zero_()
        for side in "lr":
            e["q" + side].copy_(q)
            e["p" + side].copy_(p0)
            e["g" + side].copy_(self.grad)
            e["lp" + side].copy_(self.logp)
        e["psum"].copy_(p0)
        e["zq"].copy_(q)
        e["zlogp"].copy_(self.logp)
        e["zgrad"].copy_(self.grad)
        for k in ("logw", "sum_acc", "n_leaves"):
            e[k].zero_()

    def _doubling_start(self, depth):
        gen, e, s = self.runner.generator, self.edges, self.sub
        c = self.q.shape[0]
        self.building.copy_((self.depth < self.max_depth) & ~self.turning & ~self.divergent)
        go_right = sampling.uniform(gen, (c,), self.q) < 0.5
        self.go_right.copy_(go_right)
        self.u_bias.copy_(sampling.uniform(gen, (c,), self.q))
        self.u_leaf[: 2**depth].copy_(sampling.uniform(gen, (2**depth, c), self.q))
        self.eps_signed.copy_(torch.where(go_right, self.eps, -self.eps))
        for k, (right, left) in {"q": ("qr", "ql"), "p": ("pr", "pl"), "grad": ("gr", "gl"),
                                 "logp": ("lpr", "lpl")}.items():
            edge = _where(go_right, e[right], e[left])
            s[k].copy_(edge)
            if k != "p":
                s["z" + k].copy_(edge)
        for k in ("psum", "sum_acc", "n", "turning", "divergent", "ckpt_p", "ckpt_s"):
            s[k].zero_()
        s["logw"].fill_(-math.inf)
        self.leaf.zero_()

    def _leaf(self, max_delta):
        """One leaf of the subtree: a leapfrog from its far edge, the leaf's
        weight, the multinomial proposal and the U-turn checks of the
        balanced intervals that end here (the JAX package's checkpointed
        iterative construction); frozen for chains that stopped."""
        s, i, inv_mass = self.sub, self.leaf, self.inv_mass
        active = self.building & ~s["turning"] & ~s["divergent"]
        u = self.u_leaf.index_select(0, i.reshape(1))[0]
        q, p, grad, logp = self._leapfrog(s["q"], s["p"], s["grad"], self.eps_signed)
        delta = (-logp + _kinetic(p, inv_mass)) - self.h0
        diverged = ~torch.isfinite(delta) | (delta > max_delta)
        logw_leaf = torch.where(diverged, -math.inf, -delta)
        sum_acc = s["sum_acc"] + torch.where(
            diverged, 0.0, torch.clamp(torch.exp(torch.clamp(-delta, max=0.0)), max=1.0))
        psum = s["psum"] + p
        # uniform-progressive multinomial proposal within the subtree
        logw_tot = torch.logaddexp(s["logw"], logw_leaf)
        take = ~diverged & (torch.log(u) < logw_leaf - logw_tot)
        even = (i % 2) == 0
        ck = _popcount(i).reshape(1)
        ckpt_p = s["ckpt_p"].index_copy(1, ck, torch.where(even, p, s["ckpt_p"].index_select(1, ck)[:, 0])[:, None])
        ckpt_s = s["ckpt_s"].index_copy(1, ck, torch.where(even, psum, s["ckpt_s"].index_select(1, ck)[:, 0])[:, None])
        idx_max = _popcount(i >> 1)
        idx_min = idx_max - _trailing_ones(i) + 1
        j = torch.arange(self.max_depth, device=i.device)
        interval_sum = psum[:, None] - ckpt_s + ckpt_p
        hit = _is_turning(interval_sum, ckpt_p, p[:, None], inv_mass[:, None])
        turn_here = torch.any(hit & (j >= idx_min) & (j <= idx_max), dim=-1)
        new = {"q": q, "p": p, "grad": grad, "logp": logp, "psum": psum, "sum_acc": sum_acc, "logw": logw_tot,
               "zq": _where(take, q, s["zq"]), "zlogp": torch.where(take, logp, s["zlogp"]),
               "zgrad": _where(take, grad, s["zgrad"]), "ckpt_p": ckpt_p, "ckpt_s": ckpt_s,
               "turning": s["turning"] | (~even & turn_here), "divergent": s["divergent"] | diverged,
               "n": s["n"] + 1.0}
        for k, v in new.items():
            s[k].copy_(_where(active, v, s[k]))
        i.add_(1)

    def _leaves(self, count, max_delta):
        for _ in range(count):
            self._leaf(max_delta)
        s = self.sub
        self.more.copy_(torch.any(self.building & ~s["turning"] & ~s["divergent"]))

    def _doubling_end(self):
        """Biased progressive sampling across the doubling (favour the new
        half), the new edge, and the U-turn test of the whole trajectory."""
        e, s, building = self.edges, self.sub, self.building
        ok = ~s["turning"] & ~s["divergent"]
        take = ok & (torch.log(self.u_bias) < s["logw"] - e["logw"])
        right, left = ok & self.go_right, ok & ~self.go_right
        new = {"zq": _where(take, s["zq"], e["zq"]), "zlogp": torch.where(take, s["zlogp"], e["zlogp"]),
               "zgrad": _where(take, s["zgrad"], e["zgrad"]),
               "logw": torch.where(ok, torch.logaddexp(e["logw"], s["logw"]), e["logw"]),
               "psum": _where(ok, e["psum"] + s["psum"], e["psum"]),
               "sum_acc": e["sum_acc"] + s["sum_acc"], "n_leaves": e["n_leaves"] + s["n"]}
        for k, sk in (("q", "q"), ("p", "p"), ("g", "grad"), ("lp", "logp")):
            new[k + "r"] = _where(right, s[sk], e[k + "r"])
            new[k + "l"] = _where(left, s[sk], e[k + "l"])
        turning = s["turning"] | (ok & _is_turning(new["psum"], new["pl"], new["pr"], self.inv_mass))
        for k, v in new.items():
            e[k].copy_(_where(building, v, e[k]))
        self.turning.copy_(torch.where(building, turning, self.turning))
        self.divergent.copy_(self.divergent | (building & s["divergent"]))
        self.depth.add_(building.long())
        self.more.copy_(torch.any((self.depth < self.max_depth) & ~self.turning & ~self.divergent))

    def _nuts_end(self, adapt, out):
        e = self.edges
        accept_stat = e["sum_acc"] / torch.clamp(e["n_leaves"], min=1.0)
        self.q.copy_(e["zq"])
        self.logp.copy_(e["zlogp"])
        self.grad.copy_(e["zgrad"])
        if adapt:
            self._adapt(accept_stat)
        if out is not None:
            self._record(out, (self.q, accept_stat, self.divergent, self.depth))

    def nuts_transition(self, adapt, out=None, max_delta=1000.0):
        """One NUTS transition of every chain: doublings while any chain
        builds (one host read each), each doubling's 2^d leaves in chunks of
        at most NUTS_CHUNK (a host read after each chunk but the last)."""
        run, read = self.runner, self.runner.read
        run("nuts start", self._nuts_start)
        for depth in range(self.max_depth):
            if depth and not read(self.more):
                break
            run(("doubling", depth), lambda: self._doubling_start(depth))
            size = min(NUTS_CHUNK, 2**depth)
            chunks = 2**depth // size
            for c in range(chunks):
                run(("leaves", size), lambda: self._leaves(size, max_delta))
                if c + 1 < chunks and not read(self.more):
                    break
            run("doubling end", self._doubling_end)
        run(("nuts end", adapt, out is not None), lambda: self._nuts_end(adapt, out))

    def nuts_phase(self, num_iters, adapt, out=None):
        for _ in range(num_iters):
            self.nuts_transition(adapt, out)


def _run(chains, sampler, num_samples, num_warmup, num_leapfrog, step_size, adapt_mass):
    """Warmup (two dual-averaging phases around a diagonal mass estimate)
    and the kept draws, as the JAX package's ``hmc`` / ``nuts`` schedule
    them; returns the HMCResult with a leading chain axis."""
    q = chains.q
    c, dim = q.shape
    eps0 = torch.full((c,), float(step_size), dtype=q.dtype, device=q.device)

    def phase(num_iters, out=None):
        if sampler == "nuts":
            chains.nuts_phase(num_iters, out is None, out)
        else:
            chains.hmc_phase(num_iters, num_leapfrog, out is None, out)

    na = num_warmup // 2 if adapt_mass else num_warmup
    chains.start_phase(eps0, torch.ones_like(q))
    phase(na)
    eps1, var = chains.adapted()
    inv_mass = chains.inv_mass
    if adapt_mass:
        # inverse mass = posterior variance estimate (regularized toward 1
        # like Stan's windowed estimator, weight n/(n+5))
        n = float(na)
        inv_mass = torch.clamp((n / (n + 5.0)) * var + (5.0 / (n + 5.0)) * torch.ones_like(var), 1e-6, 1e6)
        chains.start_phase(eps1, inv_mass)
        phase(num_warmup - na)
        eps1, _ = chains.adapted()
    chains.start_phase(eps1, inv_mass)
    out = [torch.zeros((num_samples, c, dim), dtype=q.dtype, device=q.device),
           torch.zeros((num_samples, c), dtype=q.dtype, device=q.device),
           torch.zeros((num_samples, c), dtype=torch.bool, device=q.device)]
    if sampler == "nuts":
        out.append(torch.zeros((num_samples, c), dtype=torch.long, device=q.device))
    phase(num_samples, out)
    out = [t.movedim(0, 1) for t in out]
    return HMCResult(out[0], out[1], out[2], eps1.clone(), inv_mass.clone(), out[3] if sampler == "nuts" else None)


def _sample(sampler, logdensity, q0, unravel, generator, num_chains=None, init_jitter=0.0, max_depth=1,
            target_accept=0.8, **kw):
    """Chains of ``sampler`` on the flat start ``q0`` (dim,) of
    ``logdensity`` (pytree in, through ``unravel``): one chain at ``q0``, or
    ``num_chains`` with chain 0 there and the others ``init_jitter``·N(0, 1)
    from it.  Captured where :func:`captures` says so for the density's
    ``reads_host()`` (a :func:`log_posterior_fn`'s; none otherwise).
    Returns the :class:`HMCResult` with a leading chain axis and the
    runner."""
    if q0.shape[0] == 0:
        raise ValueError(f"{sampler}: no sampled values (empty init pytree)")
    if sampler == "nuts" and not 1 <= int(max_depth) <= 15:
        raise ValueError("nuts: max_depth must be in [1, 15]")
    vg = _batched_value_and_grad(lambda q: torch.reshape(logdensity(unravel(q)), ()))
    capture = captures(q0.device, getattr(logdensity, "reads_host", lambda: False)())
    with _Runner(q0.device, generator, capture) as runner:
        start = q0[None]
        if num_chains is not None:
            offsets = sampling.standard_normal(runner.generator, (num_chains, q0.shape[0]), q0)
            offsets[0] = 0.0
            start = start + offsets * init_jitter
        chains = _Chains(vg, start, runner, target_accept, max_depth)
        return _run(chains, sampler, **kw), runner


def _one_chain(sampler, logdensity, init, generator, device, **kw):
    q0, unravel = _ravel(init, settings.resolve_device(device))
    res, _ = _sample(sampler, logdensity, q0, unravel, generator, **kw)
    return HMCResult(*(None if t is None else t[0] for t in res)), unravel


def hmc(
    logdensity: Callable,
    init,
    generator: Optional[torch.Generator] = None,
    num_samples: int = 500,
    num_warmup: int = 500,
    num_leapfrog: int = 24,
    step_size: float = 0.1,
    adapt_mass: bool = True,
    target_accept: float = 0.8,
    device=None,
) -> tuple:
    """Run one HMC chain on a pytree-valued ``logdensity`` (a tensor, or a
    dict of tensors, in and a scalar out; it must run under
    ``torch.func.vmap``).

    Warmup is two dual-averaging phases: phase A (identity mass) adapts the
    step size and estimates per-coordinate posterior variance; phase B
    re-adapts the step size under the new diagonal mass.  Returns
    ``(HMCResult, unravel)`` where ``unravel`` maps a flat draw back to the
    structure of ``init``.  The chain runs on ``device`` (default: the
    card), each transition a replayed CUDA graph (:func:`captures`) unless
    the density's ``reads_host()`` says it reads the host, as a
    :func:`log_posterior_fn` of a model under the adaptive jitter policy
    does; then eagerly.
    """
    return _one_chain("hmc", logdensity, init, generator, device, num_samples=num_samples, num_warmup=num_warmup,
                      num_leapfrog=num_leapfrog, step_size=step_size, adapt_mass=adapt_mass,
                      target_accept=target_accept)


def nuts(
    logdensity: Callable,
    init,
    generator: Optional[torch.Generator] = None,
    num_samples: int = 500,
    num_warmup: int = 500,
    max_depth: int = 10,
    step_size: float = 0.1,
    adapt_mass: bool = True,
    target_accept: float = 0.8,
    device=None,
) -> tuple:
    """Run one No-U-Turn chain on a pytree-valued ``logdensity``.

    Same warmup schedule, return convention, device and capture as
    :func:`hmc`, but the trajectory length per transition is chosen
    dynamically by trajectory doubling up to ``2^max_depth`` leapfrog steps
    (``max_depth`` in [1, 15]).  ``HMCResult.accept_prob`` holds the
    per-transition mean leaf accept probability.
    """
    return _one_chain("nuts", logdensity, init, generator, device, max_depth=max_depth, num_samples=num_samples,
                      num_warmup=num_warmup, num_leapfrog=None, step_size=step_size, adapt_mass=adapt_mass,
                      target_accept=target_accept)


# ---------------------------------------------------------------------------
# the model-level entry point


def sample_posterior(
    model,
    generator: Optional[torch.Generator] = None,
    num_samples: int = 500,
    num_warmup: int = 500,
    num_chains: int = 1,
    num_leapfrog: int = 24,
    step_size: float = 0.1,
    jacobian: bool = True,
    init_jitter: float = 0.1,
    adapt_mass: bool = True,
    target_accept: float = 0.8,
    sampler: str = "hmc",
    max_depth: int = 10,
    device=None,
):
    """Sample the hyperparameter posterior of ``model``.

    Returns ``(samples, result)`` where ``samples`` maps each trainable
    parameter path to its CONSTRAINED draws, shape
    ``(num_chains, num_samples) + param_shape`` (leading chain axis kept
    even for one chain), and ``result`` is the flat :class:`HMCResult`
    (diagnostics: ``accept_prob``, ``divergent``, adapted ``step_size`` /
    ``inv_mass``, and for NUTS ``tree_depth``).

    ``sampler``: ``"hmc"`` (fixed ``num_leapfrog`` trajectories) or
    ``"nuts"`` (dynamic trajectory doubling up to ``2^max_depth`` steps;
    ``num_leapfrog`` is ignored).

    Chains start from the model's current values, jittered by
    ``init_jitter`` times a standard normal in unconstrained space (chain 0
    starts exactly at the current values), and run as one (chains, dim)
    state on ``device`` (default: the model's, which it must be).  On the
    card each transition (NUTS: each step of one) is a captured CUDA graph
    unless the model's loss reads the host (:func:`captures`); then the
    steps run eagerly.  ``sample_posterior.last_run`` holds the last call's
    runner (whether it captured, host reads, graph launches and replays).
    """
    if sampler not in ("hmc", "nuts"):
        raise ValueError("sampler must be 'hmc' or 'nuts'")
    dev = model.device if device is None else torch.device(device)
    if dev != model.device:
        raise ValueError(f"sample_posterior: the model lives on {model.device}, not {dev}")
    q0, unravel = _ravel(get_trainable(model), dev)
    result, runner = _sample(sampler, log_posterior_fn(model, jacobian=jacobian), q0, unravel, generator,
                             num_chains=num_chains, init_jitter=init_jitter, max_depth=max_depth,
                             target_accept=target_accept, num_samples=num_samples, num_warmup=num_warmup,
                             num_leapfrog=num_leapfrog, step_size=step_size, adapt_mass=adapt_mass)
    sample_posterior.last_run = runner
    bijectors = _trainable_bijectors(model)
    samples = {name: bijectors[name].forward(raw) for name, raw in unravel(result.samples).items()}
    return samples, result


#: The last :func:`sample_posterior` call's runner.
sample_posterior.last_run = None


def _mixture_chunk(model, draws: int) -> int:
    """Draws a chunk of :func:`predict_mixture` maps over: as many as keep
    a chunk's (n, n) factors under a quarter of the card's free memory
    (256 MiB on the CPU)."""
    n = model.X.shape[0]
    budget = torch.cuda.mem_get_info(model.device)[0] / 4 if model.device.type == "cuda" else 2**28
    return int(max(1, min(draws, budget // (3 * n * n * model.X.element_size()))))


def predict_mixture(model, samples, x_new, y: bool = True):
    """Posterior-mixture predictions: average ``predict_y`` (or
    ``predict_f``) moments over hyperparameter draws.

    ``samples``: the constrained dict from :func:`sample_posterior` (chain
    axis optional).  Returns ``(mean, var)`` of the Gaussian mixture:
    ``mean = E[mu_s]``, ``var = E[var_s + mu_s^2] - mean^2``.  Each draw
    refactorizes (exact, not cached), as a ``torch.func.vmap`` over chunks
    of draws sized to the free memory.
    """
    values = get_trainable(model)
    bijectors = _trainable_bijectors(model)
    flat = {}
    for name, v in values.items():
        s = samples[name]
        s = torch.as_tensor(s if isinstance(s, torch.Tensor) else np.array(s), dtype=v.dtype, device=v.device)
        s = s.reshape((-1,) + tuple(v.shape))
        flat[name] = bijectors[name].inverse(s)
    x_new = torch.as_tensor(x_new, dtype=model.X.dtype, device=model.device)
    draws = next(iter(flat.values())).shape[0]
    chunk = _mixture_chunk(model, draws)
    method = "predict_y" if y else "predict_f"
    mapped = torch.func.vmap(lambda d: call_with_trainable(model, d, method, x_new))
    means, vars_ = [], []
    with torch.no_grad():
        for lo in range(0, draws, chunk):
            m, v = mapped({k: t[lo : lo + chunk] for k, t in flat.items()})
            means.append(m)
            vars_.append(v)
    means, vars_ = torch.cat(means), torch.cat(vars_)
    mean = torch.mean(means, dim=0)
    return mean, torch.mean(vars_ + means**2, dim=0) - mean**2


# ---------------------------------------------------------------------------
# elliptical slice sampling: exact latent posteriors for non-Gaussian
# likelihoods (Murray, Adams & MacKay 2010)


class _Slice:
    """One elliptical-slice chain's state and the steps of its transition
    (in place, as :class:`_Chains`)."""

    def __init__(self, log_lik, chol, f0, runner, max_shrink):
        dt, dev = f0.dtype, f0.device
        self.log_lik, self.chol, self.runner, self.max_shrink = log_lik, chol, runner, int(max_shrink)
        self.f = f0.clone()
        self.nu = torch.zeros_like(f0)
        zero = lambda: torch.zeros((), dtype=dt, device=dev)  # noqa: E731
        self.logy, self.theta, self.lo, self.hi = zero(), zero(), zero(), zero()
        self.accepted = torch.zeros((), dtype=torch.bool, device=dev)
        self.count = torch.zeros((), dtype=torch.long, device=dev)
        self.more = torch.zeros((), dtype=torch.bool, device=dev)

    def _prop(self, theta):
        return self.f * torch.cos(theta) + self.nu * torch.sin(theta)

    def _start(self):
        gen, f = self.runner.generator, self.f
        xi = sampling.standard_normal(gen, f.shape, f)
        self.nu.copy_((self.chol @ xi.reshape(f.shape[0], -1)).reshape(f.shape))
        self.logy.copy_(self.log_lik(f) + torch.log(sampling.uniform(gen, (), f)))
        theta0 = sampling.uniform(gen, (), f) * (2.0 * math.pi)
        self.theta.copy_(theta0)
        self.lo.copy_(theta0 - 2.0 * math.pi)
        self.hi.copy_(theta0)
        self.accepted.copy_(self.log_lik(self._prop(theta0)) > self.logy)
        self.count.zero_()

    def _shrinks(self):
        """ESS_CHUNK bracket shrinks, each frozen once an angle is accepted
        or max_shrink shrinks are spent."""
        u = sampling.uniform(self.runner.generator, (ESS_CHUNK,), self.f)
        for j in range(ESS_CHUNK):
            active = ~self.accepted & (self.count < self.max_shrink)
            theta = self.theta
            lo = torch.where(theta < 0.0, theta, self.lo)
            hi = torch.where(theta >= 0.0, theta, self.hi)
            theta = torch.maximum(lo, u[j] * (hi - lo) + lo)
            accepted = self.log_lik(self._prop(theta)) > self.logy
            self.lo.copy_(torch.where(active, lo, self.lo))
            self.hi.copy_(torch.where(active, hi, self.hi))
            self.theta.copy_(torch.where(active, theta, self.theta))
            self.accepted.copy_(torch.where(active, accepted, self.accepted))
            self.count.add_(active.long())
        self.more.copy_(~self.accepted & (self.count < self.max_shrink))

    def _end(self):
        # no acceptable angle: theta = 0 is the current point (exact, not approximate)
        self.f.copy_(self._prop(torch.where(self.accepted, self.theta, 0.0)))

    def transition(self):
        run = self.runner
        run("slice start", self._start)
        for _ in range(-(-self.max_shrink // ESS_CHUNK)):
            run("shrinks", self._shrinks)
            if not run.read(self.more):
                break
        run("slice end", self._end)


def elliptical_slice(
    log_lik: Callable,
    chol_cov,
    f0,
    generator: Optional[torch.Generator] = None,
    num_samples: int = 300,
    num_burn: int = 200,
    thin: int = 1,
    max_shrink: int = 64,
    device=None,
):
    """Sample f ~ p(f | y) ∝ N(f; 0, K) · exp(log_lik(f)) by elliptical
    slice sampling: rejection-free (every transition moves by bracket
    shrinkage, no step size, no tuning), exact in the prior.

    Each transition is an auxiliary draw ν = L ξ and a bracket shrink of at
    most ``max_shrink`` steps, run in chunks of ESS_CHUNK (captured as CUDA
    graphs on the card, :func:`captures`, unless ``log_lik.reads_host()``
    says it reads the host; one host read per chunk).  If no acceptable angle is found within ``max_shrink`` shrinks,
    the state stays where it was -- θ = 0 is the current point, so the
    fallback is exact, not approximate.

    :param log_lik: callable f -> scalar log likelihood (any shape f).
    :param chol_cov: (n, n) lower Cholesky of the prior covariance.
    :param f0: (n,) or (n, p) initial state (columns are iid GP draws).
    :param thin: keep every ``thin``-th draw after ``num_burn``.
    :param device: where the chain runs (default: the card).
    :return: draws, shape (num_samples,) + f0.shape.  ``elliptical_slice.last_run``
        holds the call's runner; its ``shrinks`` the shrinks of each
        transition (a device tensor).
    """
    dev = settings.resolve_device(device)
    chol = torch.as_tensor(chol_cov, device=dev)
    f0 = torch.as_tensor(f0, dtype=chol.dtype, device=dev)
    capture = captures(dev, getattr(log_lik, "reads_host", lambda: False)())
    draws = torch.zeros((num_samples,) + tuple(f0.shape), dtype=f0.dtype, device=dev)
    transitions = num_burn + num_samples * thin
    with torch.no_grad(), _Runner(dev, generator, capture) as runner:
        runner.shrinks = torch.zeros(transitions, dtype=torch.long, device=dev)
        chain = _Slice(log_lik, chol, f0, runner, max_shrink)
        for t in range(transitions):
            chain.transition()
            runner.shrinks[t].copy_(chain.count)
            k, r = divmod(t - num_burn, thin)
            if t >= num_burn and r == 0 and k < num_samples:
                draws[k].copy_(chain.f)
    elliptical_slice.last_run = runner
    return draws


#: The last :func:`elliptical_slice` call's runner.
elliptical_slice.last_run = None


def latent_prior_chol(model, jitter: float = 1e-6):
    """Lower Cholesky of K(X, X) + rel-jitter — the prior factor both
    :func:`sample_latent` and :func:`predict_latent_mixture` need; compute
    it once and pass it to both to avoid refactorizing O(n³) per call."""
    with torch.no_grad():
        K = model.kernel.K(model.X)
        scale = jitter * torch.clamp(torch.max(torch.diagonal(K)), min=1.0)
        return cholesky(add_diag(K, scale))


def sample_latent(
    model,
    generator: Optional[torch.Generator] = None,
    num_samples: int = 300,
    num_burn: int = 200,
    thin: int = 1,
    jitter: float = 1e-6,
    chol: Optional[torch.Tensor] = None,
):
    """Exact posterior samples of the latent function AT THE TRAINING
    INPUTS of an exact-kernel GP model with any factorizing likelihood:
    f | y under f ~ GP(m, K), by elliptical slice sampling.

    The asymptotically exact alternative to the Gaussian approximations
    (:class:`~gptorch_tpu_torch.models.LaplaceGP`, variational SVGP).
    Hyperparameters stay fixed at the model's current values (compose with
    :func:`sample_posterior` for full Bayes over θ as an outer loop).  Runs
    on the model's device.

    :param chol: optional precomputed :func:`latent_prior_chol` (reuse it
        across sample_latent / predict_latent_mixture calls).
    :return: draws (num_samples, n, dy), INCLUDING the mean function.
    """
    X, Y = model.X, model.Y
    with torch.no_grad():
        L = latent_prior_chol(model, jitter) if chol is None else chol
        mean = model.mean_function(X)
        lik = model.likelihood

        def log_lik(f_centered):
            return torch.sum(lik.logp(f_centered + mean, Y))

        f0 = torch.zeros((L.shape[0], Y.shape[1]), dtype=Y.dtype, device=Y.device)
        draws = elliptical_slice(log_lik, L, f0, generator, num_samples=num_samples, num_burn=num_burn, thin=thin,
                                 device=model.device)
        return draws + mean[None]


def predict_latent_mixture(model, draws, x_new, jitter: float = 1e-6, chol: Optional[torch.Tensor] = None):
    """Posterior-predictive moments of f* from :func:`sample_latent`
    draws: for each draw, f* | f is the noise-free conditional
    N(k*ᵀK⁻¹(f − m), diag(k** − k*ᵀK⁻¹k*)); mixing over draws gives
    ``mean = E[μ_s]``, ``var = cond_var + Var[μ_s]``.  One product over all
    draws (the conditional matrix is draw-independent).  Pass ``chol``
    (from :func:`latent_prior_chol`) to skip the O(n³) refactorization
    on repeated calls.
    """
    X = model.X
    with torch.no_grad():
        x_new = torch.as_tensor(x_new, dtype=X.dtype, device=X.device)
        draws = torch.as_tensor(draws, dtype=X.dtype, device=X.device)
        L = latent_prior_chol(model, jitter) if chol is None else chol
        n = L.shape[0]
        A = trtrs(model.kernel.K(X, x_new), L)  # (n, m) = L^{-1} k*
        cond_var = torch.clamp(model.kernel.Kdiag(x_new) - torch.sum(A * A, dim=0), min=0.0)[:, None]
        resid = draws - model.mean_function(X)[None]  # (S, n, dy)
        s = draws.shape[0]
        V = trtrs(resid.reshape(s, n, -1).permute(1, 0, 2).reshape(n, -1), L)  # L^{-1} resid, all draws at once
        mus = (A.T @ V).reshape(x_new.shape[0], s, -1).permute(1, 0, 2) + model.mean_function(x_new)[None]
        mean = torch.mean(mus, dim=0)
        return mean, cond_var + torch.var(mus, dim=0, correction=0)


# ---------------------------------------------------------------------------
# diagnostics


def potential_scale_reduction(x) -> torch.Tensor:
    """Split-R-hat over a (chains, samples, ...) array (Gelman et al.;
    the standard split-chain form). Values near 1 indicate convergence."""
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(settings.default_float())
    half = x.shape[1] // 2
    x = torch.cat([x[:, :half], x[:, half : 2 * half]], dim=0)
    n = x.shape[1]
    w = torch.mean(torch.var(x, dim=1, correction=1), dim=0)
    b = n * torch.var(torch.mean(x, dim=1), dim=0, correction=1)
    var_plus = (n - 1) / n * w + b / n
    return torch.sqrt(var_plus / w)


def effective_sample_size(x) -> torch.Tensor:
    """Bulk ESS from the initial-positive-sequence autocorrelation estimator
    (Geyer 1992), per scalar coordinate, summed over chains (a loop on the
    host, in float64)."""
    x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    scalar = x.ndim == 2
    if scalar:
        x = x[..., None]
    c, n = x.shape[0], x.shape[1]
    out = np.zeros(x.shape[2:])
    for idx in np.ndindex(*x.shape[2:]):
        rho_sum = 0.0
        for ci in range(c):
            z = x[(ci, slice(None)) + idx]
            z = z - z.mean()
            denom = float(z @ z)
            if denom == 0.0:
                continue
            t = 1
            rho_pair_prev = np.inf
            while t + 1 < n:
                r1 = float(z[: n - t] @ z[t:]) / denom
                r2 = float(z[: n - t - 1] @ z[t + 1 :]) / denom
                pair = r1 + r2
                if pair < 0:
                    break
                pair = min(pair, rho_pair_prev)  # monotone (Geyer IMS)
                rho_sum += pair
                rho_pair_prev = pair
                t += 2
        out[idx] = c * n / (1.0 + 2.0 * rho_sum / c) if c else 0.0
    return torch.as_tensor(out[0] if scalar else out)
