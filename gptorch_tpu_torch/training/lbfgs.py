"""L-BFGS with optax's update rule and zoom line search.

Counterpart of ``optax.lbfgs()`` as the JAX package builds it
(``gptorch_tpu/training/fit.py`` ``make_optimizer("LBFGS")``; optax 0.2.6,
``optax/_src/alias.py`` ``lbfgs``, ``optax/_src/transform.py``
``scale_by_lbfgs`` and ``optax/_src/linesearch.py``
``scale_by_zoom_linesearch``).  It is not ``torch.optim.LBFGS``, whose line
search and first step differ.

One :meth:`LBFGS.step` is one iteration:

1. the value and gradient at the current parameters: the line search's
   last evaluation when it is finite (optax's ``value_and_grad_from_state``),
   else one call of the closure;
2. the direction u = −lr·P·g, with P the inverse-Hessian approximation of
   the last ``MEMORY_SIZE`` (Δw, Δg) pairs (two-loop recursion) started at
   γ = ΔwᵀΔg/‖Δg‖² -- at the first step min(1, 1/‖g‖) -- and lr = 1 when
   ``lr`` is None;
3. the zoom line search along u (Nocedal & Wright, Algorithms 3.5 and 3.6,
   with Hager and Zhang's approximate-decrease criterion), from the step
   1, at most ``MAX_LINESEARCH_STEPS`` evaluations;
4. w ← w + η·u with the step η it found.

The scalars of the line search live on the host in float64: every
evaluation reads the value and the slope from the device, so the loop runs
eagerly (it branches on the data).
"""

from __future__ import annotations

import math

import numpy as np
import torch


#: optax.lbfgs()'s settings: memory 10, the zoom line search's at most 20
#: evaluations from the step 1, its tolerances and interval growth.
MEMORY_SIZE, MAX_LINESEARCH_STEPS = 10, 20
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL, STEPSIZE_PRECISION, INCREASE_FACTOR = 1e-4, 0.9, 1e-6, 1e-5, 2.0


def _vdot(a, b) -> float:
    return float(sum(torch.sum(x * y) for x, y in zip(a, b)))


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when there is none (optax's ``_cubicmin``)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0, v1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * v0 + -(db ** 2) * v1) / denom
    B = (-(dc ** 3) * v0 + db ** 3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax's ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


class LBFGS(torch.optim.Optimizer):
    """optax.lbfgs(learning_rate) with its defaults (memory 10, the scaled
    first step, ``scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy="one")`` and its tolerances).

    ``step(closure)``: the closure clears the gradients, computes the loss,
    calls ``backward()`` and returns the loss, as for ``torch.optim.LBFGS``;
    ``step`` returns the loss at the parameters it started from.

    :param lr: ``None`` takes the line search's step unscaled; a number
        scales the direction before the search (optax's
        ``scale_by_learning_rate`` ahead of the line search).
    :param reuse_evaluations: start each step from the line search's last
        value and gradient (True, for an objective that is the same at
        every step) or from a fresh closure call (False).
    """

    def __init__(self, params, lr=None, reuse_evaluations: bool = True):
        super().__init__(params, dict(lr=lr))
        self.reuse_evaluations = bool(reuse_evaluations)
        self.count = 0
        self.prev_params = self.prev_grads = None
        self.dw = [None] * MEMORY_SIZE
        self.du = [None] * MEMORY_SIZE
        self.rho = [0.0] * MEMORY_SIZE
        self.last = None  # (value, grads) of the line search's last accepted point
        #: Closure calls of each step (the first evaluation included).
        self.evaluations = []

    def _params(self):
        return [p for group in self.param_groups for p in group["params"]]

    def _evaluate(self, closure, params):
        with torch.enable_grad():
            loss = closure()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.detach().clone() for p in params]
        return float(loss), grads

    @torch.no_grad()
    def step(self, closure):
        params = self._params()
        evaluations = 0
        if self.reuse_evaluations and self.last is not None and math.isfinite(self.last[0]):
            value, grads = self.last
        else:
            value, grads = self._evaluate(closure, params)
            evaluations += 1
        w0 = [p.detach().clone() for p in params]
        u = self._direction(w0, grads)
        lr = self.param_groups[0]["lr"]
        u = [-(1.0 if lr is None else lr) * t for t in u]

        def value_and_grad(stepsize):
            for p, w, d in zip(params, w0, u):
                p.copy_(w + stepsize * d)
            return self._evaluate(closure, params)

        stepsize, new_value, new_grads, n_evals = self._linesearch(value_and_grad, value, grads, u)
        for p, w, d in zip(params, w0, u):
            p.copy_(w + stepsize * d)
        self.last = (new_value, new_grads)
        self.evaluations.append(evaluations + n_evals)
        return value

    def _direction(self, w, g):
        """P·g by the two-loop recursion (optax's ``scale_by_lbfgs``),
        after the memory takes the pair of the last step."""
        m = MEMORY_SIZE
        idx, prev = self.count % m, (self.count - 1) % m
        if self.count > 0:
            dw = [a - b for a, b in zip(w, self.prev_params)]
            du = [a - b for a, b in zip(g, self.prev_grads)]
            vdot = _vdot(du, dw)
            self.dw[prev], self.du[prev] = dw, du
            self.rho[prev] = 0.0 if vdot == 0.0 else 1.0 / vdot
        if self.count > 0:
            den = _vdot(du, du)
            gamma = vdot / den if den > 0.0 else 1.0
        else:
            with np.errstate(all="ignore"):
                gamma = float(np.minimum(1.0, 1.0 / np.sqrt(np.float64(_vdot(g, g)))))
        order = [(idx + i) % m for i in range(m)]
        vec, alphas = list(g), [0.0] * m
        for i in reversed(range(m)):
            j = order[i]
            if self.rho[j] != 0.0:
                alphas[i] = self.rho[j] * _vdot(self.dw[j], vec)
                vec = [v - alphas[i] * d for v, d in zip(vec, self.du[j])]
        vec = [gamma * v for v in vec]
        for i in range(m):
            j = order[i]
            if self.rho[j] != 0.0:
                beta = self.rho[j] * _vdot(self.du[j], vec)
                vec = [v + (alphas[i] - beta) * d for v, d in zip(vec, self.dw[j])]
        self.count += 1
        self.prev_params, self.prev_grads = w, g
        return vec

    def _decrease_error(self, stepsize, value, slope, value_init, slope_init):
        err = value - value_init - SLOPE_RTOL * stepsize * slope_init
        approx = np.maximum(slope - (2 * SLOPE_RTOL - 1.0) * slope_init,
                            value - value_init - APPROX_DEC_RTOL * abs(value_init))
        err = float(np.maximum(np.minimum(approx, err), 0.0))
        return math.inf if math.isnan(err) else err

    def _curvature_error(self, slope, slope_init):
        err = float(np.maximum(abs(slope) - CURV_RTOL * abs(slope_init), 0.0))
        return math.inf if math.isnan(err) else err

    def _linesearch(self, value_and_grad, value_init, grad_init, u):
        """optax's zoom line search (``zoom_linesearch``) along ``u`` from
        the step 1: returns (step, value, gradient, evaluations).  NaN
        comparisons are False and ``np.maximum``/``np.minimum`` carry a
        NaN, as ``jnp``'s do in optax."""
        slope_init = _vdot(u, grad_init)
        s = dict(count=0, stepsize=0.0, value=value_init, grad=grad_init, slope=slope_init,
                 decrease_error=math.inf, interval_found=False, done=False, failed=False,
                 low=0.0, value_low=value_init, slope_low=slope_init, high=0.0, value_high=value_init,
                 slope_high=slope_init, cubic_ref=0.0, value_cubic_ref=value_init, safe_stepsize=0.0,
                 safe_value=value_init, safe_grad=grad_init)
        tol = 0.0
        with np.errstate(all="ignore"):
            while not (s["done"] or s["failed"]):
                if not s["interval_found"]:
                    new = 1.0 if s["count"] == 0 else INCREASE_FACTOR * s["stepsize"]
                    value, grad = value_and_grad(new)
                    slope = _vdot(grad, u)
                    dec = self._decrease_error(new, value, slope, value_init, slope_init)
                    curv = self._curvature_error(slope, slope_init)
                    error = max(dec, curv)
                    if dec <= tol:
                        s.update(safe_stepsize=new, safe_value=value, safe_grad=grad)
                    high_new = dec > 0.0 or (value >= s["value"] and s["count"] > 0)
                    low_new = slope >= 0.0 and not high_new
                    prev = (s["stepsize"], s["value"], s["slope"])
                    if low_new:
                        (low, vlow, slow), (high, vhigh, shigh) = (new, value, slope), prev
                    else:
                        (low, vlow, slow), (high, vhigh, shigh) = prev, (new, value, slope)
                    interval_found = high_new or low_new or error <= tol
                    done = error <= tol
                    s.update(interval_found=interval_found, done=done,
                             failed=(s["count"] + 1 >= MAX_LINESEARCH_STEPS) and not done,
                             low=low, value_low=vlow, slope_low=slow, high=high, value_high=vhigh,
                             slope_high=shigh, cubic_ref=low, value_cubic_ref=vlow)
                else:
                    low, vlow, slow = s["low"], s["value_low"], s["slope_low"]
                    high, vhigh, shigh = s["high"], s["value_high"], s["slope_high"]
                    delta = abs(high - low)
                    left, right = min(high, low), max(high, low)
                    cubic = float(_cubicmin(np.float64(low), vlow, slow, np.float64(high), vhigh,
                                            np.float64(s["cubic_ref"]), s["value_cubic_ref"]))
                    quad = float(_quadmin(np.float64(low), vlow, slow, np.float64(high), vhigh))
                    if left + 0.2 * delta < cubic < right - 0.2 * delta:
                        new = cubic
                    elif left + 0.1 * delta < quad < right - 0.1 * delta:
                        new = quad
                    else:
                        new = (low + high) / 2.0
                    value, grad = value_and_grad(new)
                    slope = _vdot(grad, u)
                    dec = self._decrease_error(new, value, slope, value_init, slope_init)
                    curv = self._curvature_error(slope, slope_init)
                    error = max(dec, curv)
                    if dec <= tol and value < s["safe_value"]:
                        s.update(safe_stepsize=new, safe_value=value, safe_grad=grad)
                    done = error <= tol
                    high_mid = dec > 0.0 or value >= vlow
                    high_low = slope * (high - low) >= 0.0 and not high_mid
                    if high_mid:
                        nhigh = (new, value, slope)
                    elif high_low:
                        nhigh = (low, vlow, slow)
                    else:
                        nhigh = (high, vhigh, shigh)
                    nlow = (low, vlow, slow) if high_mid else (new, value, slope)
                    ref = (high, vhigh) if (high_mid or high_low) else (low, vlow)
                    too_small = delta <= STEPSIZE_PRECISION
                    failed = ((s["count"] + 1 >= MAX_LINESEARCH_STEPS)
                              or (too_small and s["safe_stepsize"] > 0.0)) and not done
                    s.update(done=done, failed=failed, low=nlow[0], value_low=nlow[1], slope_low=nlow[2],
                             high=nhigh[0], value_high=nhigh[1], slope_high=nhigh[2], cubic_ref=ref[0],
                             value_cubic_ref=ref[1])
                s.update(count=s["count"] + 1, stepsize=new, value=value, grad=grad, slope=slope,
                         decrease_error=dec)
                if s["failed"] and (s["safe_stepsize"] > 0.0 or math.isinf(s["decrease_error"])):
                    s.update(stepsize=s["safe_stepsize"], value=s["safe_value"], grad=s["safe_grad"])
        return s["stepsize"], s["value"], s["grad"], s["count"]
