"""Laplace-approximation GP for non-Gaussian likelihoods (exact-kernel
classification and robust or count regression).

Counterpart of ``gptorch_tpu/models/laplace.py`` (GPML §3.4–3.5,
Algorithms 3.1 and 3.2): the posterior mode f̂ of p(f | X, y) by a fixed
number of Newton steps, the posterior approximated by N(f̂, (K⁻¹ + W)⁻¹),
and the Laplace evidence as the training objective.

* The Newton steps are a Python loop of fixed length with no host read,
  differentiated through, as the JAX package differentiates its
  ``lax.scan``; each step takes the best of a static grid of step sizes
  along the Newton direction, which costs no extra solve.
* B = I + √W K √W has its eigenvalues in [1, 1 + n·max W·λ], so it is
  factored bare (``policy="none"``): the adaptive jitter's probe would pick
  no jitter for it and read the host at every step.
* The pointwise likelihood derivatives are ``torch.func.grad`` of the
  likelihood's ``logp`` (:func:`_pointwise_derivs`).
* Output columns are independent GPs sharing the kernel: the mode is found
  column by column.

Non-log-concave likelihoods (StudentT) can give negative W; it is clamped
at ``w_floor``.
"""

from __future__ import annotations

import torch
from torch.func import grad

from .. import likelihoods as _likelihoods
from ..functions import add_diag, cholesky, trtrs
from .base import GPModel

__all__ = ["LaplaceGP"]


def _pointwise_derivs(likelihood):
    """(d/df, d²/df²) of log p(y | f), elementwise over [n] vectors.  The
    likelihood's ``logp`` is elementwise, so ``torch.func.grad`` of its sum
    is each point's first derivative and ``grad`` of the sum of those the
    Hessian's diagonal, each point's second: the JAX package's ``vmap`` of a
    scalar ``grad``, without mapping ``logp`` point by point (torch has no
    batching rule for ``log_ndtr``, so a ``vmap`` would loop over the
    points)."""

    def total(f, y):
        return torch.sum(likelihood.logp(f, y))

    d1 = grad(total)
    return d1, grad(lambda f, y: torch.sum(d1(f, y)))


class LaplaceGP(GPModel):
    """Exact-kernel GP with a Laplace-approximate posterior.

    :param num_newton: Newton steps for the mode (20 is ample for
        log-concave likelihoods; raise it for StudentT).
    :param jitter: added to the prior Gram's diagonal.
    :param w_floor: lower clamp on W = −d² log p / df².
    :param device: see :class:`~gptorch_tpu_torch.models.base.GPModel`.
    """

    def __init__(self, x, y, kernel, likelihood=None, mean_function=None, num_newton: int = 20,
                 jitter: float = 1e-6, w_floor: float = 1e-8, name: str = "laplace_gp", device=None):
        if likelihood is None:
            likelihood = _likelihoods.Bernoulli()
        if getattr(likelihood, "joint_outputs", False):
            raise ValueError(
                "LaplaceGP factorizes over output columns; joint-output likelihoods "
                f"({type(likelihood).__name__}) need the coupled-Hessian mode it does not implement -- use SVGP"
            )
        super().__init__(x, y, kernel, likelihood=likelihood, mean_function=mean_function, name=name, device=device)
        self.num_newton = int(num_newton)
        self.jitter = float(jitter)
        self.w_floor = float(w_floor)

    def _reads_jitter_policy(self) -> bool:
        """B is factored bare: the loss reads no jitter policy."""
        return False

    # -- mode finding -------------------------------------------------------------

    def _gram(self, x):
        """K(x, x) + jitter·I."""
        k = self.kernel.K(x)
        return add_diag(k, torch.full((), self.jitter, dtype=k.dtype, device=k.device))

    def _newton_factor(self, K, f, y_col):
        """(g, √W, chol(B)) at f: the likelihood's gradient, the square root
        of its clamped negative curvature, and B = I + √W K √W factored."""
        d1, d2 = _pointwise_derivs(self.likelihood)
        sw = torch.sqrt(torch.clamp(-d2(f, y_col), min=self.w_floor))
        B = add_diag(sw[:, None] * K * sw[None, :], torch.ones((), dtype=K.dtype, device=K.device))
        return d1(f, y_col), sw, cholesky(B, policy="none")

    def _mode_column(self, K, m_col, y_col):
        """Newton mode and Laplace quantities of one output column: (f̂, √W,
        chol(B), evidence).  GPML Algorithm 3.1 with the step along the
        Newton direction chosen from a static grid by the objective ψ, which
        carrying a with K a = f − m makes a combination of quantities in
        hand."""
        n = K.shape[0]
        # the grid (0, 1/32, 1/16, 1/8, 1/4, 1/2, 1), exact, built on K's
        # device: a copy from the host cannot sit in a captured training step
        steps = torch.cat([K.new_zeros(1), K.new_full((6,), 2.0).cumprod(0) / 64])
        f, a_prev = m_col, torch.zeros(n, dtype=K.dtype, device=K.device)
        for _ in range(self.num_newton):
            g, sw, L = self._newton_factor(K, f, y_col)
            b = sw * sw * (f - m_col) + g
            rhs = sw * (K @ b)
            sol = trtrs(trtrs(rhs[:, None], L), L.T, lower=False)[:, 0]
            a_cand = b - sw * sol
            ka_cand = K @ a_cand
            fm_prev = f - m_col  # == K a_prev
            t = steps[:, None]
            a_t = (1 - t) * a_prev + t * a_cand
            fm_t = (1 - t) * fm_prev + t * ka_cand
            psi = -0.5 * torch.sum(a_t * fm_t, dim=1) + torch.sum(self.likelihood.logp(m_col + fm_t, y_col), dim=1)
            best = steps.gather(0, torch.argmax(psi).reshape(1))[0]  # no host read, as a captured step needs
            a_prev = (1 - best) * a_prev + best * a_cand
            f = m_col + (1 - best) * fm_prev + best * ka_cand
        _, sw, L = self._newton_factor(K, f, y_col)
        evidence = (-0.5 * torch.sum(a_prev * (f - m_col)) + torch.sum(self.likelihood.logp(f, y_col))
                    - torch.sum(torch.log(torch.diagonal(L))))
        return f, sw, L, evidence

    def _laplace_state(self, x, y):
        """(K, m, f̂ (n, dy), √W (n, dy), chol(B) (dy, n, n), evidence (dy,))."""
        K = self._gram(x)
        m = self.mean_function(x).expand(y.shape)
        cols = [self._mode_column(K, m[:, c], y[:, c]) for c in range(y.shape[1])]
        f_hat, sw, L, ev = (torch.stack(parts, dim=dim) for parts, dim in zip(zip(*cols), (1, 1, 0, 0)))
        return K, m, f_hat, sw, L, ev

    # -- training objective ----------------------------------------------------------

    def log_likelihood(self, x=None, y=None, generator=None):
        """The Laplace evidence log q(y | X, θ) (GPML eq. 3.32), summed over
        output columns."""
        x = self.X if x is None else x
        y = self.Y if y is None else y
        return torch.sum(self._laplace_state(x, y)[-1])

    # -- prediction --------------------------------------------------------------

    def _predict(self, x_new, diag=True):
        """GPML Algorithm 3.2 over all output columns."""
        _, _, f_hat, sw, L, _ = self._laplace_state(self.X, self.Y)
        d1, _ = _pointwise_derivs(self.likelihood)
        g_hat = torch.stack([d1(f_hat[:, c], self.Y[:, c]) for c in range(f_hat.shape[1])], dim=1)
        ks = self.kernel.K(self.X, x_new)  # (n, n*)
        mean = self.mean_function(x_new) + ks.T @ g_hat  # (n*, dy)
        v = torch.stack([trtrs(sw[:, c, None] * ks, L[c]) for c in range(f_hat.shape[1])])  # (dy, n, n*)
        if diag:
            var = self.kernel.Kdiag(x_new)[None, :] - torch.sum(v * v, dim=1)  # (dy, n*)
            return mean, torch.clamp(var, min=0.0).T
        cov = self.kernel.K(x_new)[None] - torch.einsum("dnm,dnp->dmp", v, v)
        if self.output_dimension != 1:
            return mean, cov
        return mean, cov[0]

    def mode(self):
        """The posterior mode f̂ at the training inputs, (n, dy)."""
        return self._laplace_state(self.X, self.Y)[2]
