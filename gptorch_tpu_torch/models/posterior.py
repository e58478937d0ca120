"""Cached predictive posteriors for serving.

Counterpart of the exact-GP and sparse parts of
``gptorch_tpu/models/posterior.py``: ``model.posterior()`` factorizes once
and returns a posterior whose predictions cost one cross-Gram and
triangular solves (:class:`GPRPosterior`; :class:`LowRankPosterior` for VFE
and FITC; :class:`SVGPPosterior`); its ``for_serving`` inverts the
triangular factors once and returns a serving twin whose predictions are
matrix products only.  The exact posteriors also condition on new data at
fixed hyperparameters (``condition_on``; :class:`FantasyGPRChain` for an
observe loop in preallocated buffers) and draw posterior function samples
(``sample_paths``, Matheron's rule on random-Fourier-feature prior paths).

A posterior is a frozen serving artifact: its factors are computed under
``torch.no_grad()``, and it holds its own detached copies of the kernel,
likelihood and mean function (:func:`_frozen`), so training the model in
place afterwards does not change it -- as in the JAX package, where
training replaces the model's modules.  Its public predict methods follow
the model's rule (``_coerce_io``): numpy in, numpy out, without autograd;
tensor in, tensor out, in the caller's grad mode; and, as the JAX
package's posteriors do, take any other array-like (a list) and answer
with tensors (``_accepts_array_like``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .. import sampling, settings
from ..functions import add_diag, cholesky, trtrs
from ..likelihoods import FixedNoiseGaussian
from ..ops.blocked import blocked_trtri
from ..util import as_array
from .base import Predictive, _coerce_io
from .sparse_gpr import _diag_or_full, _low_rank_solve


def _frozen(module):
    """A deep copy of ``module`` whose parameters do not require grad."""
    if module is None:
        return None
    with torch.no_grad():
        out = copy.deepcopy(module)
    for p in out.parameters():
        p.requires_grad_(False)
        p.grad = None
    return out


def _as_inputs(x_new, y_new, X, V):
    """(x_new, y_new) as tensors of the posterior's dtypes on its device,
    y_new as a column when 1-D."""
    x_new = as_array(x_new, dtype=X.dtype, device=X.device)
    y_new = as_array(y_new, dtype=V.dtype, device=V.device)
    return x_new, y_new[:, None] if y_new.ndim == 1 else y_new


def _condition_likelihood(likelihood, nb):
    """The likelihood of the augmented data: a FixedNoiseGaussian's known
    variances extended by zeros for the fantasy rows."""
    if isinstance(likelihood, FixedNoiseGaussian):
        return likelihood.extended(nb)
    return likelihood


def _training_noise(likelihood, n):
    """The training rows' noise variance: per row, (1, n, 1), for a
    FixedNoiseGaussian; else the scalar σ²."""
    if isinstance(likelihood, FixedNoiseGaussian):
        return likelihood.noise_diag(n)[None, :, None]
    return likelihood.variance.value.reshape(())


def _matheron_draws(post, X, dy, n_samples, num_features, generator):
    """The draws of a pathwise sample: the prior path's features φ (drawn
    first) and weights W (n_samples, F, dy), then the training noise ε;
    returns (φ, W, B) with B = f_prior(X) + ε as an (n, dy·n_samples)
    block."""
    n = X.shape[0]
    if generator is None:
        generator = settings.next_default_generator(X.device)
    phi = sampling.RandomFourierFeatures(post.kernel, num_features, generator)
    W = sampling.standard_normal(generator, (n_samples, num_features, dy), X)
    f_prior_X = torch.einsum("sfo,nf->sno", W, phi(X))
    eps = torch.sqrt(_training_noise(post.likelihood, n)) * sampling.standard_normal(generator, (n_samples, n, dy), X)
    return phi, W, (f_prior_X + eps).movedim(0, -1).reshape(n, dy * n_samples)


def _coefficients(alpha_data, U, n_samples):
    """coef_s = K̂⁻¹(y − m(X)) − K̂⁻¹(f_prior(X) + ε_s), (n_samples, n, dy),
    from α and the (n, dy·n_samples) block U = K̂⁻¹B."""
    n, dy = alpha_data.shape
    return alpha_data[None] - U.reshape(n, dy, n_samples).movedim(-1, 0)


def _paths(kernel, mean_function, X, phi, W, coef):
    """``paths(x) -> (n_samples, n*, dy)``: w_sᵀφ(x) + K(x, X)·coef_s + m(x),
    differentiable in a tensor ``x``; numpy in, numpy out."""

    def paths(x):
        if isinstance(x, np.ndarray):
            with torch.no_grad():
                return paths(as_array(x, dtype=X.dtype, device=X.device)).cpu().numpy()
        return (
            torch.einsum("sfo,nf->sno", W, phi(x))
            + torch.einsum("nm,smo->sno", kernel.K(x, X), coef)
            + mean_function(x)[None]
        )

    return paths


class Posterior(Predictive):
    """Base: precomputed factors plus frozen copies of the model pieces
    needed to predict.  Subclasses implement ``_predict(x_new, diag)``."""

    # Queries may be any array-like, as the JAX package's posteriors take.
    _accepts_array_like = True

    def __init__(self, kernel, likelihood, mean_function):
        super().__init__()
        self.kernel = _frozen(kernel)
        self.likelihood = _frozen(likelihood)
        self.mean_function = _frozen(mean_function)

    def _batched(self, x, batch_size, fn):
        parts = [fn(x[lo : lo + batch_size]) for lo in range(0, x.shape[0], batch_size)]
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

    @_coerce_io
    def predict_f_batched(self, x_new, batch_size: int = 4096):
        """Diagonal ``predict_f`` over a large query set, ``batch_size``
        queries at a time: peak memory is one chunk's (n, batch_size)
        cross-Gram instead of (n, n*)."""
        return self._batched(x_new, batch_size, self._predict)

    @_coerce_io
    def predict_y_batched(self, x_new, batch_size: int = 4096):
        """Chunked ``predict_y``; see :meth:`predict_f_batched`."""
        return self._batched(x_new, batch_size, self._predict_y)


class GPRPosterior(Posterior):
    """Exact-GP posterior with cached L = chol(Kyy) and V = L⁻¹(Y − m(X))."""

    def __init__(self, kernel, likelihood, mean_function, X, L, V):
        super().__init__(kernel, likelihood, mean_function)
        self.X = X
        self.L = L
        self.V = V

    def _predict(self, x_new, diag=True):
        k_ys = self.kernel.K(self.X, x_new)
        A = trtrs(k_ys, self.L)
        mean = A.T @ self.V + self.mean_function(x_new)
        if diag:
            var = (self.kernel.Kdiag(x_new) - torch.sum(A * A, dim=0))[:, None].expand(mean.shape)
        else:
            var = self.kernel.K(x_new) - A.T @ A
        return mean, var

    @torch.no_grad()
    def for_serving(self, nb: int = 1024, method: str = "blocked"):
        """One-time L → L⁻¹ conversion, returning a
        :class:`ServingGPRPosterior` whose every predict is matrix products.

        ``method="blocked"`` is the divide-and-conquer
        :func:`~gptorch_tpu_torch.ops.blocked.blocked_trtri`;
        ``method="solve"`` is one triangular solve against the identity."""
        if method == "solve":
            eye = torch.eye(self.L.shape[0], dtype=self.L.dtype, device=self.L.device)
            Linv = torch.linalg.solve_triangular(self.L, eye, upper=False)
        elif method == "blocked":
            Linv = blocked_trtri(self.L, nb=nb)
        else:
            raise ValueError("method must be 'blocked' or 'solve'")
        alpha = Linv.T @ self.V
        return ServingGPRPosterior(self.kernel, self.likelihood, self.mean_function, self.X, Linv, alpha)

    def condition_on(self, x_new, y_new) -> "GPRPosterior":
        """A new posterior that has also observed (x_new, y_new), at fixed
        hyperparameters, by extending the Cholesky factor blockwise:

            L' = [[L, 0], [Aᵀ, L_S]],  A = L⁻¹K(X, X_b),
            L_S = chol(K(X_b) + σ²I − AᵀA),
            V' = [V; L_S⁻¹(y_b − m(X_b) − AᵀV)]

        O(n²·n_b) instead of the O((n + n_b)³) refit.  Every call allocates
        the grown (n + n_b)² factor; for an observe loop use
        :meth:`fantasy_chain`.  A FixedNoiseGaussian's known variances are
        extended by zeros for the new rows (only σ² applies to them)."""
        x_new, y_new = _as_inputs(x_new, y_new, self.X, self.V)
        nb, n = x_new.shape[0], self.X.shape[0]
        A = trtrs(self.kernel.K(self.X, x_new), self.L)  # (n, nb)
        S = add_diag(self.kernel.K(x_new), self.likelihood.variance.value.reshape(())) - A.T @ A
        L_S = cholesky(S)
        V2 = trtrs(y_new - self.mean_function(x_new) - A.T @ self.V, L_S)
        L_aug = self.L.new_zeros((n + nb, n + nb))
        L_aug[:n, :n] = self.L
        L_aug[n:, :n] = A.T
        L_aug[n:, n:] = L_S
        return GPRPosterior(
            self.kernel, _condition_likelihood(self.likelihood, nb), self.mean_function,
            torch.cat([self.X, x_new]), L_aug, torch.cat([self.V, V2]),
        )

    def fantasy_chain(self, capacity: int) -> "FantasyGPRChain":
        """:meth:`condition_on` for a chained observe loop, in buffers of a
        fixed ``capacity`` (the most points n + Σ n_b the chain will
        hold), allocated once; see :class:`FantasyGPRChain`."""
        return FantasyGPRChain.from_posterior(self, capacity)

    @torch.no_grad()
    def sample_paths(self, n_samples: int = 1, num_features: int = 1024, generator=None):
        """Posterior function samples: a callable ``paths(x) ->
        (n_samples, n*, dy)`` that evaluates the same drawn functions at any
        inputs, differentiable in a tensor ``x`` (Wilson et al. 2020,
        Matheron's rule on random-Fourier-feature prior paths):

            f_s(·) = w_sᵀφ(·) + K(·, X)[K̂⁻¹(y − m(X)) − K̂⁻¹(w_sᵀφ(X) + ε_s)] + m(·)

        with K̂⁻¹ = L⁻ᵀL⁻¹ from the cached factor.  The draws come from
        ``generator`` (default:
        :func:`~gptorch_tpu_torch.settings.next_default_generator` on the
        posterior's device)."""
        phi, W, B = _matheron_draws(self, self.X, self.V.shape[1], n_samples, num_features, generator)
        Lt = self.L.mT
        alpha_data = trtrs(self.V, Lt, lower=False)
        U = trtrs(trtrs(B, self.L), Lt, lower=False)
        return _paths(self.kernel, self.mean_function, self.X, phi, W, _coefficients(alpha_data, U, n_samples))


class FantasyGPRChain(Posterior):
    """:meth:`GPRPosterior.condition_on` in preallocated buffers, for an
    observe loop.

    ``Lbuf`` (C, C) holds ``[[L, 0], [0, I]]``: the live factor top-left
    and the identity on the unused trailing diagonal, so a solve against
    the whole buffer is exact for a right-hand side that is zero past
    ``count`` (those rows solve to 0).  ``Xbuf`` and ``Vbuf`` are zero past
    ``count``, a host int.

    Differences from the JAX package, where the chain is an immutable
    pytree run under jit: :meth:`observe` writes into the buffers in place
    and returns the chain itself (an earlier handle is the same object),
    and a batch that would pass the capacity always raises ``ValueError``
    (under jit the JAX package cannot check, and its slice update clamps).
    """

    def __init__(self, kernel, likelihood, mean_function, Xbuf, Lbuf, Vbuf, count: int):
        super().__init__(kernel, likelihood, mean_function)
        self.Xbuf = Xbuf
        self.Lbuf = Lbuf
        self.Vbuf = Vbuf
        self.count = int(count)

    @classmethod
    @torch.no_grad()
    def from_posterior(cls, post: GPRPosterior, capacity: int) -> "FantasyGPRChain":
        if isinstance(post.likelihood, FixedNoiseGaussian):
            raise NotImplementedError(
                "fantasy_chain supports Gaussian likelihoods; for FixedNoiseGaussian use condition_on "
                "(it extends the fixed-noise vector per update)"
            )
        n, C = post.X.shape[0], int(capacity)
        if C < n:
            raise ValueError(f"capacity {C} < current n {n}")
        Xbuf = post.X.new_zeros((C,) + tuple(post.X.shape[1:]))
        Xbuf[:n] = post.X
        Vbuf = post.V.new_zeros((C,) + tuple(post.V.shape[1:]))
        Vbuf[:n] = post.V
        Lbuf = post.L.new_zeros((C, C))
        Lbuf[:n, :n] = post.L
        Lbuf.diagonal()[n:] = 1.0
        return cls(post.kernel, post.likelihood, post.mean_function, Xbuf, Lbuf, Vbuf, n)

    @property
    def capacity(self) -> int:
        return self.Xbuf.shape[0]

    @property
    def X(self):
        """The live inputs, ``Xbuf[:count]``."""
        return self.Xbuf[: self.count]

    def _solve_live(self, x_new):
        """A = Lbuf⁻¹k with k = K(Xbuf, x_new), its rows past ``count``
        zeroed (so A's are exactly 0)."""
        k = self.kernel.K(self.Xbuf, x_new)
        k[self.count :] = 0.0
        return trtrs(k, self.Lbuf)

    @torch.no_grad()
    def observe(self, x_new, y_new) -> "FantasyGPRChain":
        """Condition on the batch (x_new, y_new) at fixed hyperparameters,
        in place (the algebra of :meth:`GPRPosterior.condition_on`);
        returns the chain.  Raises ``ValueError`` when count + n_b would
        pass the capacity."""
        x_new, y_new = _as_inputs(x_new, y_new, self.Xbuf, self.Vbuf)
        nb, cnt = x_new.shape[0], self.count
        if cnt + nb > self.capacity:
            raise ValueError(f"chain full: count {cnt} + batch {nb} > capacity {self.capacity}")
        A = self._solve_live(x_new)  # (C, nb)
        S = add_diag(self.kernel.K(x_new), self.likelihood.variance.value.reshape(())) - A.T @ A
        L_S = cholesky(S)
        V2 = trtrs(y_new - self.mean_function(x_new) - A.T @ self.Vbuf, L_S)
        # rows [cnt, cnt + nb): Aᵀ full width (its columns from cnt on are
        # 0, clearing that span's identity), then the diagonal block L_S
        self.Lbuf[cnt : cnt + nb] = A.T
        self.Lbuf[cnt : cnt + nb, cnt : cnt + nb] = L_S
        self.Vbuf[cnt : cnt + nb] = V2
        self.Xbuf[cnt : cnt + nb] = x_new
        self.count = cnt + nb
        return self

    def _predict(self, x_new, diag=True):
        A = self._solve_live(x_new)
        mean = A.T @ self.Vbuf + self.mean_function(x_new)
        if diag:
            var = (self.kernel.Kdiag(x_new) - torch.sum(A * A, dim=0))[:, None].expand(mean.shape)
        else:
            var = self.kernel.K(x_new) - A.T @ A
        return mean, var

    def posterior(self) -> GPRPosterior:
        """A :class:`GPRPosterior` of the live prefix.  Its X, L and V are
        views of the chain's buffers, which later observes write only past."""
        n = self.count
        return GPRPosterior(
            self.kernel, self.likelihood, self.mean_function, self.Xbuf[:n], self.Lbuf[:n, :n], self.Vbuf[:n]
        )


class ServingGPRPosterior(Posterior):
    """Exact-GP serving posterior built from L⁻¹ and α = K̂⁻¹(Y − m(X)):

        mean = K(x*, X) α + m(x*)
        W    = L⁻¹ K(X, x*)
        var  = Kdiag − ΣW²   /   K** − WᵀW             (diag / full)

    The same algebra as :class:`GPRPosterior` with the triangular solve
    replaced by a product, so the moments agree to factorization roundoff."""

    def __init__(self, kernel, likelihood, mean_function, X, Linv, alpha):
        super().__init__(kernel, likelihood, mean_function)
        self.X = X
        self.Linv = Linv
        self.alpha = alpha

    def _predict(self, x_new, diag=True):
        k_xs = self.kernel.K(self.X, x_new)
        mean = k_xs.T @ self.alpha + self.mean_function(x_new)
        W = self.Linv @ k_xs
        if diag:
            var = (self.kernel.Kdiag(x_new) - torch.sum(W * W, dim=0))[:, None].expand(mean.shape)
        else:
            var = self.kernel.K(x_new) - W.T @ W
        return mean, var

    @_coerce_io
    def mean_only(self, x_new):
        """Mean prediction alone: one cross-Gram and one product, no n²
        term."""
        return self.kernel.K(x_new, self.X) @ self.alpha + self.mean_function(x_new)

    @torch.no_grad()
    def sample_paths(self, n_samples: int = 1, num_features: int = 1024, generator=None):
        """Posterior function samples from the serving artifact:
        :meth:`GPRPosterior.sample_paths` with K̂⁻¹B = L⁻ᵀ(L⁻¹B) as two
        products against the cached L⁻¹ and K̂⁻¹(y − m(X)) the cached α."""
        phi, W, B = _matheron_draws(self, self.X, self.alpha.shape[1], n_samples, num_features, generator)
        U = self.Linv.T @ (self.Linv @ B)
        return _paths(self.kernel, self.mean_function, self.X, phi, W, _coefficients(self.alpha, U, n_samples))

    def condition_on(self, x_new, y_new) -> "ServingGPRPosterior":
        """:meth:`GPRPosterior.condition_on` that keeps the serving form:
        the inverse factor is extended blockwise,

            L'⁻¹ = [[L⁻¹, 0], [−L_S⁻¹AᵀL⁻¹, L_S⁻¹]],  A = L⁻¹K(X, X_b),
            L_S  = chol(K(X_b) + σ²I − AᵀA),

        and, with V₂ = L_S⁻¹(y_b − m(X_b) − K(X_b, X)α), α' = [α + llᵀV₂;
        L_S⁻ᵀV₂] (ll the new row block of L'⁻¹): products only, apart from
        the (n_b, n_b) factorization."""
        x_new, y_new = _as_inputs(x_new, y_new, self.X, self.alpha)
        nb, n = x_new.shape[0], self.X.shape[0]
        Kxb = self.kernel.K(self.X, x_new)  # (n, nb)
        A = self.Linv @ Kxb
        S = add_diag(self.kernel.K(x_new), self.likelihood.variance.value.reshape(())) - A.T @ A
        L_S = cholesky(S)
        Lsi = trtrs(torch.eye(nb, dtype=L_S.dtype, device=L_S.device), L_S)
        ll = -Lsi @ (A.T @ self.Linv)  # (nb, n)
        V2 = Lsi @ (y_new - self.mean_function(x_new) - Kxb.T @ self.alpha)
        Linv_aug = self.Linv.new_zeros((n + nb, n + nb))
        Linv_aug[:n, :n] = self.Linv
        Linv_aug[n:, :n] = ll
        Linv_aug[n:, n:] = Lsi
        return ServingGPRPosterior(
            self.kernel, _condition_likelihood(self.likelihood, nb), self.mean_function,
            torch.cat([self.X, x_new]), Linv_aug, torch.cat([self.alpha + ll.T @ V2, Lsi.T @ V2]),
        )


class IterativeGPRPosterior(Posterior):
    """Matrix-free exact-GP posterior: α = K̂⁻¹(Y − m(X)) obtained by
    preconditioned CG (cached); predictions never store K.

        mean = K(x*, X) α + m(x*)
        var  = Kdiag(x*) − Σ (K(X, x*) ⊙ K̂⁻¹K(X, x*))   (diag; a CG solve per call)

    With a LOVE cache (``R_love``, :func:`~gptorch_tpu_torch.ops.iterative.lanczos_root_inverse`)
    the variance solve is replaced by the cached rank-k root K̂⁻¹ ≈ R Rᵀ:

        var  = Kdiag(x*) − Σ (Rᵀ K(X, x*))²               (one product, no CG)
    """

    def __init__(self, kernel, likelihood, mean_function, X, alpha, kind, fast_jitter, mvm_slab, max_cg_iters,
                 cg_tol, Lpc, R_love=None):
        super().__init__(kernel, likelihood, mean_function)
        self.X = X
        self.alpha = alpha  # (n, dy) = K̂⁻¹ (Y − m(X))
        self.kind = kind
        self.fast_jitter = fast_jitter
        self.mvm_slab = mvm_slab
        self.max_cg_iters = max_cg_iters
        self.cg_tol = cg_tol
        self.Lpc = Lpc  # the pivoted-Cholesky preconditioner's factor (n, k)
        # rq's log α, read from the frozen kernel like the other hyperparameters
        self.log_extra = self.kernel.alpha.raw.reshape((1,)) if kind == "rq" else None
        self.R_love = R_love  # the LOVE root-inverse cache (n, love_rank), or None

    def _solve(self, B):
        from ..ops.iterative import mbcg, radial_mvm, woodbury_solve

        le = self.kernel.length_scales.raw
        lv = self.kernel.variance.raw.reshape(())
        ln = self.likelihood.variance.raw.reshape(())
        noise = torch.exp(ln) + self.fast_jitter
        X, *_ = mbcg(
            lambda V: radial_mvm(self.kind, le, lv, ln, self.X, V, self.fast_jitter, self.mvm_slab, self.log_extra),
            lambda V: woodbury_solve(self.Lpc, noise, V),
            B,
            self.max_cg_iters,
            self.cg_tol,
        )
        return X

    def _predict(self, x_new, diag=True):
        k_xs = self.kernel.K(self.X, x_new)  # (n, n*)
        mean = k_xs.T @ self.alpha + self.mean_function(x_new)
        if self.R_love is not None:
            W2 = self.R_love.T @ k_xs  # (love_rank, n*): the only per-query solve work
            if diag:
                return mean, (self.kernel.Kdiag(x_new) - torch.sum(W2 * W2, dim=0))[:, None].expand(mean.shape)
            return mean, self.kernel.K(x_new) - W2.T @ W2
        W = self._solve(k_xs)  # K̂⁻¹ K(X, x*)
        if diag:
            return mean, (self.kernel.Kdiag(x_new) - torch.sum(k_xs * W, dim=0))[:, None].expand(mean.shape)
        return mean, self.kernel.K(x_new) - k_xs.T @ W


@torch.no_grad()
def iterative_gpr_posterior(model, love_rank=None) -> IterativeGPRPosterior:
    """The matrix-free posterior of a ``solver="iterative"`` GPR: the
    preconditioner, α by CG, and with ``love_rank`` the LOVE factor from
    that many Lanczos steps started at the model's first probe seed."""
    from ..ops.iterative import lanczos_root_inverse, pivoted_cholesky, radial_mvm

    kind, le, lv, ln, log_extra = model._iterative_args()
    Lpc = pivoted_cholesky(kind, le, lv, model.X, model.precond_rank, log_extra)
    R_love = None
    if love_rank:
        R_love = lanczos_root_inverse(
            lambda V: radial_mvm(kind, le, lv, ln, model.X, V, model.fast_jitter, model.mvm_slab, log_extra),
            model.probe_seeds[: model.X.shape[0], 0].to(model.X.dtype),
            int(min(love_rank, model.X.shape[0])),
        )
    post = IterativeGPRPosterior(
        model.kernel, model.likelihood, model.mean_function, model.X, torch.zeros_like(model.Y), kind,
        model.fast_jitter, model.mvm_slab, model.max_cg_iters, model.cg_tol, Lpc, R_love,
    )
    post.alpha = post._solve(model.Y - post.mean_function(model.X))
    return post


def _gpr_factors(model):
    L = cholesky(model._compute_kyy(), blocked=False)
    V = trtrs(model.Y - model.mean_function(model.X), L)
    return L, V


@torch.no_grad()
def gpr_posterior(model) -> GPRPosterior:
    """Factorize ``model`` once into a :class:`GPRPosterior`."""
    L, V = _gpr_factors(model)
    return GPRPosterior(model.kernel, model.likelihood, model.mean_function, model.X, L, V)


class LowRankPosterior(Posterior):
    """Sparse (VFE, FITC) posterior with cached L = chol(Kuu),
    LB = chol(B) and c; each predict is O(m²·n*)."""

    def __init__(self, kernel, likelihood, mean_function, Z, L, LB, c):
        super().__init__(kernel, likelihood, mean_function)
        self.Z = Z
        self.L = L
        self.LB = LB
        self.c = c

    @torch.no_grad()
    def for_serving(self, nb: int = 1024):
        """E₁ = L⁻¹, E₂ = LB⁻¹L⁻¹ and w = E₂ᵀc, once →
        :class:`ServingLowRankPosterior`."""
        E1 = blocked_trtri(self.L, nb=nb)
        E2 = blocked_trtri(self.LB, nb=nb) @ E1
        return ServingLowRankPosterior(
            self.kernel, self.likelihood, self.mean_function, self.Z, E1, E2, E2.T @ self.c
        )

    def _predict(self, x_new, diag=True):
        Kus = self.kernel.K(self.Z, x_new)
        tmp1 = trtrs(Kus, self.L)
        tmp2 = trtrs(tmp1, self.LB)
        mean = tmp2.T @ self.c
        if self.mean_function is not None:
            mean = mean + self.mean_function(x_new)
        return mean, _diag_or_full(self.kernel, x_new, mean, tmp1, tmp2, diag)


class ServingLowRankPosterior(Posterior):
    """Sparse serving posterior from E₁ = L⁻¹, E₂ = LB⁻¹L⁻¹ and w = E₂ᵀc:
    each predict is two (m, m)×(m, n*) products, no triangular solve."""

    def __init__(self, kernel, likelihood, mean_function, Z, E1, E2, w):
        super().__init__(kernel, likelihood, mean_function)
        self.Z = Z
        self.E1 = E1
        self.E2 = E2
        self.w = w

    def _predict(self, x_new, diag=True):
        Kus = self.kernel.K(self.Z, x_new)
        mean = Kus.T @ self.w
        if self.mean_function is not None:
            mean = mean + self.mean_function(x_new)
        return mean, _diag_or_full(self.kernel, x_new, mean, self.E1 @ Kus, self.E2 @ Kus, diag)


class SVGPPosterior(Posterior):
    """SVGP posterior with cached L = chol(Kuu), L⁻¹m_u and β = L⁻¹L_q."""

    def __init__(self, kernel, likelihood, mean_function, Z, L, Linv_m, beta):
        super().__init__(kernel, likelihood, mean_function)
        self.Z = Z
        self.L = L
        self.Linv_m = Linv_m
        self.beta = beta

    @torch.no_grad()
    def for_serving(self, nb: int = 1024):
        """E₁ = L⁻¹, G = βᵀE₁ and w = E₁ᵀ(L⁻¹m_u), once →
        :class:`ServingSVGPPosterior`."""
        E1 = blocked_trtri(self.L, nb=nb)
        return ServingSVGPPosterior(
            self.kernel, self.likelihood, self.mean_function, self.Z, E1, self.beta.T @ E1, E1.T @ self.Linv_m
        )

    def _predict(self, x_new, diag=True):
        alpha_t = trtrs(self.kernel.K(self.Z, x_new), self.L)  # (m, n*)
        mean = alpha_t.T @ self.Linv_m + self.mean_function(x_new)
        return mean, _diag_or_full(self.kernel, x_new, mean, alpha_t, self.beta.T @ alpha_t, diag)


class ServingSVGPPosterior(Posterior):
    """SVGP serving posterior from E₁ = L⁻¹, G = (L⁻¹L_q)ᵀL⁻¹ and
    w = L⁻ᵀ(L⁻¹m_u): each predict is two (m, m)×(m, n*) products."""

    def __init__(self, kernel, likelihood, mean_function, Z, E1, G, w):
        super().__init__(kernel, likelihood, mean_function)
        self.Z = Z
        self.E1 = E1
        self.G = G
        self.w = w

    def _predict(self, x_new, diag=True):
        kuf = self.kernel.K(self.Z, x_new)
        mean = kuf.T @ self.w + self.mean_function(x_new)
        return mean, _diag_or_full(self.kernel, x_new, mean, self.E1 @ kuf, self.G @ kuf, diag)


@torch.no_grad()
def vfe_posterior(model) -> LowRankPosterior:
    """Factorize a VFE model once into a :class:`LowRankPosterior`."""
    z = model.Z.value.detach().clone()
    L, LB, c = _low_rank_solve(model, z, model.X, model._sigma2())
    return LowRankPosterior(model.kernel, model.likelihood, model.mean_function, z, L, LB, c)


@torch.no_grad()
def fitc_posterior(model) -> LowRankPosterior:
    """Factorize a FITC model once into a :class:`LowRankPosterior`."""
    z = model.Z.value.detach().clone()
    L, LB, c = _low_rank_solve(model, z, model.X, None)
    return LowRankPosterior(model.kernel, model.likelihood, model.mean_function, z, L, LB, c)


@torch.no_grad()
def svgp_posterior(model) -> SVGPPosterior:
    """Factorize an SVGP model once into an :class:`SVGPPosterior`; a
    whitened q is already in L⁻¹-space."""
    z = model.Z.value.detach().clone()
    L = cholesky(model._kuu(z), blocked=False)
    if model.whiten:  # clones: an Identity bijector's value is the parameter itself
        Linv_m = model.induced_output_mean.value.clone()
        beta = model.induced_output_chol_cov.value.clone()
    else:
        Linv_m = trtrs(model.induced_output_mean.value, L)
        beta = trtrs(model.induced_output_chol_cov.value, L)
    return SVGPPosterior(model.kernel, model.likelihood, model.mean_function, z, L, Linv_m, beta)


@torch.no_grad()
def gplvm_posterior(model) -> LowRankPosterior:
    """Factorize a GPLVM once into a :class:`LowRankPosterior` over its
    latent space (no mean function: the GPLVM's is zero)."""
    L, LB, c = model._posterior()
    return LowRankPosterior(model.kernel, model.likelihood, None, model.Z.value.detach().clone(), L, LB, c)


class GridGPRPosterior(Posterior):
    """Cached Kronecker-GP posterior: the per-axis eigenvectors and the alpha
    grid are computed once; each predict is O(nt·Σn_d + nt·N)."""

    def __init__(self, kernels, likelihood, axes, alpha, qs, lam):
        super().__init__(None, likelihood, None)
        self.n_axes = len(kernels)
        for d, (k, a, q) in enumerate(zip(kernels, axes, qs)):
            setattr(self, f"kern{d}", _frozen(k))
            setattr(self, f"axis{d}", a)
            setattr(self, f"q{d}", q)
        self.alpha = alpha  # grid-shaped (n_1, ..., n_D, dy)
        self.lam = lam  # (N,) Kronecker eigenvalues

    def _input_reference(self):
        return self.axis0

    def _pieces(self):
        return tuple([getattr(self, f"{name}{d}") for d in range(self.n_axes)] for name in ("kern", "axis", "q"))

    def _predict(self, x_new, diag=True):
        from .kronecker import grid_predict

        ks, axs, qs = self._pieces()
        sigma2 = self.likelihood.variance.value.reshape(())
        return grid_predict(ks, axs, qs, self.alpha, self.lam, sigma2, x_new, diag)


class ICMPosterior(Posterior):
    """Cached ICM posterior: the input-space and coregionalization
    eigendecompositions (the O(n³ + p³) work) once; each predict is
    O(nt·n·p) (diagonal) or O((nt·p)²·n·p) (joint)."""

    def __init__(self, kernel, likelihood, X, alpha, lx, qx, lb, qb, B):
        super().__init__(kernel, likelihood, None)
        self.X = X
        self.alpha = alpha  # (n, p) = K_joint⁻¹ vec(Y) in matrix form
        self.lx, self.qx, self.lb, self.qb, self.B = lx, qx, lb, qb, B

    def _pieces(self):
        return (self.alpha, self.lx, self.qx, self.lb, self.qb, self.B,
                self.likelihood.variance.value.reshape(()))

    def _predict(self, x_new, diag=True):
        from .multioutput import _icm_predict

        if not diag:
            raise NotImplementedError(
                "ICM full joint covariance across points AND outputs: use predict_f_joint(x_new)"
            )
        return _icm_predict(self.kernel, self.X, *self._pieces(), x_new)

    @_coerce_io
    def predict_f_joint(self, x_new):
        """Joint (point × output) posterior; see ``ICM.predict_f_joint``."""
        from .multioutput import _icm_joint

        return _icm_joint(self.kernel, self.X, *self._pieces(), x_new)

    def predict_f_joint_samples(self, x_new, n_samples: int = 1, generator=None):
        """Output-correlated joint draws (S, nt, p) from the cached
        eigendecompositions."""
        from .multioutput import _joint_samples

        return _joint_samples(self, x_new, n_samples, generator)


class LMCPosterior(Posterior):
    """LMC posterior: per latent the cached chol(Kuu_l), L⁻¹m_l and
    L⁻¹L_ql, mixed by W; each predict is O(L·m²·n*)."""

    def __init__(self, kernels, likelihood, mean_function, Z, Ls, Linv_ms, betas, W):
        super().__init__(kernels, likelihood, mean_function)
        self.Z = Z
        self.Ls = Ls  # (L, m, m)
        self.Linv_ms = Linv_ms  # (m, L)
        self.betas = betas  # (L, m, m)
        self.W = W  # (p, L)

    @property
    def kernels(self):
        return self.kernel

    def _predict(self, x_new, diag=True):
        if not diag:
            raise NotImplementedError("LMC full joint covariance: use diag")
        mus, svars = [], []
        for l, k in enumerate(self.kernels):
            alpha = trtrs(k.K(self.Z, x_new), self.Ls[l]).T  # (n*, m)
            gamma = alpha @ self.betas[l]
            mus.append(alpha @ self.Linv_ms[:, l])
            svars.append(k.Kdiag(x_new) - torch.sum(torch.square(alpha), dim=1)
                         + torch.sum(torch.square(gamma), dim=1))
        mu = torch.stack(mus, dim=1)  # (n*, L)
        s = torch.stack(svars, dim=1)
        return mu @ self.W.T + self.mean_function(x_new), s @ torch.square(self.W).T


@torch.no_grad()
def lmc_posterior(model) -> LMCPosterior:
    """Factorize an LMC's L latents once into an :class:`LMCPosterior`."""
    z = model.Z.value.detach().clone()
    Ls, Linv_ms, betas = [], [], []
    for l, k in enumerate(model.kernels):
        L = cholesky(model._kuu(z, k))
        Ls.append(L)
        Linv_ms.append(trtrs(model.q_mu.value[:, l : l + 1], L)[:, 0])
        betas.append(trtrs(model.q_chol.value[l], L))
    return LMCPosterior(model.kernels, model.likelihood, model.mean_function, z, torch.stack(Ls),
                        torch.stack(Linv_ms, dim=1), torch.stack(betas), model.W.value.detach().clone())
