"""Covariance kernels.

Counterpart of ``gptorch_tpu/kernels.py``: White, Constant/Bias,
Exp/Matern12, Matern32, Matern52, Rbf, RationalQuadratic, Periodic (the
reference's cosine-of-distance quirk), ExpSinSquared, SpectralMixture (with
:func:`spectral_mixture_init`), Linear, Polynomial, ActiveDims, DeepKernel,
InputWarp, MultiFidelity (with :func:`add_fidelity`), Cosine, ArcCosine,
ChangePoints, Coregion, Sum and Product, with the same parameterizations,
the same Param paths and the same ARD length scales and variances.

:class:`Rbf` on a CUDA tensor builds its Gram with the hand-written kernel
of :mod:`gptorch_tpu_torch.ops.gram`; the other kernels are plain
PyTorch on every device, as they are plain XLA in the JAX package.  The
JAX package builds an (n, m, d) difference tensor for ExpSinSquared (ARD)
and SpectralMixture, which XLA fuses away; here they accumulate over the d
dimensions in (n, m) buffers, in row blocks when no gradient is recorded
(:func:`_by_rows`), which computes the same function within rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .module import Module
from .ops.gram import rbf_gram
from .param import Param, positive_param
from .util import as_array, squared_distance


def _k_shape(X, X2):
    n1 = X.shape[0]
    return (n1, n1) if X2 is None else (n1, X2.shape[0])


def _scalar(p):
    """A Param's value as a 0-d tensor."""
    return p.value.reshape(())


#: Most elements of one row block of :func:`_by_rows` on the card (2²⁷:
#: 0.5 GB in float32) and on the CPU (2¹⁸: 2 MB in float64, so a block's
#: chain of elementwise passes runs in cache -- six times faster than one
#: pass at n = 4096).
_BLOCK_ELEMENTS = 2 ** 27
_CPU_BLOCK_ELEMENTS = 2 ** 18


def _by_rows(block, X, X2):
    """``block(X)`` for a Gram against ``X2`` (``block`` takes rows of X
    and returns their (rows, m) Gram).  With a gradient recorded, or when
    all of X fits one block, one call; otherwise row blocks written into
    one output, so a kernel's (rows, m) temporaries stay within a block
    per buffer."""
    n, m = X.shape[0], X2.shape[0]
    most = _CPU_BLOCK_ELEMENTS if X.device.type == "cpu" else _BLOCK_ELEMENTS
    rows = max(1, most // max(m, 1))
    if n <= rows or torch.is_grad_enabled():
        return block(X)
    first = block(X[:rows])
    out = first.new_empty((n, m))
    out[:rows] = first
    del first
    for lo in range(rows, n, rows):
        out[lo : lo + rows] = block(X[lo : lo + rows])
    return out


class Kernel(Module):
    """Base class: K(X, X2=None) -> (n1, n2) Gram matrix; Kdiag(X) -> (n,).

    Supports ``+`` and ``*`` composition."""

    def __init__(self, input_dim: int):
        super().__init__()
        self.input_dim = int(input_dim)

    def K(self, X, X2=None):
        raise NotImplementedError

    def Kdiag(self, X):
        raise NotImplementedError

    def pair(self, a, b):
        """k(a, b) for two single inputs (d,), a 0-d tensor, in torch ops
        that ``torch.func`` differentiates in either mode: what the
        derivative GP's ∂k and ∂²k blocks are taken of (a Gram kernel such
        as K1 has no forward-mode rule).  By default ``K`` on the two rows;
        Rbf gives its scalar formula, and every kernel that holds others
        (sums, products, the wrappers, ChangePoints, MultiFidelity) composes
        their ``pair``, so none reaches the Gram kernel."""
        return self.K(a[None, :], b[None, :])[0, 0]

    def _validate_ard_shape(self, x, ARD=None):
        """Broadcast a scalar-or-vector hyperparameter against input_dim;
        ``ARD=None`` infers it from the value's shape."""
        if ARD is None:
            ARD = np.asarray(x).squeeze().shape != ()
        x = np.asarray(x) * np.ones(self.input_dim)
        if x.shape != (self.input_dim,):
            raise ValueError("shape of possibly-ARD param does not match input_dim")
        return x, bool(ARD)

    def __add__(self, other):
        return Sum(self, other)

    def __mul__(self, other):
        return Product(self, other)


class Static(Kernel):
    """Input-independent kernels: only a variance parameter."""

    def __init__(self, input_dim: int, variance: float = 1.0):
        super().__init__(input_dim)
        self.variance = positive_param(as_array(variance))

    def Kdiag(self, X):
        return _scalar(self.variance).expand(X.shape[0])


class White(Static):
    """σ²·I for K(X); zeros for a cross-covariance."""

    def K(self, X, X2=None):
        var = _scalar(self.variance)
        if X2 is None:
            return torch.diag_embed(var.expand(X.shape[0]))
        return torch.zeros(_k_shape(X, X2), dtype=var.dtype, device=var.device)


class Constant(Static):
    """Constant (bias) kernel."""

    def K(self, X, X2=None):
        return _scalar(self.variance).expand(_k_shape(X, X2))


class Bias(Constant):
    pass


class Stationary(Kernel):
    """Base for kernels of r = ||x - x'|| / ℓ, with optional ARD."""

    def __init__(self, input_dim: int, variance: float = 1.0, length_scales=None, ARD: bool = False):
        super().__init__(input_dim)
        self.variance = positive_param(as_array(variance))
        self.ARD = bool(ARD)
        if ARD:
            if length_scales is None:
                length_scales = np.ones(input_dim)
            elif isinstance(length_scales, (np.ndarray, list, tuple)):
                length_scales = np.asarray(length_scales, dtype=float)
                if len(length_scales) != input_dim:
                    raise ValueError("ARD length_scales must have input_dim entries")
            else:
                length_scales = float(length_scales) * np.ones(input_dim)
            self.length_scales = positive_param(as_array(length_scales))
        else:
            if length_scales is None:
                length_scales = 1.0
            self.length_scales = positive_param(as_array(float(length_scales)))

    def squared_dist(self, X, X2=None):
        """Length-scale-scaled squared distances."""
        ell = self.length_scales.value
        return squared_distance(X / ell) if X2 is None else squared_distance(X / ell, X2 / ell)

    def dist(self, X, X2=None):
        """Scaled distance, clamped before the sqrt so its gradient stays
        finite at r = 0.  The floor is the dtype's smallest normal number
        (1e-40 is subnormal in float32 and flushes to 0)."""
        r2 = self.squared_dist(X, X2)
        floor = max(1e-40, float(torch.finfo(r2.dtype).tiny))
        return torch.sqrt(torch.clamp(r2, min=floor))

    def Kdiag(self, X):
        return _scalar(self.variance).expand(X.shape[0])


class Exp(Stationary):
    """k(r) = σ² exp(-r)."""

    def K(self, X, X2=None):
        return _scalar(self.variance) * torch.exp(-self.dist(X, X2))


class Matern12(Exp):
    pass


class Matern32(Stationary):
    """k(r) = σ² (1 + √3 r) exp(-√3 r)."""

    def K(self, X, X2=None):
        r3 = math.sqrt(3.0) * self.dist(X, X2)
        return _scalar(self.variance) * (1.0 + r3) * torch.exp(-r3)


class Matern52(Stationary):
    """k(r) = σ² (1 + √5 r + 5r²/3) exp(-√5 r)."""

    def K(self, X, X2=None):
        r = self.dist(X, X2)
        s5 = math.sqrt(5.0)
        return _scalar(self.variance) * (1.0 + s5 * r + (5.0 / 3.0) * r * r) * torch.exp(-s5 * r)


class Rbf(Stationary):
    """Squared exponential: k = σ² exp(-r²/2).

    The Gram goes through :func:`gptorch_tpu_torch.ops.gram.rbf_gram`: the
    hand-written kernel on a CUDA tensor, its plain twin (the same
    arithmetic as :meth:`squared_dist`) on the CPU.  Inputs are scaled by
    division, ``X / ℓ``, as in the JAX package's generic path.
    """

    def K(self, X, X2=None, diag=None):
        """:param diag: added on the diagonal of the symmetric Gram (the
        noise variance of ``K(X, X) + σ²I``), fused into the kernel's write
        on the card.

        ``X`` (B, n1, d) and ``X2`` (B, n2, d) give the B Grams (B, n1, n2)
        in one launch (the Vecchia GP's neighbour Grams)."""
        ell = self.length_scales.value
        x2 = None if X2 is None else (X2 / ell).contiguous()
        return rbf_gram((X / ell).contiguous(), x2, var=_scalar(self.variance), diag=diag)

    def pair(self, a, b):
        """σ² exp(−½ Σ((a − b)/ℓ)²) in torch ops (see :meth:`Kernel.pair`)."""
        r2 = torch.sum(torch.square((a - b) / self.length_scales.value))
        return _scalar(self.variance) * torch.exp(-0.5 * r2)


SquaredExponential = Rbf


class RationalQuadratic(Stationary):
    """k(r) = σ² (1 + r²/(2α))^(-α)."""

    def __init__(self, input_dim: int, variance: float = 1.0, length_scales=None, alpha: float = 1.0, ARD: bool = False):
        super().__init__(input_dim, variance, length_scales, ARD)
        self.alpha = positive_param(as_array(float(alpha)))

    def K(self, X, X2=None):
        r2 = self.squared_dist(X, X2)
        a = _scalar(self.alpha)
        return _scalar(self.variance) * torch.pow(1.0 + r2 / (2.0 * a), -a)


class Periodic(Stationary):
    """The reference gptorch's ``Periodic``, kept as the JAX package keeps
    it: a cosine of the scaled distance, k(r) = σ² cos(r).  The standard
    periodic kernel is :class:`ExpSinSquared`."""

    def K(self, X, X2=None):
        return _scalar(self.variance) * torch.cos(self.dist(X, X2))


class ExpSinSquared(Stationary):
    """The standard periodic kernel, k = σ² exp(−2 sin²(π r / p) / ℓ²) with
    a trainable period p, on unscaled distances; with ARD the per-dimension
    form σ² exp(−2 Σ_q sin²(π Δx_q / p) / ℓ_q²), accumulated over q in
    (n, m) buffers (:func:`_by_rows`)."""

    def __init__(self, input_dim: int, variance: float = 1.0, length_scales=None, period: float = 1.0,
                 ARD: bool = False):
        super().__init__(input_dim, variance, length_scales, ARD)
        self.period = positive_param(as_array(float(period)))

    def K(self, X, X2=None):
        X2v = X if X2 is None else X2
        p = _scalar(self.period)
        var = _scalar(self.variance)
        if self.ARD:
            ell = self.length_scales.value

            def block(x1):
                acc = None
                for q in range(self.input_dim):
                    s = torch.sin(math.pi * (x1[:, q : q + 1] - X2v[:, q]) / p) / ell[q]
                    acc = s * s if acc is None else acc + s * s
                return var * torch.exp(-2.0 * acc)

            return _by_rows(block, X, X2v)
        r2 = squared_distance(X, X2v)
        floor = max(1e-40, float(torch.finfo(r2.dtype).tiny))
        s = torch.sin(math.pi * torch.sqrt(torch.clamp(r2, min=floor)) / p) / _scalar(self.length_scales)
        return var * torch.exp(-2.0 * s * s)


class SpectralMixture(Kernel):
    """Spectral mixture kernel (Wilson & Adams 2013):

        k(τ) = Σ_q w_q · exp(−2π² Σ_d τ_d² v_qd) · Π_d cos(2π τ_d μ_qd),  τ = x − x',

    with positive mixture weights ``weights`` (Q,), spectral means
    ``means`` (Q, d) and spectral variances ``scales`` (Q, d).  Each
    component accumulates over d in (n, m) buffers (:func:`_by_rows`).
    :func:`spectral_mixture_init` gives the data-driven initialization."""

    def __init__(self, input_dim: int, num_mixtures: int = 4, weights=None, means=None, scales=None):
        super().__init__(input_dim)
        Q = int(num_mixtures)
        if Q < 1:
            raise ValueError("num_mixtures must be >= 1")
        self.num_mixtures = Q
        d = self.input_dim
        weights = np.ones(Q) / Q if weights is None else np.asarray(weights, float)
        means = np.linspace(0.1, 1.0, Q)[:, None] * np.ones((1, d)) if means is None else np.asarray(means, float)
        scales = np.ones((Q, d)) if scales is None else np.asarray(scales, float)
        if weights.shape != (Q,) or means.shape != (Q, d) or scales.shape != (Q, d):
            raise ValueError(
                f"expected weights (Q,)={Q,}, means/scales (Q, d)=({Q}, {d}); "
                f"got {weights.shape}, {means.shape}, {scales.shape}"
            )
        self.weights = positive_param(as_array(weights))
        self.means = positive_param(as_array(means))
        self.scales = positive_param(as_array(scales))

    def K(self, X, X2=None):
        X2v = X if X2 is None else X2
        w, mu, v = self.weights.value, self.means.value, self.scales.value
        two_pi = 2.0 * math.pi

        def block(x1):
            out = None
            for q in range(self.num_mixtures):
                arg = c = None
                for j in range(self.input_dim):
                    tau = x1[:, j : j + 1] - X2v[:, j]
                    t = tau * tau * v[q, j]
                    arg = t if arg is None else arg + t
                    cj = torch.cos(two_pi * tau * mu[q, j])
                    c = cj if c is None else c * cj
                term = w[q] * torch.exp(-2.0 * math.pi ** 2 * arg) * c
                out = term if out is None else out + term
            return out

        return _by_rows(block, X, X2v)

    def Kdiag(self, X):
        return torch.sum(self.weights.value).expand(X.shape[0])


def spectral_mixture_init(X, Y, num_mixtures: int = 4, seed: int = 0) -> SpectralMixture:
    """The JAX package's data-driven :class:`SpectralMixture` start, on the
    host with the same ``np.random.RandomState(seed)`` draws: spectral
    means ~ U(0, ν_d/2) with ν_d the per-dimension Nyquist frequency
    1/(2·median spacing), spectral variances (U(0.5, 2)/range_d)², and
    weights var(Y)/Q."""
    X = np.asarray(X.detach().cpu() if isinstance(X, torch.Tensor) else X, dtype=float)
    Y = np.asarray(Y.detach().cpu() if isinstance(Y, torch.Tensor) else Y, dtype=float)
    n, d = X.shape
    Q = int(num_mixtures)
    rng = np.random.RandomState(seed)
    spacing, rang = np.empty(d), np.empty(d)
    for j in range(d):
        xs = np.sort(X[:, j])
        diffs = np.diff(xs)
        diffs = diffs[diffs > 0]
        spacing[j] = np.median(diffs) if diffs.size else 1.0
        rang[j] = max(xs[-1] - xs[0], 1e-12)
    nyquist = 1.0 / (2.0 * spacing)
    means = np.maximum(rng.uniform(0.0, 0.5, size=(Q, d)) * nyquist[None, :], 1e-8)
    scales = (rng.uniform(0.5, 2.0, size=(Q, d)) / rang[None, :]) ** 2
    weights = np.full(Q, max(Y.var(), 1e-12) / Q)
    return SpectralMixture(d, Q, weights=weights, means=means, scales=scales)


class Linear(Kernel):
    """k(x, x') = Σ_q σ²_q x_q x'_q, with per-dimension (ARD) variances.

    The Gram is one product, as in the JAX package, which leaves it to XLA
    outside any Pallas kernel."""

    def __init__(self, input_dim: int, variance=1.0, ARD=None):
        super().__init__(input_dim)
        variance, self.ARD = self._validate_ard_shape(variance, ARD)
        self.variance = positive_param(as_array(variance))

    def K(self, X, X2=None):
        other = X if X2 is None else X2
        return (X * self.variance.value) @ other.T

    def Kdiag(self, X):
        return torch.sum(X * X * self.variance.value, dim=1)


class Polynomial(Linear):
    """k(x, x') = (Σ_q σ²_q x_q x'_q + b)^p with ARD variances (from
    :class:`Linear`), a trainable offset b > 0 and a static integer degree
    p ≥ 1.  The base can be negative, so the exponent is a Python int:
    ``torch.pow`` then takes the exact integer power (and its gradient
    p·base^(p−1)), never exp·log."""

    def __init__(self, input_dim: int, degree: int = 2, variance=1.0, offset: float = 1.0, ARD=None):
        super().__init__(input_dim, variance=variance, ARD=ARD)
        if int(degree) < 1:
            raise ValueError("degree must be >= 1")
        self.degree = int(degree)
        self.offset = positive_param(as_array(float(offset)))

    def K(self, X, X2=None):
        return torch.pow(super().K(X, X2) + _scalar(self.offset), self.degree)

    def Kdiag(self, X):
        return torch.pow(super().Kdiag(X) + _scalar(self.offset), self.degree)


class ActiveDims(Kernel):
    """A base kernel on a fixed subset of the input columns,
    k(x, x') = base(x[dims], x'[dims]).

    :param base: the wrapped kernel; ``base.input_dim == len(dims)``.
    :param dims: column indices of the full input the base kernel sees.
    :param input_dim: width of the full input (default ``max(dims) + 1``).
    """

    def __init__(self, base: Kernel, dims, input_dim: int | None = None):
        dims = tuple(int(d) for d in dims)
        if len(dims) != base.input_dim:
            raise ValueError(
                f"len(dims)={len(dims)} must match the wrapped kernel's input_dim={base.input_dim}"
            )
        if dims and min(dims) < 0:
            raise ValueError("dims must be non-negative column indices")
        super().__init__(max(dims) + 1 if input_dim is None else input_dim)
        if dims and max(dims) >= self.input_dim:
            raise ValueError("dims out of range for input_dim")
        self.base = base
        self.dims = dims

    def _slice(self, X):
        return None if X is None else X[:, list(self.dims)]

    def K(self, X, X2=None):
        return self.base.K(self._slice(X), self._slice(X2))

    def pair(self, a, b):
        dims = list(self.dims)
        return self.base.pair(a[dims], b[dims])

    def Kdiag(self, X):
        return self.base.Kdiag(self._slice(X))


class DeepKernel(Kernel):
    """Deep kernel learning (Wilson et al. 2016), k(x, x') = base(g(x), g(x'))
    with a trainable feature map ``net`` (e.g. :class:`~gptorch_tpu_torch.nn.MLP`),
    whose weights appear under ``kernel.net.*``.  The net maps every input
    the kernel sees, so a sparse model's inducing points live in input
    space.  An :class:`Rbf` base on the card builds the feature Gram with
    the hand-written kernel.

    :param input_dim: width of the raw input (default ``net.in_dim``).
    """

    def __init__(self, base: Kernel, net, input_dim: int | None = None):
        if input_dim is None:
            input_dim = getattr(net, "in_dim", None)
            if input_dim is None:
                raise ValueError("net declares no in_dim; pass input_dim explicitly")
        out_dim = getattr(net, "out_dim", None)
        if out_dim is not None and out_dim != base.input_dim:
            raise ValueError(f"net.out_dim={out_dim} must match the base kernel's input_dim={base.input_dim}")
        super().__init__(input_dim)
        self.base = base
        self.net = net

    def K(self, X, X2=None):
        return self.base.K(self.net(X), None if X2 is None else self.net(X2))

    def pair(self, a, b):
        return self.base.pair(self.net(a[None, :])[0], self.net(b[None, :])[0])

    def Kdiag(self, X):
        return self.base.Kdiag(self.net(X))


class InputWarp(Kernel):
    """Kumaraswamy input warping (Snoek et al. 2014),
    k(x, x') = base(w(x), w(x')) with w(x)_d = 1 − (1 − x_d^{a_d})^{b_d} and
    trainable a, b > 0, on inputs in [0, 1] clamped to (1e-6, 1 − 1e-6);
    ``lo``/``hi`` map a box onto [0, 1] first."""

    def __init__(self, base: Kernel, a=1.0, b=1.0, lo=None, hi=None):
        super().__init__(base.input_dim)
        d = base.input_dim
        self.base = base
        self.a = positive_param(np.broadcast_to(np.asarray(a, float), (d,)).copy())
        self.b = positive_param(np.broadcast_to(np.asarray(b, float), (d,)).copy())
        if (lo is None) != (hi is None):
            raise ValueError("pass both lo and hi, or neither")
        if lo is not None:
            lo_ = as_array(np.broadcast_to(np.asarray(lo, float), (d,)).copy())
            self.register_buffer("lo", lo_)
            self.register_buffer("span", as_array(np.broadcast_to(np.asarray(hi, float), (d,)).copy()) - lo_)
        else:
            self.lo = self.span = None

    def warp(self, X):
        eps = 1e-6
        if self.lo is not None:
            X = (X - self.lo) / self.span
        Xc = torch.clamp(X, eps, 1.0 - eps)
        return 1.0 - torch.pow(1.0 - torch.pow(Xc, self.a.value), self.b.value)

    def K(self, X, X2=None):
        return self.base.K(self.warp(X), None if X2 is None else self.warp(X2))

    def pair(self, a, b):
        return self.base.pair(self.warp(a[None, :])[0], self.warp(b[None, :])[0])

    def Kdiag(self, X):
        return self.base.Kdiag(self.warp(X))


class MultiFidelity(Kernel):
    """Kennedy & O'Hagan (2000) AR(1) multi-fidelity covariance over inputs
    whose LAST column is the fidelity s ∈ {0..L−1}:

        cov(f_i(x), f_j(x')) = Σ_{t ≤ min(i,j)} w[t, i]·w[t, j]·k_t(x, x'),
        w[t, i] = Π_{k=t}^{i−1} ρ_k,

    with the level kernels ``level0``… and trainable, unconstrained ρ.
    The fidelity column is carried as a float and cast to an index where
    it is read."""

    def __init__(self, kernels_per_level, rho=None):
        ks = list(kernels_per_level)
        if len(ks) < 1:
            raise ValueError("need at least one fidelity level")
        d = ks[0].input_dim
        if any(k.input_dim != d for k in ks):
            raise ValueError("all level kernels need the same input_dim")
        super().__init__(d + 1)
        self.num_levels = len(ks)
        for t, k in enumerate(ks):
            setattr(self, f"level{t}", k)
        if self.num_levels > 1:
            init = (np.ones(self.num_levels - 1) if rho is None
                    else np.broadcast_to(np.asarray(rho, float), (self.num_levels - 1,)).copy())
            self.rho = Param(init)

    def _levels(self):
        return [getattr(self, f"level{t}") for t in range(self.num_levels)]

    def _coeff(self, like):
        """(L, L, L): C[t, i, j] = w[t, i]·w[t, j], by a product chain (the
        ratio of cumulative products would divide 0/0 at ρ = 0)."""
        L = self.num_levels
        if L == 1:
            return torch.ones((1, 1, 1), dtype=like.dtype, device=like.device)
        rho = self.rho.value
        zero, one = rho.new_zeros(()), rho.new_ones(())
        rows = []
        for t in range(L):
            entries, acc = [zero] * t + [one], one
            for i in range(t + 1, L):
                acc = acc * rho[i - 1]
                entries.append(acc)
            rows.append(torch.stack(entries))
        w = torch.stack(rows)
        return w[:, :, None] * w[:, None, :]

    @staticmethod
    def _split(X):
        return X[:, :-1], X[:, -1].to(torch.long)

    def K(self, X, X2=None):
        x1, s1 = self._split(X)
        x2, s2 = self._split(X2) if X2 is not None else (None, s1)
        C = self._coeff(X)
        out = 0.0
        for t, k in enumerate(self._levels()):
            out = out + C[t][s1[:, None], s2[None, :]] * k.K(x1, x2)
        return out

    def pair(self, a, b):
        # the levels as one-hot rows, not indices: torch.func.vmap cannot
        # index by a mapped tensor
        C = self._coeff(a)
        levels = torch.arange(self.num_levels, device=a.device)
        e1, e2 = ((levels == s.to(torch.long)).to(a.dtype) for s in (a[-1], b[-1]))
        out = 0.0
        for t, k in enumerate(self._levels()):
            out = out + (e1 @ C[t] @ e2) * k.pair(a[:-1], b[:-1])
        return out

    def Kdiag(self, X):
        x1, s1 = self._split(X)
        C = self._coeff(X)
        out = 0.0
        for t, k in enumerate(self._levels()):
            out = out + C[t][s1, s1] * k.Kdiag(x1)
        return out


def add_fidelity(x, level: int):
    """Raw inputs (n, d) tagged with a fidelity column: (n, d + 1)."""
    if isinstance(x, torch.Tensor):
        return torch.cat([x, torch.full((x.shape[0], 1), float(level), dtype=x.dtype, device=x.device)], dim=1)
    x = np.asarray(x)
    return np.concatenate([x, np.full((x.shape[0], 1), float(level), dtype=x.dtype)], axis=1)


class Cosine(Stationary):
    """k(x, x') = σ² cos(2π Σ_d (x_d − x'_d)/ℓ_d): an oscillation along the
    signed, length-scale-weighted sum of the coordinate differences
    (distinct from :class:`Periodic`, a cosine of the unsigned distance)."""

    def K(self, X, X2=None):
        ell = self.length_scales.value
        proj1 = torch.sum(X / ell, dim=1)
        proj2 = proj1 if X2 is None else torch.sum(X2 / ell, dim=1)
        return _scalar(self.variance) * torch.cos(2.0 * math.pi * (proj1[:, None] - proj2[None, :]))


class ArcCosine(Kernel):
    """Arc-cosine kernel of order q ∈ {0, 1, 2} (Cho & Saul 2009),

        k(x, x') = σ²/π · (s_x s_x')^{q/2} · J_q(θ),  cos θ = s_xx' / √(s_x s_x'),
        s_xx' = σ_b² + Σ_d σ_{w,d}² x_d x'_d,

    with J_0 = π − θ, J_1 = sin θ + (π − θ) cos θ and
    J_2 = 3 sin θ cos θ + (π − θ)(1 + 2 cos² θ).  cos θ is clamped inside
    (−1, 1) off the diagonal; the self-Gram's diagonal is the exact θ = 0
    value (``Kdiag``), where arccos's derivative is infinite."""

    def __init__(self, input_dim: int, order: int = 1, variance: float = 1.0, weight_variances=1.0,
                 bias_variance: float = 1.0, ARD=None):
        super().__init__(input_dim)
        if int(order) not in (0, 1, 2):
            raise ValueError("ArcCosine order must be 0, 1 or 2")
        self.order = int(order)
        self.variance = positive_param(as_array(variance))
        weight_variances, self.ARD = self._validate_ard_shape(weight_variances, ARD)
        self.weight_variances = positive_param(as_array(weight_variances))
        self.bias_variance = positive_param(as_array(float(bias_variance)))

    def _diag_dot(self, X):
        return _scalar(self.bias_variance) + torch.sum(X * X * self.weight_variances.value, dim=1)

    def _J(self, theta):
        if self.order == 0:
            return math.pi - theta
        if self.order == 1:
            return torch.sin(theta) + (math.pi - theta) * torch.cos(theta)
        c = torch.cos(theta)
        return 3.0 * torch.sin(theta) * c + (math.pi - theta) * (1.0 + 2.0 * c * c)

    def K(self, X, X2=None):
        self_gram = X2 is None
        X2v = X if self_gram else X2
        s12 = _scalar(self.bias_variance) + (X * self.weight_variances.value) @ X2v.T
        s1 = self._diag_dot(X)
        s2 = s1 if self_gram else self._diag_dot(X2v)
        s1s2 = s1[:, None] * s2[None, :]
        eps = 1e-6
        theta = torch.arccos(torch.clamp(s12 / torch.sqrt(s1s2), -1.0 + eps, 1.0 - eps))
        out = (_scalar(self.variance) / math.pi) * torch.pow(s1s2, 0.5 * self.order) * self._J(theta)
        if self_gram:
            out = out.clone()
            out.diagonal().copy_(self.Kdiag(X))
        return out

    def Kdiag(self, X):
        j0 = {0: math.pi, 1: math.pi, 2: 3.0 * math.pi}[self.order]
        return _scalar(self.variance) / math.pi * j0 * torch.pow(self._diag_dot(X), float(self.order))


class ChangePoints(Kernel):
    """Soft switches between regimes along a 1-D input: with N + 1 kernels
    ``regime0``… and N locations b_i, gates σ_i(x) = sigmoid(s_i (x − b_i))
    give regime weights w_0 = 1 − σ_1, w_i = σ_i (1 − σ_{i+1}), w_N = σ_N,
    and k(x, x') = Σ_i w_i(x) w_i(x') k_i(x, x').  Locations
    (unconstrained) and steepnesses (positive) are trainable."""

    def __init__(self, kernels, locations, steepness=1.0):
        ks = list(kernels)
        locations = np.atleast_1d(np.asarray(locations, dtype=float))
        if len(ks) != locations.shape[0] + 1:
            raise ValueError(
                f"need len(kernels) == len(locations) + 1, got {len(ks)} kernels and "
                f"{locations.shape[0]} locations"
            )
        if any(k.input_dim != 1 for k in ks):
            raise ValueError("ChangePoints requires 1-D component kernels")
        super().__init__(1)
        self.num_regimes = len(ks)
        for i, k in enumerate(ks):
            setattr(self, f"regime{i}", k)
        self.locations = Param(locations)
        self.steepness = positive_param(as_array(np.broadcast_to(np.asarray(steepness, float), locations.shape).copy()))

    def _kernels(self):
        return [getattr(self, f"regime{i}") for i in range(self.num_regimes)]

    def _weights(self, X):
        """(n, N + 1) soft regime weights."""
        sig = torch.sigmoid(self.steepness.value[None, :] * (X[:, :1] - self.locations.value[None, :]))
        ones = torch.ones((X.shape[0], 1), dtype=sig.dtype, device=sig.device)
        return torch.cat([ones, sig], dim=1) * torch.cat([1.0 - sig, ones], dim=1)

    def K(self, X, X2=None):
        w1 = self._weights(X)
        w2 = w1 if X2 is None else self._weights(X2)
        out = 0.0
        for i, k in enumerate(self._kernels()):
            out = out + (w1[:, i : i + 1] * w2[None, :, i]) * k.K(X, X2)
        return out

    def pair(self, a, b):
        w1, w2 = self._weights(a[None, :])[0], self._weights(b[None, :])[0]
        out = 0.0
        for i, k in enumerate(self._kernels()):
            out = out + w1[i] * w2[i] * k.pair(a, b)
        return out

    def Kdiag(self, X):
        w = self._weights(X)
        out = 0.0
        for i, k in enumerate(self._kernels()):
            out = out + torch.square(w[:, i]) * k.Kdiag(X)
        return out


class Coregion(Kernel):
    """Coregionalization over task indices: inputs are one column of task
    ids s ∈ {0..T−1}, carried as floats and cast to an index where read,
    and k(s, s') = B[s, s'] with B = W Wᵀ + diag(κ), W (T, rank)
    unconstrained and κ (T,) positive, both trainable."""

    def __init__(self, output_dim: int, rank: int = 1, W=None, kappa=None):
        super().__init__(1)
        T, r = int(output_dim), int(rank)
        if T < 1 or r < 1:
            raise ValueError("output_dim and rank must be >= 1")
        self.output_dim = T
        self.rank = r
        if W is None:
            # a deterministic, symmetry-breaking start: identical columns
            # would keep B rank one under gradient flow
            W = 0.3 * np.linspace(-0.5, 0.5, T * r).reshape(T, r) + 0.1
        self.W = Param(np.asarray(W, dtype=float).reshape(T, r))
        self.kappa = positive_param(
            as_array(np.ones(T) if kappa is None else np.broadcast_to(np.asarray(kappa, float), (T,)).copy())
        )

    def B(self):
        W = self.W.value
        return W @ W.T + torch.diag(self.kappa.value)

    @staticmethod
    def _idx(X):
        return X[:, 0].to(torch.long)

    def K(self, X, X2=None):
        s1 = self._idx(X)
        s2 = s1 if X2 is None else self._idx(X2)
        return self.B()[s1[:, None], s2[None, :]]

    def Kdiag(self, X):
        return (torch.sum(torch.square(self.W.value), dim=1) + self.kappa.value)[self._idx(X)]


class Combination(Kernel):
    """Pair combination."""

    def __init__(self, kern1: Kernel, kern2: Kernel):
        if kern1.input_dim != kern2.input_dim:
            raise ValueError("Kernels need the same input_dim")
        super().__init__(kern1.input_dim)
        self.kern1 = kern1
        self.kern2 = kern2


class Product(Combination):
    def K(self, X, X2=None):
        return self.kern1.K(X, X2) * self.kern2.K(X, X2)

    def pair(self, a, b):
        return self.kern1.pair(a, b) * self.kern2.pair(a, b)

    def Kdiag(self, X):
        return self.kern1.Kdiag(X) * self.kern2.Kdiag(X)


class Sum(Combination):
    def K(self, X, X2=None):
        return self.kern1.K(X, X2) + self.kern2.K(X, X2)

    def pair(self, a, b):
        return self.kern1.pair(a, b) + self.kern2.pair(a, b)

    def Kdiag(self, X):
        return self.kern1.Kdiag(X) + self.kern2.Kdiag(X)
