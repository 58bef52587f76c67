"""Probability distributions with a scipy-like interface, in PyTorch
(counterpart of :mod:`elfi_tpu.ops.distributions`).

Conventions
-----------
- ``rvs(*params, size=n, generator=g)`` returns a tensor on ``g``'s device
  (with no ``g``, the global backend's: :func:`draw_device`) whose leading
  axis is the batch axis of length ``n``; the explicit ``torch.Generator``
  replaces the JAX package's ``key``.
- Univariate distributions use scipy's ``loc``/``scale`` parameterisation.
- Parameters may be Python scalars or per-batch tensors of shape
  ``(n, ...)`` (hierarchical priors, e.g. MA2's ``t2 | t1``).
- Any ``scipy.stats`` distribution (or other ``random_state``-style object)
  runs through :class:`ScipyHostDistribution`, a host adapter: its node is
  marked ``host=True`` and draws with a ``numpy.random.RandomState`` seeded
  by :func:`host_seed` from the node's stream seed.
"""

from __future__ import annotations

import inspect
import math

import numpy as np
import torch

from ..utils import threefry, to_numpy
from . import special

__all__ = ["Distribution", "uniform", "norm", "truncnorm", "expon",
           "multivariate_normal", "levy_stable", "lognorm", "gamma", "beta",
           "binom", "poisson", "t", "cauchy", "laplace", "chi2", "skewnorm",
           "weibull_min", "ScipyHostDistribution", "wrap_if_foreign",
           "from_name", "host_seed"]


def host_seed(stream):
    """The 31-bit seed of a host ``RandomState`` for a node's stream:
    ``stream`` is the node's 64-bit stream seed
    (:func:`~elfi_tpu_torch.utils.rng.stream_seed`) or a generator seeded
    with it.  The single definition of the convention: the compiler's host
    executor and :class:`ScipyHostDistribution` must agree bit for bit, or
    a host draw through ``program.run`` and a direct ``rvs(generator=...)``
    would differ."""
    if isinstance(stream, torch.Generator):
        stream = stream.initial_seed()
    return int(stream) & 0x7FFFFFFF


def _shape(p):
    return tuple(p.shape) if isinstance(p, torch.Tensor) else ()


def _draw_shape(size, *params):
    """Result shape for a univariate draw of ``size`` with given params.
    ``size`` may be an int (batch length) or an explicit shape tuple."""
    b = np.broadcast_shapes(*[_shape(p) for p in params]) if params \
        else ()
    b = tuple(b)
    if isinstance(size, (tuple, list)):
        return tuple(np.broadcast_shapes(tuple(size), b))
    if b == ():
        return (size,)
    if b[0] == size:
        return b
    return (size,) + b


def draw_device(generator):
    """The device a draw lands on: ``generator``'s, or with no generator the
    global backend's (the current CUDA device unless a backend on another
    device was set), as a user's ``norm.rvs(size=n)`` runs on the card."""
    if generator is not None:
        return generator.device
    # imported here: the parallel package imports the model, which imports
    # this module
    from ..parallel.backends import resolve_device
    return resolve_device(None)


class Distribution:
    """Base class for user-defined distributions.

    Subclasses implement ``rvs(*params, size=n, generator=g)`` and at least
    one of ``pdf``/``logpdf`` on tensors.  Both class-level use
    (``MyDist.rvs(...)``) and instances are supported.
    """

    name = None
    #: whether ``rvs`` may be captured in a CUDA graph
    #: (:meth:`~elfi_tpu_torch.compile.compiler.CompiledProgram.jitted`):
    #: it draws only through ``generator`` and neither reads the device
    #: back nor copies from the host.  Opt-in: a program with a node that
    #: is not marked runs eagerly.
    capturable = False

    @classmethod
    def rvs(cls, *params, size=1, generator=None):
        raise NotImplementedError

    @classmethod
    def pdf(cls, x, *params):
        if cls.logpdf is Distribution.logpdf:
            raise NotImplementedError
        return torch.exp(cls.logpdf(x, *params))

    @classmethod
    def logpdf(cls, x, *params):
        return torch.log(cls.pdf(x, *params))

    @classmethod
    def gradient_logpdf(cls, x, *params):
        """Elementwise derivative of ``logpdf`` in ``x``, by autograd."""
        x = _f32(x).detach().requires_grad_(True)
        return torch.autograd.grad(cls.logpdf(x, *params).sum(), x)[0]


class uniform(Distribution):
    """Uniform on ``[loc, loc + scale]`` (scipy convention)."""
    name = "uniform"
    capturable = True

    @classmethod
    def rvs(cls, loc=0.0, scale=1.0, size=1, generator=None):
        shape = _draw_shape(size, loc, scale)
        u = torch.rand(shape, generator=generator,
                       device=draw_device(generator))
        return loc + scale * u

    @classmethod
    def logpdf(cls, x, loc=0.0, scale=1.0):
        x = torch.as_tensor(x)
        inside = (x >= loc) & (x <= loc + scale)
        # the density on x's device: torch.where would copy a host scalar
        # tensor there, which a CUDA graph capture refuses
        return torch.where(inside, torch.zeros_like(x) - torch.log(
            torch.as_tensor(scale, dtype=x.dtype)), -math.inf)

    @classmethod
    def pdf(cls, x, loc=0.0, scale=1.0):
        x = torch.as_tensor(x)
        inside = (x >= loc) & (x <= loc + scale)
        return torch.where(inside, 1.0 / scale, 0.0)

    @classmethod
    def cdf(cls, x, loc=0.0, scale=1.0):
        return torch.clamp((torch.as_tensor(x) - loc) / scale, 0.0, 1.0)

    @classmethod
    def ppf(cls, q, loc=0.0, scale=1.0):
        q = torch.as_tensor(q)
        return torch.where((q >= 0) & (q <= 1), loc + scale * q, math.nan)


class norm(Distribution):
    name = "norm"
    capturable = True

    @classmethod
    def rvs(cls, loc=0.0, scale=1.0, size=1, generator=None):
        shape = _draw_shape(size, loc, scale)
        z = torch.randn(shape, generator=generator,
                        device=draw_device(generator))
        return loc + scale * z

    @classmethod
    def logpdf(cls, x, loc=0.0, scale=1.0):
        z = (torch.as_tensor(x) - loc) / scale
        return (-0.5 * z * z - torch.log(torch.as_tensor(scale, dtype=z.dtype))
                - 0.5 * math.log(2 * math.pi))

    @classmethod
    def cdf(cls, x, loc=0.0, scale=1.0):
        return torch.special.ndtr((torch.as_tensor(x) - loc) / scale)

    @classmethod
    def ppf(cls, q, loc=0.0, scale=1.0):
        return loc + scale * torch.special.ndtri(torch.as_tensor(q))


def _f32(x, device=None):
    """``x`` as a float32 tensor (on ``device`` when it is not one yet), as
    the JAX package's ``jnp.asarray(x, jnp.float32)``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _ppf_nan_guard(q, val):
    """scipy parity: ``ppf(q)`` is nan outside ``[0, 1]``."""
    q = torch.as_tensor(q)
    return torch.where((q >= 0) & (q <= 1), val, math.nan)


def _bisect_ppf(cdf, q, lo, hi, iters=90):
    """Invert a monotone ``cdf`` by a fixed count of bisections on the
    bracket ``[lo, hi]``, elementwise (the JAX package's count): nothing
    is read back to the host."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = cdf(mid) < q
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


#: doublings (gamma) or quadruplings (t) of a ppf's upper bracket.  The JAX
#: package grows it while any element's cdf is short of its quantile; a
#: fixed count keeps the loop on the device (``2**16`` times the gamma
#: start of a + 10 sqrt(a) + 10, ``4**32`` times the t start of 10).
_GROW_STEPS = {"gamma": 16, "t": 32}


def _scalar(p):
    """A Python float for a Python or numpy number, else ``p`` (a tensor
    becomes float32): a CUDA op takes a Python number as a scalar, where a
    0-d tensor made on the host would have to be copied to the device,
    which waits for it."""
    if isinstance(p, torch.Tensor):
        return p.to(torch.float32)
    if np.ndim(p) == 0:
        return float(p)
    return torch.as_tensor(np.asarray(p, np.float32))


def _tensor(p, like):
    """``p`` as a float32 tensor for ops that take no Python number
    (``lgamma``, ``gammainc``, ``betainc``): a number fills a tensor shaped
    and placed as ``like``."""
    p = _scalar(p)
    if isinstance(p, torch.Tensor):
        return p.to(like.device)
    return torch.full_like(like, p, dtype=torch.float32)


def _log(p, like):
    """``log p`` of a scale parameter: ``math.log`` of a number."""
    p = _scalar(p)
    return torch.log(p.to(like.device)) if isinstance(p, torch.Tensor) \
        else math.log(p)


def _filled(p, shape, device):
    """A draw's parameter filled to ``shape`` on ``device``, contiguous, as
    ``torch._standard_gamma``, ``torch.poisson`` and ``torch.binomial``
    take it."""
    p = _scalar(p)
    if isinstance(p, torch.Tensor):
        return torch.broadcast_to(p.to(device), shape).contiguous()
    return torch.full(shape, p, dtype=torch.float32, device=device)


def _standard_gamma(a, shape, generator):
    """Gamma(a, 1) draws of ``shape`` on the generator's device."""
    return torch._standard_gamma(
        _filled(a, shape, draw_device(generator)), generator=generator)


class truncnorm(Distribution):
    """Truncated normal; ``a``/``b`` are standardized bounds (scipy)."""
    name = "truncnorm"
    capturable = True

    @staticmethod
    def _cdf_bounds(a, b):
        """ndtr of the bounds in float32.  A Python bound stays a 0-d CPU
        tensor, which CUDA elementwise ops take as a scalar: a copy to the
        device would wait for it."""
        return (torch.special.ndtr(_f32(a)), torch.special.ndtr(_f32(b)))

    @classmethod
    def rvs(cls, a, b, loc=0.0, scale=1.0, size=1, generator=None):
        shape = _draw_shape(size, a, b, loc, scale)
        device = draw_device(generator)
        fa, fb = cls._cdf_bounds(a, b)
        u = torch.rand(shape, generator=generator, device=device)
        # uniform on [1e-7, 1 - 1e-7), as the JAX package draws it
        u = 1e-7 + u * ((1.0 - 1e-7) - 1e-7)
        z = torch.special.ndtri(fa + u * (fb - fa))
        return loc + scale * z

    @classmethod
    def logpdf(cls, x, a, b, loc=0.0, scale=1.0):
        z = (torch.as_tensor(x) - loc) / scale
        fa, fb = cls._cdf_bounds(a, b)
        la = torch.log(fb - fa)
        inside = (z >= a) & (z <= b)
        return torch.where(
            inside,
            norm.logpdf(z) - la - torch.log(torch.as_tensor(scale,
                                                            dtype=z.dtype)),
            -math.inf)

    @classmethod
    def cdf(cls, x, a, b, loc=0.0, scale=1.0):
        z = (torch.as_tensor(x) - loc) / scale
        fa, fb = cls._cdf_bounds(a, b)
        return torch.clamp((torch.special.ndtr(z) - fa) / (fb - fa), 0.0,
                           1.0)

    @classmethod
    def ppf(cls, q, a, b, loc=0.0, scale=1.0):
        q = torch.as_tensor(q)
        fa, fb = cls._cdf_bounds(a, b)
        val = loc + scale * torch.special.ndtri(fa + q * (fb - fa))
        return _ppf_nan_guard(q, val)


class expon(Distribution):
    """Exponential on ``[loc, inf)`` with mean ``loc + scale`` (scipy)."""
    name = "expon"

    @classmethod
    def rvs(cls, loc=0.0, scale=1.0, size=1, generator=None):
        shape = _draw_shape(size, loc, scale)
        e = torch.empty(shape, device=draw_device(generator)).exponential_(
            generator=generator)
        return loc + scale * e

    @classmethod
    def logpdf(cls, x, loc=0.0, scale=1.0):
        z = (torch.as_tensor(x) - loc) / scale
        return torch.where(
            z >= 0, -z - torch.log(torch.as_tensor(scale, dtype=z.dtype)),
            -math.inf)

    @classmethod
    def cdf(cls, x, loc=0.0, scale=1.0):
        z = (torch.as_tensor(x) - loc) / scale
        return torch.where(z >= 0, -torch.expm1(-z), 0.0)

    @classmethod
    def ppf(cls, q, loc=0.0, scale=1.0):
        q = torch.as_tensor(q)
        return _ppf_nan_guard(q, loc - scale * torch.log1p(-q))


def solve_lower_rows(L, r):
    """``L^-1 r_i`` for every row ``r_i`` of ``r`` (..., d), as ``r @
    (L^-1).T``: one small triangular solve for the inverse, then a matmul.
    The triangular solve with millions of right-hand sides takes seconds
    on an H100 for the 4M of a 2000 x 2000 mixture density, where this
    takes milliseconds (``scripts/torch_smc_parts.py`` times both); the
    result differs from a direct solve in the last bits only."""
    eye = torch.eye(L.shape[0], dtype=L.dtype, device=L.device)
    return r @ torch.linalg.solve_triangular(L, eye, upper=False).T


class multivariate_normal(Distribution):
    """Multivariate normal (``mean``, ``cov``) in float32.  The Cholesky
    factor comes from ``cholesky_ex``, which does not wait for the device
    to check it, as ``torch.linalg.cholesky`` would on CUDA."""
    name = "multivariate_normal"

    @staticmethod
    def _mean_chol(mean, cov, device=None):
        mean = torch.atleast_1d(_f32(mean, device))
        d = mean.shape[-1]
        cov = _f32(cov, mean.device)
        if cov.ndim == 0:
            cov = cov * torch.eye(d, device=mean.device)
        return mean, torch.linalg.cholesky_ex(cov).L

    @classmethod
    def rvs(cls, mean, cov, size=1, generator=None):
        mean, L = cls._mean_chol(mean, cov, draw_device(generator))
        z = torch.randn((size, mean.shape[-1]), generator=generator,
                        device=mean.device)
        return mean + z @ L.T

    @classmethod
    def logpdf(cls, x, mean, cov):
        x = torch.atleast_2d(_f32(x))
        mean, L = cls._mean_chol(mean, cov, x.device)
        d = mean.shape[-1]
        sol = solve_lower_rows(L, x - mean)
        quad = torch.sum(sol * sol, dim=1)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
        return -0.5 * (d * math.log(2 * math.pi) + logdet + quad)


class levy_stable(Distribution):
    """Alpha-stable distribution sampled with the Chambers-Mallows-Stuck
    transform in the S0 parameterization (scipy's ``levy_stable`` with
    ``parameterization='S0'``), the JAX package's formula.  No closed-form
    density: ``rvs`` only.

    A draw is :meth:`draw` (the uniform angle ``U`` and the exponential
    ``W``) followed by the pure :meth:`transform`, so that a test can feed
    the transform the JAX package's own ``U`` and ``W``."""
    name = "levy_stable"

    #: ``U`` is uniform on ``(-pi/2 + 1e-6, pi/2 - 1e-6)``, as in the JAX
    #: package, which keeps ``cos(U)`` away from 0
    _U_LO = -math.pi / 2 + 1e-6
    _U_HI = math.pi / 2 - 1e-6

    @classmethod
    def draw(cls, shape, generator=None):
        """``(U, W)`` of ``shape`` from ``generator``."""
        device = draw_device(generator)
        u = torch.rand(shape, generator=generator, device=device)
        u = cls._U_LO + (cls._U_HI - cls._U_LO) * u
        w = torch.empty(shape, device=device).exponential_(
            generator=generator)
        return u, w

    @classmethod
    def draw_from_key(cls, key, shape):
        """``(U, W)`` of ``shape`` from the Threefry streams of ``key``'s
        two halves, as the JAX package's ``rvs`` draws them."""
        k1, k2 = threefry.split(key)
        return (threefry.uniform(k1, shape, cls._U_LO, cls._U_HI),
                threefry.exponential(k2, shape))

    @staticmethod
    def transform(U, W, alpha, beta=0.0, loc=0.0, scale=1.0):
        """The Chambers-Mallows-Stuck transform of ``(U, W)``, shifted from
        S1 to S0 so that ``loc`` is the S0 location.  Near ``alpha = 1``
        ``tan(pi alpha / 2)`` blows up, in the JAX package alike."""
        alpha = _f32(alpha, U.device)
        beta = _f32(beta, U.device)
        tan_term = beta * torch.tan(math.pi * alpha / 2)
        B = torch.arctan(tan_term) / alpha
        S = (1 + tan_term ** 2) ** (1 / (2 * alpha))
        x1 = (S * torch.sin(alpha * (U + B)) / torch.cos(U) ** (1 / alpha)
              * (torch.cos(U - alpha * (U + B)) / W)
              ** ((1 - alpha) / alpha))
        return loc + scale * (x1 - tan_term)

    @classmethod
    def rvs(cls, alpha, beta=0.0, loc=0.0, scale=1.0, size=1,
            generator=None):
        shape = _draw_shape(size, alpha, beta, loc, scale)
        U, W = cls.draw(shape, generator)
        return cls.transform(U, W, alpha, beta, loc, scale)


class lognorm(Distribution):
    """scipy parameterisation: shape ``s``, ``scale=exp(mu)``."""
    name = "lognorm"

    @classmethod
    def rvs(cls, s, loc=0.0, scale=1.0, size=1, generator=None):
        shape = _draw_shape(size, s, loc, scale)
        z = torch.randn(shape, generator=generator,
                        device=draw_device(generator))
        return loc + scale * torch.exp(_scalar(s) * z)

    @classmethod
    def logpdf(cls, x, s, loc=0.0, scale=1.0):
        y = (_f32(x) - loc) / scale
        s = _scalar(s)
        safe = torch.where(y > 0, y, 1.0)
        lp = (-torch.log(safe * s * scale) - 0.5 * math.log(2 * math.pi)
              - torch.log(safe) ** 2 / (2 * s * s))
        return torch.where(y > 0, lp, -math.inf)

    @classmethod
    def cdf(cls, x, s, loc=0.0, scale=1.0):
        y = (_f32(x) - loc) / scale
        safe = torch.where(y > 0, y, 1.0)
        return torch.where(
            y > 0, special._ndtr(torch.log(safe) / _scalar(s)), 0.0)

    @classmethod
    def ppf(cls, q, s, loc=0.0, scale=1.0):
        return loc + scale * torch.exp(
            _scalar(s) * torch.special.ndtri(_f32(q)))


class gamma(Distribution):
    """scipy parameterisation: shape ``a``, ``scale`` (= 1/rate)."""
    name = "gamma"

    @classmethod
    def rvs(cls, a, loc=0.0, scale=1.0, size=1, generator=None):
        shape = _draw_shape(size, a, loc, scale)
        return loc + scale * _standard_gamma(a, shape, generator)

    @classmethod
    def logpdf(cls, x, a, loc=0.0, scale=1.0):
        z = (_f32(x) - loc) / scale
        at = _tensor(a, z)
        safe = torch.where(z > 0, z, 1.0)
        lp = ((at - 1) * torch.log(safe) - safe - torch.lgamma(at)
              - _log(scale, z))
        return torch.where(z > 0, lp, -math.inf)

    @classmethod
    def cdf(cls, x, a, loc=0.0, scale=1.0):
        z = (_f32(x) - loc) / scale
        return torch.where(z > 0, torch.special.gammainc(
            _tensor(a, z), torch.clamp(z, min=0.0)), 0.0)

    @classmethod
    def ppf(cls, q, a, loc=0.0, scale=1.0):
        q = _f32(q)
        qb, ab = torch.broadcast_tensors(q, _tensor(a, q))
        # bracket: the cdf is 0 at 0; grow hi where it does not cover q
        qc = torch.clamp(qb, 0.0, 1.0 - 1e-7)
        hi = ab + 10.0 * torch.sqrt(ab) + 10.0
        for _ in range(_GROW_STEPS["gamma"]):
            hi = torch.where(torch.special.gammainc(ab, hi) < qc, hi * 2.0,
                             hi)
        z = _bisect_ppf(lambda z: torch.special.gammainc(ab, z), qc,
                        torch.zeros_like(hi), hi)
        val = loc + scale * z
        val = torch.where(qb == 0.0, loc + torch.zeros_like(val), val)
        val = torch.where(qb == 1.0, math.inf, val)
        return _ppf_nan_guard(qb, val)


class beta(Distribution):
    """Beta(a, b) on ``[loc, loc + scale]``; a draw is ``X / (X + Y)`` of
    two gamma draws."""
    name = "beta"

    @classmethod
    def rvs(cls, a, b, loc=0.0, scale=1.0, size=1, generator=None):
        shape = _draw_shape(size, a, b, loc, scale)
        x = _standard_gamma(a, shape, generator)
        y = _standard_gamma(b, shape, generator)
        return loc + scale * (x / (x + y))

    @classmethod
    def logpdf(cls, x, a, b, loc=0.0, scale=1.0):
        z = (_f32(x) - loc) / scale
        at, bt = _tensor(a, z), _tensor(b, z)
        safe = torch.clamp(z, 1e-12, 1 - 1e-12)
        lp = ((at - 1) * torch.log(safe) + (bt - 1) * torch.log1p(-safe)
              - special.betaln(at, bt) - _log(scale, z))
        return torch.where((z > 0) & (z < 1), lp, -math.inf)

    @classmethod
    def cdf(cls, x, a, b, loc=0.0, scale=1.0):
        z = torch.clamp((_f32(x) - loc) / scale, 0.0, 1.0)
        return special.betainc(_tensor(a, z), _tensor(b, z), z)

    @classmethod
    def ppf(cls, q, a, b, loc=0.0, scale=1.0):
        q = _f32(q)
        qb, ab, bb = torch.broadcast_tensors(q, _tensor(a, q),
                                             _tensor(b, q))
        z = _bisect_ppf(lambda z: special.betainc(ab, bb, z), qb,
                        torch.zeros_like(qb), torch.ones_like(qb))
        val = loc + scale * z
        val = torch.where(qb == 0.0, loc + torch.zeros_like(val), val)
        val = torch.where(qb == 1.0, loc + scale + torch.zeros_like(val),
                          val)
        return _ppf_nan_guard(qb, val)


class binom(Distribution):
    """Binomial(n, p); draws are float32 counts, as in the JAX package."""
    name = "binom"

    @classmethod
    def rvs(cls, n, p, size=1, generator=None):
        shape = _draw_shape(size, n, p)
        device = draw_device(generator)
        return torch.binomial(_filled(n, shape, device),
                              _filled(p, shape, device),
                              generator=generator)

    @classmethod
    def logpdf(cls, x, n, p):
        x = _f32(x)
        n = _tensor(n, x)
        p = _tensor(p, x)
        return (torch.lgamma(n + 1) - torch.lgamma(x + 1)
                - torch.lgamma(n - x + 1) + x * torch.log(p)
                + (n - x) * torch.log1p(-p))

    @classmethod
    def logpmf(cls, x, n, p):
        return cls.logpdf(x, n, p)

    @classmethod
    def pmf(cls, x, n, p):
        return cls.pdf(x, n, p)


class poisson(Distribution):
    name = "poisson"

    @classmethod
    def rvs(cls, mu, size=1, generator=None):
        shape = _draw_shape(size, mu)
        return torch.poisson(_filled(mu, shape, draw_device(generator)),
                             generator=generator)

    @classmethod
    def logpdf(cls, x, mu):
        x = _f32(x)
        mu = _tensor(mu, x)
        return x * torch.log(mu) - mu - torch.lgamma(x + 1)


class t(Distribution):
    """Student's t with ``df`` degrees of freedom (scipy ``t``); a draw is
    a normal over ``sqrt(chi2 / df)``."""
    name = "t"

    @classmethod
    def rvs(cls, df, loc=0.0, scale=1.0, size=1, generator=None):
        shape = _draw_shape(size, df, loc, scale)
        device = draw_device(generator)
        df = _filled(df, shape, device)
        z = torch.randn(shape, generator=generator, device=device)
        chi2 = 2.0 * torch._standard_gamma(0.5 * df, generator=generator)
        return loc + scale * (z / torch.sqrt(chi2 / df))

    @classmethod
    def logpdf(cls, x, df, loc=0.0, scale=1.0):
        z = (_f32(x) - loc) / scale
        df = _tensor(df, z)
        return (torch.lgamma((df + 1) / 2) - torch.lgamma(df / 2)
                - 0.5 * torch.log(df * math.pi)
                - (df + 1) / 2 * torch.log1p(z * z / df) - _log(scale, z))

    @classmethod
    def cdf(cls, x, df, loc=0.0, scale=1.0):
        z = (_f32(x) - loc) / scale
        df = _tensor(df, z)
        # 1 - I_{df/(df+z^2)}(df/2, 1/2) / 2 for z >= 0, symmetric below
        ib = special.betainc(df / 2, torch.full_like(z, 0.5),
                             df / (df + z * z))
        return torch.where(z >= 0, 1.0 - 0.5 * ib, 0.5 * ib)

    @classmethod
    def ppf(cls, q, df, loc=0.0, scale=1.0):
        q = _f32(q)
        qb, dfb = torch.broadcast_tensors(q, _tensor(df, q))
        # solve on the upper half by symmetry: z >= 0 for p >= 0.5
        p = torch.clamp(torch.where(qb >= 0.5, qb, 1.0 - qb), 0.5,
                        1.0 - 1e-7)
        hi = torch.full_like(p, 10.0)
        for _ in range(_GROW_STEPS["t"]):
            hi = torch.where(cls.cdf(hi, dfb) < p, hi * 4.0, hi)
        z = _bisect_ppf(lambda z: cls.cdf(z, dfb), p, torch.zeros_like(hi),
                        hi)
        z = torch.where(qb >= 0.5, z, -z)
        return _ppf_nan_guard(qb, loc + scale * z)


class cauchy(Distribution):
    name = "cauchy"

    @classmethod
    def rvs(cls, loc=0.0, scale=1.0, size=1, generator=None):
        shape = _draw_shape(size, loc, scale)
        c = torch.empty(shape, device=draw_device(generator)).cauchy_(
            generator=generator)
        return loc + scale * c

    @classmethod
    def logpdf(cls, x, loc=0.0, scale=1.0):
        z = (_f32(x) - loc) / scale
        return -math.log(math.pi) - _log(scale, z) - torch.log1p(z * z)

    @classmethod
    def cdf(cls, x, loc=0.0, scale=1.0):
        z = (_f32(x) - loc) / scale
        return 0.5 + torch.arctan(z) / math.pi

    @classmethod
    def ppf(cls, q, loc=0.0, scale=1.0):
        q = _f32(q)
        return _ppf_nan_guard(q, loc + scale * torch.tan(math.pi * (q - 0.5)))


class laplace(Distribution):
    name = "laplace"

    #: a draw is ``sign(u) log1p(-|u|)`` of u uniform on [-1 + eps, 1), as
    #: ``jax.random.laplace`` draws it
    _EPS = float(np.finfo(np.float32).eps)

    @classmethod
    def rvs(cls, loc=0.0, scale=1.0, size=1, generator=None):
        shape = _draw_shape(size, loc, scale)
        u = torch.rand(shape, generator=generator,
                       device=draw_device(generator))
        u = (-1.0 + cls._EPS) + (2.0 - cls._EPS) * u
        return loc + scale * (torch.sign(u) * torch.log1p(-torch.abs(u)))

    @classmethod
    def logpdf(cls, x, loc=0.0, scale=1.0):
        z = (_f32(x) - loc) / scale
        return -torch.abs(z) - _log(2 * _scalar(scale), z)

    @classmethod
    def cdf(cls, x, loc=0.0, scale=1.0):
        z = (_f32(x) - loc) / scale
        return torch.where(z < 0, 0.5 * torch.exp(z),
                           1.0 - 0.5 * torch.exp(-z))

    @classmethod
    def ppf(cls, q, loc=0.0, scale=1.0):
        q = _f32(q)
        val = torch.where(q < 0.5, loc + scale * torch.log(2 * q),
                          loc - scale * torch.log(2 * (1 - q)))
        return _ppf_nan_guard(q, val)


class chi2(Distribution):
    """Chi-squared with ``df`` degrees of freedom = gamma(df/2, scale=2)."""
    name = "chi2"

    @classmethod
    def rvs(cls, df, loc=0.0, scale=1.0, size=1, generator=None):
        return gamma.rvs(_scalar(df) / 2, loc, 2.0 * _scalar(scale),
                         size=size, generator=generator)

    @classmethod
    def logpdf(cls, x, df, loc=0.0, scale=1.0):
        return gamma.logpdf(x, _scalar(df) / 2, loc, 2.0 * _scalar(scale))

    @classmethod
    def cdf(cls, x, df, loc=0.0, scale=1.0):
        return gamma.cdf(x, _scalar(df) / 2, loc, 2.0 * _scalar(scale))

    @classmethod
    def ppf(cls, q, df, loc=0.0, scale=1.0):
        return gamma.ppf(q, _scalar(df) / 2, loc, 2.0 * _scalar(scale))


class skewnorm(Distribution):
    """Azzalini skew normal with shape ``a`` (scipy ``skewnorm``); the JAX
    class has no ``ppf``, and neither has this one."""
    name = "skewnorm"

    @classmethod
    def rvs(cls, a, loc=0.0, scale=1.0, size=1, generator=None):
        # conditional representation: z = delta |z0| + sqrt(1-delta^2) z1
        shape = _draw_shape(size, a, loc, scale)
        device = draw_device(generator)
        a = _filled(a, shape, device)
        delta = a * torch.rsqrt(1.0 + a * a)
        z0 = torch.randn(shape, generator=generator, device=device)
        z1 = torch.randn(shape, generator=generator, device=device)
        z = delta * torch.abs(z0) + torch.sqrt(1.0 - delta * delta) * z1
        return loc + scale * z

    @classmethod
    def logpdf(cls, x, a, loc=0.0, scale=1.0):
        z = (_f32(x) - loc) / scale
        return (math.log(2.0) + norm.logpdf(z)
                + special.norm_logcdf(_scalar(a) * z) - _log(scale, z))

    @classmethod
    def cdf(cls, x, a, loc=0.0, scale=1.0):
        x = _f32(x)
        return special.skewnorm_cdf(x, _tensor(a, x), loc, scale)


class weibull_min(Distribution):
    """Weibull with shape ``c`` (scipy ``weibull_min``)."""
    name = "weibull_min"

    @classmethod
    def rvs(cls, c, loc=0.0, scale=1.0, size=1, generator=None):
        shape = _draw_shape(size, c, loc, scale)
        u = torch.rand(shape, generator=generator,
                       device=draw_device(generator))
        # uniform on [1e-7, 1), as the JAX package draws it
        u = 1e-7 + (1.0 - 1e-7) * u
        return loc + scale * (-torch.log(u)) ** (1.0 / _scalar(c))

    @classmethod
    def logpdf(cls, x, c, loc=0.0, scale=1.0):
        z = (_f32(x) - loc) / scale
        c = _scalar(c)
        safe = torch.where(z > 0, z, 1.0)
        lp = (_log(c, z) + (c - 1) * torch.log(safe) - safe ** c
              - _log(scale, z))
        return torch.where(z > 0, lp, -math.inf)

    @classmethod
    def cdf(cls, x, c, loc=0.0, scale=1.0):
        z = (_f32(x) - loc) / scale
        return torch.where(
            z > 0, -torch.expm1(-torch.where(z > 0, z, 1.0) ** _scalar(c)),
            0.0)

    @classmethod
    def ppf(cls, q, c, loc=0.0, scale=1.0):
        q = _f32(q)
        val = loc + scale * (-torch.log1p(-q)) ** (1.0 / _scalar(c))
        return _ppf_nan_guard(q, val)


class ScipyHostDistribution(Distribution):
    """Host adapter around any ``scipy.stats`` distribution (or any object
    with a ``random_state``-style ``rvs``).

    A node built on it is marked ``host=True``, so its program runs through
    the host executor (:meth:`CompiledProgram.run_host
    <elfi_tpu_torch.compile.compiler.CompiledProgram.run_host>`), which
    hands ``rvs`` a ``RandomState`` seeded by :func:`host_seed` from the
    node's stream seed: a draw stays a function of (seed, batch, node).
    Draws and densities are numpy arrays.  Methods that fuse the prior on
    the device need torch distributions."""

    host = True

    def __init__(self, dist, name=None):
        if isinstance(dist, str):
            import scipy.stats as ss
            obj = getattr(ss, dist, None)
            if obj is None or not hasattr(obj, "rvs"):
                raise ValueError(f"scipy.stats has no distribution {dist!r}")
            name, dist = dist, obj
        if not hasattr(dist, "rvs"):
            raise ValueError(
                f"{dist!r} cannot be used as a distribution: no rvs method")
        self.scipy_dist = dist
        self.name = name or getattr(dist, "name", None) \
            or getattr(getattr(dist, "dist", None), "name", None) \
            or type(dist).__name__
        # does rvs take random_state?  From the signature when it can be
        # read (None = unknown, settled at the first call): an rvs that
        # cannot be seeded draws from the global numpy stream, seeded
        # around the call (:meth:`rvs`), never unseeded
        try:
            params = inspect.signature(dist.rvs).parameters
            self._rvs_seedable = True if "random_state" in params else None
        except (TypeError, ValueError):
            self._rvs_seedable = None

    @staticmethod
    def _random_state(generator=None, random_state=None):
        if random_state is not None:
            return random_state
        if generator is not None:
            return np.random.RandomState(host_seed(generator))
        return np.random

    def rvs(self, *params, size=1, generator=None, random_state=None):
        """A numpy draw; ``random_state`` wins over ``generator``, whose
        seed gives the ``RandomState`` (:func:`host_seed`); with neither,
        numpy's global stream."""
        rs = self._random_state(generator, random_state)
        params = [to_numpy(p) for p in params]
        if self._rvs_seedable is not False:
            try:
                out = self.scipy_dist.rvs(*params, size=size,
                                          random_state=rs)
                self._rvs_seedable = True
                return out
            except TypeError:
                if self._rvs_seedable:
                    raise    # rvs takes random_state: a real param error
                self._rvs_seedable = False
        # an rvs without random_state draws from the global numpy stream:
        # seed it around the call and restore the caller's state, so the
        # draw stays a function of the seed
        if isinstance(rs, np.random.RandomState):
            saved = np.random.get_state()
            np.random.set_state(rs.get_state())
            try:
                return self.scipy_dist.rvs(*params, size=size)
            finally:
                np.random.set_state(saved)
        return self.scipy_dist.rvs(*params, size=size)

    def _delegate(self, method, x, *params):
        fn = getattr(self.scipy_dist, method, None)
        if fn is None and method in ("pdf", "logpdf"):   # discrete
            fn = getattr(self.scipy_dist, method.replace("pdf", "pmf"), None)
        if fn is None:
            raise AttributeError(
                f"{self.name} has no {method} (host scipy adapter)")
        return fn(to_numpy(x), *(to_numpy(p) for p in params))

    def pdf(self, x, *params):
        return self._delegate("pdf", x, *params)

    def logpdf(self, x, *params):
        return self._delegate("logpdf", x, *params)

    def cdf(self, x, *params):
        return self._delegate("cdf", x, *params)

    def ppf(self, q, *params):
        return self._delegate("ppf", q, *params)

    def gradient_logpdf(self, x, *params):
        """3-point numerical gradient in float64: a host density has no
        autograd."""
        x = np.asarray(to_numpy(x), np.float64)
        h = 1e-5 * np.maximum(np.abs(x), 1.0)
        return ((self.logpdf(x + h, *params)
                 - self.logpdf(x - h, *params)) / (2 * h))


def wrap_if_foreign(distribution):
    """Wrap scipy-style (``random_state``-driven) distribution objects in
    the host adapter; the port's own distributions pass through.

    Native means a :class:`Distribution` subclass or instance, or a
    duck-typed object whose ``rvs`` declares a ``generator`` parameter.
    Anything from ``scipy.*`` (frozen or not), and any other object with an
    ``rvs``, goes through :class:`ScipyHostDistribution`."""
    if isinstance(distribution, Distribution) or (
            isinstance(distribution, type)
            and issubclass(distribution, Distribution)):
        return distribution
    if not type(distribution).__module__.startswith("scipy."):
        try:
            if "generator" in inspect.signature(
                    distribution.rvs).parameters:
                return distribution
        except (TypeError, ValueError, AttributeError):
            pass
    return ScipyHostDistribution(distribution)


_REGISTRY = {d.name: d for d in (uniform, norm, truncnorm,
                                 multivariate_normal, lognorm, expon, gamma,
                                 beta, binom, poisson, levy_stable, t,
                                 cauchy, laplace, chi2, skewnorm,
                                 weibull_min)}
_REGISTRY["normal"] = norm
_REGISTRY["exponential"] = expon
_REGISTRY["student_t"] = t


def from_name(name):
    """Resolve a distribution by scipy-style name: the port's own first,
    then any ``scipy.stats`` distribution through the host adapter."""
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        pass
    try:
        return ScipyHostDistribution(name)
    except ValueError:
        raise ValueError(
            f"Unknown distribution {name!r}: not one of the port's "
            f"{sorted(_REGISTRY)} and not a scipy.stats distribution. Pass "
            f"an elfi_tpu_torch.Distribution subclass for custom "
            f"distributions.") from None
