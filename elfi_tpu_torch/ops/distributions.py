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
"""

from __future__ import annotations

import math

import torch

__all__ = ["Distribution", "uniform", "norm", "truncnorm", "expon",
           "multivariate_normal", "from_name"]


def _shape(p):
    return tuple(p.shape) if isinstance(p, torch.Tensor) else ()


def _draw_shape(size, *params):
    """Result shape for a univariate draw of ``size`` with given params.
    ``size`` may be an int (batch length) or an explicit shape tuple."""
    b = torch.broadcast_shapes(*[_shape(p) for p in params]) if params \
        else ()
    b = tuple(b)
    if isinstance(size, (tuple, list)):
        return tuple(torch.broadcast_shapes(tuple(size), b))
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


class uniform(Distribution):
    """Uniform on ``[loc, loc + scale]`` (scipy convention)."""
    name = "uniform"

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


def _nan_outside_unit(q, val):
    """scipy parity: ``ppf(q)`` is nan outside ``[0, 1]``."""
    q = torch.as_tensor(q)
    return torch.where((q >= 0) & (q <= 1), val, math.nan)


class truncnorm(Distribution):
    """Truncated normal; ``a``/``b`` are standardized bounds (scipy)."""
    name = "truncnorm"

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
        return _nan_outside_unit(q, val)


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
        return _nan_outside_unit(q, loc - scale * torch.log1p(-q))


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


_REGISTRY = {d.name: d for d in (uniform, norm, truncnorm, expon,
                                 multivariate_normal)}
_REGISTRY["normal"] = norm


def from_name(name):
    """Resolve a distribution by scipy-style name.  Only the distributions
    that the ported models use are here so far."""
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown distribution {name!r}: the PyTorch port has "
            f"{sorted(_REGISTRY)}. Pass an elfi_tpu_torch.Distribution "
            f"subclass for custom distributions.") from None
