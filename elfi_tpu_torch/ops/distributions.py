"""Probability distributions with a scipy-like interface, in PyTorch
(counterpart of :mod:`elfi_tpu.ops.distributions`).

Conventions
-----------
- ``rvs(*params, size=n, generator=g)`` returns a tensor on ``g``'s device
  whose leading axis is the batch axis of length ``n``; the explicit
  ``torch.Generator`` replaces the JAX package's ``key``.
- Univariate distributions use scipy's ``loc``/``scale`` parameterisation.
- Parameters may be Python scalars or per-batch tensors of shape
  ``(n, ...)`` (hierarchical priors, e.g. MA2's ``t2 | t1``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["Distribution", "uniform", "norm", "from_name"]


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


def _device(generator):
    return generator.device if generator is not None else torch.device("cpu")


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
        u = torch.rand(shape, generator=generator, device=_device(generator))
        return loc + scale * u

    @classmethod
    def logpdf(cls, x, loc=0.0, scale=1.0):
        x = torch.as_tensor(x)
        inside = (x >= loc) & (x <= loc + scale)
        return torch.where(inside,
                           -torch.log(torch.as_tensor(scale, dtype=x.dtype)),
                           -math.inf)

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
        z = torch.randn(shape, generator=generator, device=_device(generator))
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


_REGISTRY = {"uniform": uniform, "norm": norm, "normal": norm}


def from_name(name):
    """Resolve a distribution by scipy-style name.  Only the distributions
    of the MA2 slice are ported so far."""
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"Unknown distribution {name!r}: the PyTorch port has "
            f"{sorted(_REGISTRY)}. Pass an elfi_tpu_torch.Distribution "
            f"subclass for custom distributions.") from None
