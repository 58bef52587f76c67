"""Special functions for the acquisition rules and the BOLFI posterior, on
tensors (counterpart of :mod:`elfi_tpu.ops.special`).

Owen's T is fixed-order Gauss-Legendre quadrature of its integral
definition, so the same expressions run inside the Adam descents and the
NUTS leapfrogs, and autograd differentiates them.  The nodes and weights
are numpy constants at module scope, as in the JAX package; a function
puts them on its input's device.

:func:`betainc`, the regularized incomplete beta function, which torch
lacks (``torch.special`` has ``gammainc`` only), is a continued fraction
with a fixed number of terms: elementwise float32 on the input's device,
nothing read back to the host."""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["owens_t", "skewnorm_cdf", "norm_cdf", "norm_logcdf",
           "betaln", "betainc"]

# 32-point Gauss-Legendre nodes and weights on [0, 1]
_GL_X_NP, _GL_W_NP = np.polynomial.legendre.leggauss(32)
_GL_X_NP = ((_GL_X_NP + 1.0) / 2.0).astype(np.float32)
_GL_W_NP = (_GL_W_NP / 2.0).astype(np.float32)


_GL_ON = {}


def _gl_nodes(device):
    """The quadrature's nodes and weights on ``device``, copied there once:
    a copy from the host waits for the device."""
    if device not in _GL_ON:
        _GL_ON[device] = (torch.as_tensor(_GL_X_NP, device=device),
                          torch.as_tensor(_GL_W_NP, device=device))
    return _GL_ON[device]


def _f32(x, device=None):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def owens_t(h, a):
    """Owen's T function
    T(h, a) = 1/(2 pi) int_0^a exp(-h^2 (1 + x^2) / 2) / (1 + x^2) dx.

    Gauss-Legendre quadrature after substituting x = a u, u in [0, 1];
    odd in ``a`` (T(h, -a) = -T(h, a)), even in ``h``.
    """
    h = _f32(h)
    a = _f32(a, h.device)
    h, a = torch.broadcast_tensors(h, a)
    hh = h[..., None]
    aa = a[..., None]
    nodes, w = _gl_nodes(h.device)
    x = aa * nodes
    integrand = torch.exp(-0.5 * hh * hh * (1.0 + x * x)) / (1.0 + x * x)
    return torch.sum(w * aa * integrand, dim=-1) / (2.0 * math.pi)


def _ndtr(x):
    """The standard normal CDF as JAX computes it: ``erfc`` in the tails,
    so the float32 result keeps its relative precision there (torch's
    ``ndtr`` loses it below about -5)."""
    half_sqrt_2 = 0.5 * math.sqrt(2.0)
    w = x * half_sqrt_2
    z = torch.abs(w)
    y = torch.where(z < half_sqrt_2, 1.0 + torch.special.erf(w),
                    torch.where(w > 0, 2.0 - torch.special.erfc(z),
                                torch.special.erfc(z)))
    return 0.5 * y


def _log_ndtr_value(x):
    """``log Phi(x)`` in JAX's float32 segments: ``-Phi(-x)`` above 5, the
    asymptotic series (order 3) below -10, ``log Phi`` between."""
    lower, upper = -10.0, 5.0
    low = torch.clamp(x, max=lower)
    x2 = low * low
    series = 1.0 - 1.0 / x2 + 3.0 / (x2 * x2) - 15.0 / (x2 * x2 * x2)
    tail = (-0.5 * x2 - torch.log(-low) - 0.5 * math.log(2.0 * math.pi)
            + torch.log(series))
    return torch.where(x > upper, -_ndtr(-x), torch.where(
        x > lower, torch.log(_ndtr(torch.clamp(x, min=lower))), tail))


class _LogNdtr(torch.autograd.Function):
    """``log Phi`` with JAX's derivative ``exp(log phi(x) - log Phi(x))``,
    which stays finite where the segments' own derivatives would not."""

    @staticmethod
    def forward(ctx, x):
        y = _log_ndtr_value(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, grad):
        x, y = ctx.saved_tensors
        return grad * torch.exp(-0.5 * x * x - 0.5 * math.log(2.0 * math.pi)
                                - y)


def norm_cdf(x, loc=0.0, scale=1.0):
    return _ndtr((_f32(x) - loc) / scale)


def norm_logcdf(x, loc=0.0, scale=1.0):
    return _LogNdtr.apply((_f32(x) - loc) / scale)


def skewnorm_cdf(x, a, loc=0.0, scale=1.0):
    """CDF of the skew-normal: Phi(z) - 2 T(z, a) with z standardized."""
    z = (_f32(x) - loc) / scale
    return torch.clamp(_ndtr(z) - 2.0 * owens_t(z, a), 0.0, 1.0)


def betaln(a, b):
    """``log B(a, b)``."""
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


#: terms of :func:`betainc`'s continued fraction.  It converges in
#: O(sqrt(max(a, b))) terms on the side of the symmetry switch where it is
#: evaluated: against scipy in float64, 32 terms leave the same error as
#: 200 for a and b up to 1e3, where the float32 front factor dominates it.
BETAINC_TERMS = 32
_TINY = 1e-30


def _betacf(a, b, x):
    """The continued fraction of ``I_x(a, b)`` by the modified Lentz method
    (Numerical Recipes' ``betacf``), ``BETAINC_TERMS`` even and odd
    steps."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0

    def clamp(v):
        return torch.where(torch.abs(v) < _TINY, torch.full_like(v, _TINY),
                           v)

    c = torch.ones_like(x)
    d = 1.0 / clamp(1.0 - qab * x / qap)
    h = d
    for m in range(1, BETAINC_TERMS + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / clamp(1.0 + aa * d)
        c = clamp(1.0 + aa / c)
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / clamp(1.0 + aa * d)
        c = clamp(1.0 + aa / c)
        h = h * d * c
    return h


def betainc(a, b, x):
    """The regularized incomplete beta function ``I_x(a, b)`` in float32,
    elementwise over the broadcast of ``a``, ``b`` and ``x``.  The fraction
    is evaluated for ``I_x(a, b)`` where ``x < (a + 1) / (a + b + 2)`` and
    for ``1 - I_{1-x}(b, a)`` above; 0 at ``x <= 0`` and 1 at ``x >= 1``."""
    x = _f32(x)
    a, b = (v.to(torch.float32) if isinstance(v, torch.Tensor)
            else torch.full_like(x, float(v)) for v in (a, b))
    a, b, x = torch.broadcast_tensors(a, b, x)
    inside = (x > 0) & (x < 1)
    xs = torch.where(inside, x, torch.full_like(x, 0.5))
    swap = xs > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - xs, xs)
    front = torch.exp(aa * torch.log(xx) + bb * torch.log1p(-xx)
                      - betaln(aa, bb)) / aa
    f = front * _betacf(aa, bb, xx)
    val = torch.where(swap, 1.0 - f, f)
    return torch.where(inside, val, torch.where(x <= 0, 0.0, 1.0))
