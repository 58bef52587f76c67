"""Float32 arithmetic as XLA's CPU code computes it, in torch.

The JAX package's observed data come out of XLA's CPU code, which has its
own ``log``, ``log1p`` and ``exp`` (Cephes' single-precision formulas)
contracts a multiply feeding an add into one fused multiply-add, and
sums in an order of its own.  :func:`fma`, :func:`log`, :func:`log1p`,
:func:`exp`, :func:`reduce_sum` and :func:`cumsum` reproduce them bit for
bit (held against the JAX package on the CPU by the tests), so that a
draw of :mod:`elfi_tpu_torch.utils.threefry` and a recursion that amplifies
an ulp (the chaotic Ricker map, an event loop's choice of reaction) give
the JAX package's result.  Only IEEE operations are used (float64 for the
fused multiply-add), so a CUDA device gives the same bits as the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["fma", "log", "log1p", "exp", "erf_inv", "lgamma",
           "running_sum", "reduce_sum", "cumsum"]


def fma(a, b, c):
    """``a * b + c`` rounded once to float32 (XLA's CPU code contracts a
    multiply feeding an add into a fused multiply-add): the float64
    product of two floats is exact, and the float64 sum is rounded to
    float32 (a double rounding that differs from a true FMA only on exact
    float64 ties).  A Python number is a float32 constant, as XLA holds
    it."""
    return (torch.as_tensor(a).double() * _c32(b) + _c32(c)).to(
        torch.float32)


def _c32(v):
    """A constant rounded to float32, as XLA holds it (a tensor as it
    is)."""
    return v if isinstance(v, torch.Tensor) else float(np.float32(v))


_MIN_NORMAL = float(np.finfo(np.float32).tiny)
_SQRT_HALF = _c32(0.707106781186547524)
#: Cephes' logf polynomial, highest degree first
_LOG_P = tuple(map(_c32, (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1)))
_LOG_Q1 = _c32(-2.12194440e-4)
_LOG_Q2 = _c32(0.693359375)


def log(x):
    """The natural log in float32 as XLA's CPU code computes it (Cephes'
    ``logf``: the mantissa moved to [sqrt(1/2), sqrt(2)), a degree-9
    polynomial, the exponent added in two parts), bit for bit."""
    bits = torch.clamp(x, min=_MIN_NORMAL).view(torch.int32)
    e = ((bits >> 23) & 0xFF).to(torch.float32) - 126.0
    mant = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    small = mant < _SQRT_HALF
    m = (mant - 1.0) + torch.where(small, mant, 0.0)
    e = torch.where(small, e - 1.0, e)
    m2 = m * m
    m3 = m2 * m
    p = _LOG_P
    y = fma(m, p[0], p[1])
    y1 = fma(m, p[3], p[4])
    y2 = fma(m, p[6], p[7])
    y = fma(y, m, p[2])
    y1 = fma(y1, m, p[5])
    y2 = fma(y2, m, p[8])
    y = fma(y, m3, y1)
    y = fma(y, m3, y2)
    y = fma(y, m3, e * _LOG_Q1)
    out = fma(e, _LOG_Q2, fma(m2, -0.5, m) + y)
    # a subnormal input reads as 0, as in XLA's CPU code
    out = torch.where(x >= _MIN_NORMAL, out,
                      torch.where(x >= 0, -math.inf, math.nan))
    return torch.where(x == math.inf, math.inf, out)


_LOG2E = _c32(1.44269504088896341)
#: Cephes' expf polynomial, highest degree first
_EXP_P = tuple(map(_c32, (
    1.9875691500E-4, 1.3981999507E-3, 8.3334519073E-3, 4.1665795894E-2,
    1.6666665459E-1, 5.0000001201E-1)))


def exp(x):
    """``e^x`` in float32 as XLA's CPU code computes it (Cephes' ``expf``:
    ``n = floor(x log2(e) + 1/2)`` clamped to [-127, 127], the reduced
    argument in two parts, a degree-5 polynomial, times ``2^n``), bit for
    bit."""
    x = torch.clamp(x, -87.8, 88.8)
    n = torch.clamp(torch.floor(fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma(n, -_LOG_Q2, x)
    r = fma(n, -_LOG_Q1, r)
    z = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        z = fma(z, r, c)
    z = 1.0 + fma(z, r * r, r)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = z * pow2
    # XLA's CPU code flushes subnormal results to 0
    return torch.where(out < _MIN_NORMAL, 0.0, out)


#: Cephes' log1p rational function, highest degree first
_LOG1P_P = tuple(map(_c32, (
    4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
    6.5787325942061044846969E0, 2.9911919328553073277375E1,
    6.0949667980987787057556E1, 5.7112963590585538103336E1,
    2.0039553499201281259648E1)))
_LOG1P_Q = tuple(map(_c32, (
    1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
    2.2176239823732856465394E2, 3.0909872225312059774938E2,
    2.1642788614495947685003E2, 6.0118660497603843919306E1)))
_LOG1P_SMALL = _c32(0.41421356237309504880)


def _horner(x, coeffs):
    p = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = fma(p, x, c)
    return p


def log1p(x):
    """``log(1 + x)`` in float32 as XLA's CPU code computes it: Cephes'
    rational function below ``|x| = sqrt(2) - 1``, :func:`log` of ``1 + x``
    above, bit for bit."""
    x2 = x * x
    s = _horner(x, _LOG1P_P) / _horner(x, _LOG1P_Q)
    s = x + fma(x2, -0.5, (x * x2) * s)
    return torch.where(x.abs() < _LOG1P_SMALL, s, log(x + 1.0))


def erf_inv(x):
    """The inverse error function in float32 by Giles' single-precision
    polynomials (XLA's expansion): ``w = -log1p(-x^2)``, one polynomial in
    ``w - 2.5`` below ``w = 5``, one in ``sqrt(w) - 3`` above;
    ``erf_inv(+-1) = +-inf``.  Bit for bit below ``w = 5``; above, 137 of
    the inputs differ from XLA's by 1 or 2 ulp."""
    w = -log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _ERF_INV_LEAD[0], _ERF_INV_LEAD[1])
    for lo, hi in _ERF_INV_COEFFS:
        p = fma(p, w, torch.where(small, lo, hi))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


#: Giles' coefficients (w < 5, w >= 5), highest degree first
_ERF_INV_LEAD = (_c32(2.81022636e-08), _c32(-0.000200214257))
_ERF_INV_COEFFS = tuple((_c32(a), _c32(b)) for a, b in (
    (3.43273939e-07, 0.000100950558), (-3.5233877e-06, 0.00134934322),
    (-4.39150654e-06, -0.00367342844), (0.00021858087, 0.00573950773),
    (-0.00125372503, -0.0076224613), (-0.00417768164, 0.00943887047),
    (0.246640727, 1.00167406), (1.50140941, 2.83297682)))


#: XLA's Lanczos approximation of lgamma (g = 7, eight terms)
_LANCZOS_G_HALF = 7.5
_LOG_LANCZOS_G_HALF = _c32(math.log(7.5))
_INV_LANCZOS_G_HALF = _c32(1 / 7.5)
_LOG_SQRT_2PI = _c32(math.log(math.sqrt(2 * math.pi)))
_LOG_PI = _c32(math.log(math.pi))
_PI = _c32(math.pi)
_LANCZOS_BASE = _c32(0.99999999999980993227684700473478)
_LANCZOS_COEFFS = tuple(map(_c32, (
    676.520368121885098567009190444019, -1259.13921672240287047156078755283,
    771.3234287776530788486528258894, -176.61502916214059906584551354,
    12.507343278686904814458936853, -0.13857109526572011689554707,
    9.984369578019570859563e-6, 1.50563273514931155834e-7)))


def lgamma(x):
    """``log |Gamma(x)|`` in float32 by XLA's Lanczos expansion (with the
    reflection formula below 0.5), which the Poisson sampler's acceptance
    test uses.  Not bit for bit: at a few small integers, where the
    Lanczos sum cancels, it is up to 12 ulp from XLA's."""
    reflect = x < 0.5
    z = torch.where(reflect, -x, x - 1.0)
    acc = torch.full_like(z, _LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS_COEFFS):
        acc = acc + c / (z + float(i + 1))
    t = z + _LANCZOS_G_HALF
    log_t = _LOG_LANCZOS_G_HALF + log1p(z * _INV_LANCZOS_G_HALF)
    log_y = fma(z + 0.5 - t / log_t, log_t, _LOG_SQRT_2PI) + log(acc)
    abs_x = x.abs()
    frac = abs_x - torch.floor(abs_x)
    frac = torch.where(frac > 0.5, 1.0 - frac, frac)
    denom = log(torch.sin(_PI * frac))
    reflected = torch.where(torch.isfinite(denom),
                            _LOG_PI - denom - log_y, -denom)
    out = torch.where(reflect, reflected, log_y)
    return torch.where(torch.isinf(x), math.inf, out)



#: XLA's CPU code sums a reduced dimension longer than this in windows of
#: this length (its tree-reduction rewrite), and scans a dimension longer
#: than ``_SCAN_BASE`` in blocks of that length
_REDUCE_WINDOW = 32
_SCAN_BASE = 16


def running_sum(x, dim):
    """Running float32 sums along ``dim``, each element's taken in index
    order with one rounding an add, as XLA's CPU code sums inside a
    window.  torch's ``cumsum`` on the CPU carries a float64 sum, so the
    CPU goes through numpy's float32 accumulate; on CUDA torch scans a
    dimension that is not the innermost one with a thread a column, in
    order (held against numpy on the card by the tests)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.add.accumulate(
            x.contiguous().numpy(), axis=dim))
    y = x.movedim(dim, 0)
    lone = y[0].numel() == 1            # one column: torch scans it in a tree
    if lone:
        y = torch.cat([y.reshape(-1, 1), torch.zeros_like(
            y.reshape(-1, 1))], dim=1)
    y = y.contiguous().cumsum(0)
    if lone:
        y = y[:, :1].reshape(x.movedim(dim, 0).shape)
    return y.movedim(0, dim)


def _windowed(x, dim, window):
    """``dim`` padded with zeros to whole windows (the padding split as
    XLA splits it, the odd element after) and split into (windows,
    window)."""
    n = x.shape[dim]
    pad = -n % window
    lo = pad // 2
    x = x.movedim(dim, -1)
    x = torch.nn.functional.pad(x, (lo, pad - lo))
    return x.reshape(*x.shape[:-1], -1, window).movedim((-2, -1),
                                                        (dim, dim + 1))


def reduce_sum(x, dims):
    """``x.sum(dims)`` over trailing dimensions in XLA's CPU order.  If a
    reduced dimension is longer than 32, each such dimension is cut into
    windows of 32 (each other reduced dimension is one window), a window
    is summed in row-major order, and the windows' sums are summed along
    the last reduced dimension, then along the one before; otherwise the
    elements are summed in row-major order.  Adding the zeros the padding
    puts in is exact, so where they fall does not matter."""
    dims = sorted(d % x.dim() for d in dims)
    lead = x.dim() - len(dims)
    if dims != list(range(lead, x.dim())):
        raise ValueError("reduce_sum reduces trailing dimensions")
    if max(x.shape[d] for d in dims) <= _REDUCE_WINDOW:
        return running_sum(x.reshape(*x.shape[:lead], -1), -1)[..., -1]
    for i, d in enumerate(dims):        # (..., windows, window, ...)
        n = x.shape[lead + 2 * i]
        x = _windowed(x, lead + 2 * i, _REDUCE_WINDOW
                      if n > _REDUCE_WINDOW else n)
    k = len(dims)
    x = x.permute(*range(lead), *(lead + 2 * i for i in range(k)),
                  *(lead + 2 * i + 1 for i in range(k)))
    x = running_sum(x.reshape(*x.shape[:lead + k], -1), -1)[..., -1]
    for _ in range(k):
        x = running_sum(x, -1)[..., -1]
    return x


def cumsum(x):
    """The running sums along the last dimension in XLA's CPU order: a
    dimension longer than 16 is cut into blocks of 16, each block scanned
    in order, the blocks' totals scanned the same way (recursively), and
    each block's scan added to the sum of the blocks before it."""
    n = x.shape[-1]
    if n <= _SCAN_BASE:
        return running_sum(x, -1)
    x = torch.nn.functional.pad(x, (0, -n % _SCAN_BASE))
    blocks = running_sum(x.reshape(*x.shape[:-1], -1, _SCAN_BASE), -1)
    before = torch.nn.functional.pad(cumsum(blocks[..., -1])[..., :-1],
                                     (1, 0))
    return (blocks + before[..., None]).reshape(x.shape)[..., :n]
