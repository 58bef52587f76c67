"""Counter-based Threefry-2x32 streams in torch: the JAX package's observed
data are drawn from them, so the port draws the same bits.

The layout is the JAX package's default (``threefry2x32`` with
partitionable bit generation, 32-bit floats):

- a key is an int64 tensor of shape ``(..., 2)`` that holds two uint32
  words (torch covers uint32 only in part, so every word is kept in int64
  and masked to 32 bits after each add and shift);
- ``split`` and ``random_bits`` hash the 64-bit position of each output
  element, as ``(high word, low word)``, under the key;
- the samplers turn 32 random bits into floats as the JAX package does:
  the top 23 bits become the mantissa of a float in [1, 2).

Everything runs on the key's device; :func:`key` makes a key on the global
backend's device unless told otherwise, and :func:`seed_words` /
:func:`host_split` keep a key on the host for a sequential chain of
splits.  Only the Poisson sampler reads the device back: its loops end when
every element is done.  The float arithmetic is XLA's CPU code's
(:mod:`elfi_tpu_torch.utils.xla_math`), in IEEE operations only, so a CUDA
device draws the bits the CPU draws.

Exactness (held against ``jax.random`` on the CPU by the tests): keys,
bits, ``uniform``, ``exponential`` and ``randint`` are bit for bit;
``normal`` is within 2 ulp over every input ``uniform`` can give (137 of
the 2^23 differ, all in the tails beyond |z| = 2.9); ``poisson``'s counts
are equal on a grid of rates on both sides of 10.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .xla_math import erf_inv, fma, lgamma, log, log1p

__all__ = ["key", "seed_words", "host_split", "threefry_2x32", "split",
           "fold_in", "random_bits", "uniform", "normal", "exponential",
           "randint", "poisson"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: ``nextafter(-1, 0)`` in float32: the low end of ``normal``'s uniform
_NORMAL_LO = float(np.nextafter(np.float32(-1), np.float32(0)))
_SQRT2 = float(np.sqrt(np.float32(2)))


def key(seed, device=None):
    """The key of an integer ``seed`` on ``device`` (None: the global
    backend's): see :func:`seed_words`."""
    from ..parallel.backends import resolve_device
    return torch.tensor(seed_words(seed), dtype=torch.int64,
                        device=resolve_device(device))


def seed_words(seed):
    """The two words of ``seed``'s key as host integers: the seed's 64-bit
    two's complement split into (high, low), the high word 0 for a seed
    that fits in 32 bits (the JAX package runs with 64-bit types off, so a
    seed is an int32 there: a negative seed keeps only its low word)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise OverflowError(f"seed {seed} does not fit in 32 bits")
    return (0, seed & _M32)


def host_split(words, num=2):
    """:func:`split` of a key held on the host as two integers: ``num`` new
    keys, each a pair of integers.  A sequential chain of splits (an event
    loop's) runs here, one short integer hash a step, and only the keys
    that draw go to the device."""
    return [_hash(words[0], words[1], 0, j) for j in range(num)]


def _rotl(x, d):
    return ((x << d) & _M32) | (x >> (32 - d))


def _hash(k0, k1, x0, x1):
    """The Threefry-2x32 block function (20 rounds): the hashes of the
    count pairs ``(x0, x1)`` under the key words ``(k0, k1)``, int64
    tensors broadcast together or host integers."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def threefry_2x32(key, count):
    """The hash of the uint32 words ``count`` under ``key`` (shape (2,)):
    the flat count, padded to an even length, is split into halves that are
    hashed as pairs, and the result is cut back to ``count``'s shape."""
    flat = count.reshape(-1)
    n = flat.numel()
    if n % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    half = flat.numel() // 2
    y0, y1 = _hash(key[..., 0], key[..., 1], flat[:half], flat[half:])
    return torch.cat([y0, y1])[:n].reshape(count.shape)


def _counts(shape, device):
    """The 64-bit position of each element of ``shape``, as (high, low)
    words."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & _M32


def _bits_pair(key, shape):
    """The two hashed words of each position of ``shape`` under ``key``;
    a batch of keys (..., 2) gives a result of shape (..., *shape)."""
    hi, lo = _counts(shape, key.device)
    pad = (None,) * len(shape)
    k0 = key[..., 0][(..., *pad)]
    k1 = key[..., 1][(..., *pad)]
    return _hash(k0, k1, hi, lo)


def split(key, num=2):
    """``num`` new keys (an int or a shape), stacked on a leading axis."""
    shape = tuple(num) if isinstance(num, (tuple, list)) else (int(num),)
    y0, y1 = _bits_pair(key, shape)
    return torch.stack([y0, y1], dim=-1)


def fold_in(key, data):
    """The key of ``key`` folded with the 32-bit integer ``data``."""
    y0, y1 = _hash(key[..., 0], key[..., 1], torch.zeros_like(key[..., 0]),
                   torch.full_like(key[..., 0], int(data) & _M32))
    return torch.stack([y0, y1], dim=-1)


def random_bits(key, shape=()):
    """32 random bits (int64 in [0, 2^32)) for each element of ``shape``;
    a batch of keys (..., 2) gives (..., *shape)."""
    y0, y1 = _bits_pair(key, tuple(shape))
    return y0 ^ y1


def _unit(key, shape):
    """Floats in [0, 1): the top 23 random bits as the mantissa of a float
    in [1, 2), minus 1."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _f32(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def uniform(key, shape=(), minval=0., maxval=1.):
    """Float32 uniforms on [minval, maxval); the scaling is one rounding
    of ``u * (maxval - minval) + minval`` (XLA's CPU code contracts it
    into a fused multiply-add)."""
    u = _unit(key, shape)
    lo, hi = _f32(minval, u.device), _f32(maxval, u.device)
    return torch.maximum(lo, fma(u, hi - lo, lo))


def normal(key, shape=()):
    """Float32 standard normals: ``sqrt(2) erf_inv(u)`` with ``u`` uniform
    on ``(nextafter(-1, 0), 1)``."""
    return _SQRT2 * erf_inv(uniform(key, shape, _NORMAL_LO, 1.))


def exponential(key, shape=()):
    """Float32 standard exponentials, ``-log1p(-u)``."""
    return -log1p(-uniform(key, shape))


def randint(key, shape, minval, maxval):
    """Int32 integers on [minval, maxval) (``maxval`` may be a tensor):
    two words of bits a value from two split keys, reduced modulo the span
    in uint32 arithmetic; a span <= 0 gives ``minval``."""
    k1, k2 = split(key)
    high = random_bits(k1, shape)
    low = random_bits(k2, shape)
    device = key.device
    lo = torch.as_tensor(minval, dtype=torch.int64, device=device)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=device)
    span = torch.where(hi <= lo, 1, (hi - lo) & _M32)
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span
    offset = (((high % span) * mult & _M32) + low % span) & _M32
    return (lo + offset % span).to(torch.int32)


def poisson(key, lam, shape=None):
    """Int32 Poisson counts of rate ``lam`` (broadcast to ``shape``):
    Knuth's product of uniforms where ``lam < 10`` and Hoermann's
    transformed rejection elsewhere, each looping over the whole array,
    with a fresh split each round, until every element is done;
    ``lam == 0`` gives 0."""
    lam = _f32(lam, key.device)
    shape = tuple(lam.shape) if shape is None else tuple(shape)
    lam = torch.broadcast_to(lam, shape)
    knuth = torch.isnan(lam) | (lam < 10)
    counts = torch.where(
        knuth, _poisson_knuth(key, torch.where(knuth, lam, 0.0), shape),
        _poisson_rejection(key, torch.where(knuth, 1e5, lam), shape))
    return torch.where(lam == 0, 0, counts).to(torch.int32)


def _poisson_knuth(key, lam, shape):
    k = torch.zeros(shape, dtype=torch.int64, device=lam.device)
    log_prod = torch.zeros(shape, device=lam.device)
    while bool((log_prod > -lam).any()):
        key, sub = split(key)
        k = torch.where(log_prod > -lam, k + 1, k)
        log_prod = log_prod + log(uniform(sub, shape))
    return k - 1


def _poisson_rejection(key, lam, shape):
    # each multiply feeding an add is one fused multiply-add, as XLA's CPU
    # code computes it
    log_lam = log(lam)
    b = fma(2.53, torch.sqrt(lam), 0.931)
    a = fma(0.02483, b, -0.059)
    inv_alpha = 1.1239 + 1.1328 / (b - 3.4)
    v_r = 0.9277 - 3.6224 / (b - 2)
    k_out = torch.full(shape, -1.0, device=lam.device)
    accepted = torch.zeros(shape, dtype=torch.bool, device=lam.device)
    while not bool(accepted.all()):
        key, sub0, sub1 = split(key, 3)
        u = uniform(sub0, shape) - 0.5
        v = uniform(sub1, shape)
        us = 0.5 - u.abs()
        k = torch.floor(fma(2 * a / us + b, u, lam) + 0.43)
        s = log(v * inv_alpha / (a / (us * us) + b))
        t = fma(k, log_lam, -lam) - lgamma(k + 1)
        accept = (((us >= 0.07) & (v <= v_r))
                  | (~((k < 0) | ((us < 0.013) & (v > us))) & (s <= t)))
        k_out = torch.where(accept, k, k_out)
        accepted |= accept
    return k_out
