"""The random streams that the system under test documents, worked out
again in plain Python and PyTorch, so that the reference simulates the
same draws as the program from the seed alone.

What the program promises about its streams, and what is reproduced here:

- a stochastic node's stream in batch ``b`` is seeded with
  ``stream_seed(seed, b, uid(name))``: splitmix64 finalisers over 64-bit
  integers, ``uid`` the node name's CRC-32 with its top bit cleared;
- a node that draws through torch draws from a ``torch.Generator`` on the
  device seeded with that number (the reference asks torch for the same
  draws: ``torch.rand`` and ``torch.randn`` on a freshly seeded generator);
- a distance kernel keys Philox4x32-10 with the 64-bit stream seed and
  counts (simulation index, draw block); each call gives four 32-bit words
  and so two Box-Muller pairs, from the uniforms (2m + 1) 2^-24 (radius) and
  m 2^-23 - 1/2 (angle, in turns) of the words' low 23 bits m;
- an SMC round r >= 1 draws its proposals for batch ``b`` from a generator
  seeded with ``fold_in(fold_in(sub_seed(seed, r), 0x9E3779B9), b)``.

The reference takes the uniforms exactly and then computes in the
precision it is asked for, with accurate ``log``, ``sqrt``, ``cos`` and
``sin``: it is not bound to the kernels' approximate instructions.

Imports neither JAX nor the JAX package nor the program.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

MASK64 = (1 << 64) - 1
PROPOSAL_SALT = 0x9E3779B9

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_LO32 = 0xFFFFFFFF


def mix(z):
    """splitmix64's finaliser on a Python int."""
    z = (z + 0x9E3779B97F4A7C15) & MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
    return z ^ (z >> 31)


def fold_in(key, data):
    return mix(mix(key) ^ (int(data) & MASK64))


def node_uid(name):
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def stream_seed(seed, batch_index, name):
    """The 64-bit seed of node ``name``'s stream in batch ``batch_index``."""
    return fold_in(fold_in(mix(int(seed) & MASK64), batch_index),
                   node_uid(name))


def sub_seed(seed, index, high=2**31):
    """An SMC round's seed: numpy's SeedSequence spawn key (seed, index)."""
    ss = np.random.SeedSequence(entropy=int(seed), spawn_key=(int(index),))
    return int(ss.generate_state(1, np.uint64)[0] % high)


def proposal_seed(round_seed, batch_index):
    return fold_in(fold_in(round_seed, PROPOSAL_SALT), batch_index)


def generator(seed, device):
    return torch.Generator(device=device).manual_seed(seed)


def _mulhilo(m, c):
    """(high, low) 32-bit halves of m * c for the constant m and int64
    words c < 2^32, through 16-bit halves of m so nothing overflows."""
    mh, ml = m >> 16, m & 0xFFFF
    a = c * mh                      # < 2^48
    b = c * ml                      # < 2^48
    hi = (a + (b >> 16)) >> 16
    lo = (((a & 0xFFFF) << 16) + b) & _LO32
    return hi & _LO32, lo


def philox_words(seed, sims, blocks):
    """Philox4x32-10 under the 64-bit ``seed`` at the counters (sim,
    block) for every ``sims`` (int64, shape (S,)) and ``blocks`` (int64,
    shape (K,)): four int64 tensors (S, K) of 32-bit words."""
    a, b = seed & _LO32, seed >> 32
    c0 = (sims & _LO32)[:, None].expand(-1, blocks.numel())
    c1 = (sims >> 32)[:, None].expand(-1, blocks.numel())
    c2 = blocks[None, :].expand(sims.numel(), -1)
    c3 = torch.zeros_like(c0)
    for r in range(10):
        k0 = (a + r * _W0) & _LO32
        k1 = (b + r * _W1) & _LO32
        h0, l0 = _mulhilo(_M0, c0)
        h1, l1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = h1 ^ c1 ^ k0, l1, h0 ^ c3 ^ k1, l0
    return c0, c1, c2, c3


def _pair(x, y, dtype):
    """The Box-Muller pair of the words x (radius) and y (angle)."""
    u = ((x & 0x7FFFFF) * 2 + 1).to(torch.float64) * 2.0**-24
    v = (y & 0x7FFFFF).to(torch.float64) * 2.0**-23 - 0.5
    u, v = u.to(dtype), v.to(dtype)
    r = torch.sqrt(-2.0 * torch.log(u))
    t = (2.0 * np.pi) * v
    return r * torch.cos(t), r * torch.sin(t)


def philox_normals(seed, batch_size, n, device, dtype=torch.float32):
    """(batch_size, n) normals of a distance kernel's stream ``seed``: row
    i holds simulation i's first n normals, four a Philox call."""
    sims = torch.arange(batch_size, dtype=torch.int64, device=device)
    blocks = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    w0, w1, w2, w3 = philox_words(seed, sims, blocks)
    z0c, z0s = _pair(w0, w1, dtype)
    z1c, z1s = _pair(w2, w3, dtype)
    z = torch.stack([z0c, z0s, z1c, z1s], dim=2)    # (S, K, 4)
    return z.reshape(batch_size, -1)[:, :n]


def node_uniform(seed, batch_index, name, batch_size, device):
    """``torch.rand`` of node ``name``'s stream in a batch (float32)."""
    g = generator(stream_seed(seed, batch_index, name), device)
    return torch.rand((batch_size,), generator=g, device=device)


def node_normals(seed, batch_index, name, shape, device):
    """``torch.randn`` of node ``name``'s stream in a batch (float32)."""
    g = generator(stream_seed(seed, batch_index, name), device)
    return torch.randn(shape, generator=g, device=device)
