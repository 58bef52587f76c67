"""Per-node random streams.

The JAX package derives each stochastic node's key as
``fold_in(fold_in(key(seed), batch_index), node_uid)``.  Here the same
structure is plain 64-bit integer arithmetic on the host (splitmix64
finalisers), so the stream seed of any (seed, batch, node) is known without
touching the device, and seeding a generator with it never synchronises.

Invariants (the same as the JAX package's):

- a node's stream depends only on (master seed, batch index, node name),
  so adding an unrelated node leaves every existing stream unchanged;
- every execution path (batch-at-a-time, fused loop) derives the same
  seeds, so they give bit-identical results.

Torch's generators do not give ``jax.random``'s bits: stochastic results
agree with the JAX package statistically, not bitwise.  On the CPU, torch's
Mersenne-Twister generator keeps the low 32 bits of the seed; on CUDA the
Philox generators (torch's and the kernels') take all 64.
"""

from __future__ import annotations

import torch

__all__ = ["fold_in", "stream_seed", "generator"]

_MASK = (1 << 64) - 1


def _mix(z):
    """splitmix64: a bijection on 64-bit integers with full avalanche."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return z ^ (z >> 31)


def fold_in(key, data):
    """A new 64-bit key from ``key`` and the integer ``data``.  For a fixed
    key it is a bijection of ``data`` (and the other way round), and it is
    not symmetric: mixing the two arguments alike would make
    ``fold_in(_mix(a), b) == fold_in(_mix(b), a)``."""
    return _mix(_mix(key) ^ (int(data) & _MASK))


def stream_seed(seed, batch_index, uid):
    """64-bit seed of node ``uid``'s stream in batch ``batch_index``."""
    return fold_in(fold_in(_mix(int(seed) & _MASK), batch_index), uid)


def generator(seed, device):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)
