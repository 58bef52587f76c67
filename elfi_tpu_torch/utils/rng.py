"""Per-node random streams.

The JAX package derives each stochastic node's key as
``fold_in(fold_in(key(seed), batch_index), node_uid)``.  Here the same
structure is plain 64-bit integer arithmetic on the host (splitmix64
finalisers), so the stream seed of any (seed, batch, node) is known without
touching the device, and seeding a generator with it never synchronises.

Invariants (the same as the JAX package's):

- a node's stream depends only on (master seed, batch index, node name),
  so adding an unrelated node leaves every existing stream unchanged;
- every execution path (batch-at-a-time, fused loop, a CUDA graph
  replayed) derives the same seeds, so they give bit-identical results.

A program asks for its generators through :func:`node_generator` and
:func:`batch_generator`, and a kernel for its key through
:func:`stream_key`.  Eagerly they make a fresh generator seeded on the
host.  While :mod:`elfi_tpu_torch.utils.capture` records or captures a
function they go to its stream source instead: a captured graph keeps one
persistent generator per stream, registered with the graph and seeded
anew on the host before each replay, and a kernel reads its key from
device memory that each replay refills.

Torch's generators do not give ``jax.random``'s bits: stochastic results
agree with the JAX package statistically, not bitwise.  On the CPU, torch's
Mersenne-Twister generator keeps the low 32 bits of the seed; on CUDA the
Philox generators (torch's and the kernels') take all 64.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["fold_in", "stream_seed", "derive", "generator", "node_generator",
           "batch_generator", "stream_key", "stream_source"]

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


def derive(family, base, batch_index, uid=None):
    """The seed of a per-batch stream: ``stream_seed(base, batch_index,
    uid)`` for a node's stream (``family`` "node"), ``fold_in(base,
    batch_index)`` for a batch's own stream ("batch")."""
    if family == "node":
        return stream_seed(base, batch_index, uid)
    return fold_in(base, batch_index)


_local = threading.local()


class stream_source:
    """Context manager: while it is open, this thread's stream requests go
    to ``source`` (an object with ``request(family, base, batch_index,
    uid, device)`` and ``key(generator)``)."""

    def __init__(self, source):
        self.source = source

    def __enter__(self):
        self.saved = getattr(_local, "source", None)
        _local.source = self.source
        return self.source

    def __exit__(self, *exc):
        _local.source = self.saved


def _request(family, base, batch_index, uid, device):
    source = getattr(_local, "source", None)
    if source is None:
        return generator(derive(family, base, batch_index, uid), device)
    return source.request(family, base, batch_index, uid, device)


def node_generator(seed, batch_index, uid, device):
    """The generator of node ``uid``'s stream in batch ``batch_index``,
    seeded with :func:`stream_seed`."""
    return _request("node", seed, batch_index, uid, device)


def batch_generator(key, batch_index, device):
    """The generator of batch ``batch_index``'s stream under ``key``,
    seeded with ``fold_in(key, batch_index)`` (an SMC round's proposals)."""
    return _request("batch", key, batch_index, None, device)


def stream_key(generator):
    """What a kernel keys its Philox stream with: the generator's 64-bit
    seed as an int or, in a graph being captured, a 1-element int64 tensor
    on the device that holds it and that each replay refills."""
    source = getattr(_local, "source", None)
    if source is not None:
        key = source.key(generator)
        if key is not None:
            return key
    return generator.initial_seed()
