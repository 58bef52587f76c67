"""The summation order the port's kernels share: float32 sums over blocks
of consecutive terms, added in float64.

A kernel converts only its block sums to double, since a conversion to a
64-bit type issues at 16 per SM per clock on Hopper, an eighth of the FP32
rate.  The plain versions sum in exactly this order, so that a kernel fed
the same noise agrees with its plain version to the last bit or so.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["BLOCK", "blocked_sum"]

#: terms per float32 block (``kBlock`` in ``csrc/*.cu``)
BLOCK = 8


def blocked_sum(terms, block=BLOCK):
    """Sum of ``terms`` (batch, n) float32 over dim 1 as float64: each block
    of ``block`` consecutive terms ``[b * block, (b + 1) * block)`` summed
    left to right from 0 in float32, then the block sums added in order
    from 0 in float64.  Padding the last block with zeros changes no sum."""
    n = terms.shape[1]
    n_blocks = -(-n // block)
    blocks = F.pad(terms, (0, n_blocks * block - n)).reshape(
        terms.shape[0], n_blocks, block)
    acc = torch.zeros_like(blocks[:, :, 0])
    for t in range(block):
        acc = acc + blocks[:, :, t]
    s = torch.zeros(terms.shape[0], dtype=torch.float64, device=terms.device)
    for b in range(n_blocks):
        s = s + acc[:, b].double()
    return s
