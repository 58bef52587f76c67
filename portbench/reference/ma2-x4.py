"""Plain reference of the four-card MA(2) deployment: the reference of
``ma2`` (``portbench/reference/ma2.py``: the triangle prior, the MA(2)
series, its lag-1 and lag-2 autocovariances and their euclidean distance
to the observed ones, in the precision asked for), batch by batch, with a
batch's noise drawn in blocks of at most :data:`BLOCK` rows.

A distance kernel's Philox stream counts (simulation index in the batch,
draw block), so a block of rows draws the normals those rows draw in the
whole batch: at the deployment's batch of 2**24 the whole batch's Philox
words would be 3.5 GB a tensor.  Imports neither JAX nor the JAX package
nor the program.
"""

from __future__ import annotations

import torch

from portbench.reference import streams
from portbench.reference.ma2 import (PARAMS, SCALES,  # noqa: F401
                                     observed_summaries, prior_draw)

#: the most rows whose noise is drawn at once
BLOCK = 1 << 21


def block_normals(seed, first, stop, n, device, dtype=torch.float32):
    """(stop - first, n) normals of a distance kernel's stream ``seed``:
    rows ``first .. stop - 1`` of :func:`streams.philox_normals`."""
    sims = torch.arange(first, stop, dtype=torch.int64, device=device)
    blocks = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    w0, w1, w2, w3 = streams.philox_words(seed, sims, blocks)
    z0c, z0s = streams._pair(w0, w1, dtype)
    z1c, z1s = streams._pair(w2, w3, dtype)
    z = torch.stack([z0c, z0s, z1c, z1s], dim=2)    # (S, K, 4)
    return z.reshape(stop - first, -1)[:, :n]


def blocks(batch_size, block=BLOCK):
    """(first, stop) of each block of rows of a batch, in order."""
    return [(a, min(a + block, batch_size))
            for a in range(0, batch_size, block)]


def philox_normals(seed, batch_size, n, device, dtype=torch.float32,
                   block=BLOCK):
    """The (batch_size, n) normals of stream ``seed``, drawn ``block``
    rows at a time."""
    return torch.cat([block_normals(seed, a, b, n, device, dtype)
                      for a, b in blocks(batch_size, block)])


def _distance(t1, t2, w, o):
    x = w[:, 2:] + t1[:, None] * w[:, 1:-1] + t2[:, None] * w[:, :-2]
    s1 = torch.mean(x[:, 1:] * x[:, :-1], dim=1)
    s2 = torch.mean(x[:, 2:] * x[:, :-2], dim=1)
    return torch.sqrt((s1 - o[0]) ** 2 + (s2 - o[1]) ** 2)


def simulate(config, graph, seed, batch_index, batch_size, device,
             dtype=torch.float32, block=BLOCK):
    """(theta (batch, 2), distance (batch,)) of one batch: the parameters
    from the prior's streams, the distance ``block`` rows at a time on a
    card (a distance kernel's Philox stream), else whole (the kernel's
    plain version draws ``torch.randn`` off node ``d``'s stream)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if graph != "kernel":
        raise ValueError(f"no four-card MA(2) graph {graph!r}")
    t1, t2 = prior_draw(
        streams.node_uniform(seed, batch_index, "t1", batch_size, device),
        streams.node_uniform(seed, batch_index, "t2", batch_size, device),
        dtype)
    o = torch.as_tensor(observed_summaries(config), device=device).to(dtype)
    n_w = config["n_obs"] + 2
    if torch.device(device).type != "cuda":
        w = streams.node_normals(seed, batch_index, "d", (batch_size, n_w),
                                 device).to(dtype)
        return torch.stack([t1, t2], dim=1), _distance(t1, t2, w, o)
    key = streams.stream_seed(seed, batch_index, "d")
    d = torch.cat([_distance(t1[a:b], t2[a:b],
                             block_normals(key, a, b, n_w, device, dtype), o)
                   for a, b in blocks(batch_size, block)])
    return torch.stack([t1, t2], dim=1), d
