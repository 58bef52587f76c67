"""Device-side running top-N selection for rejection sampling (counterpart
of :mod:`elfi_tpu.ops.topk`).

The buffer lives on the device and each batch is merged into it with one
sort over the concatenation of buffer keys and batch keys.  The JAX
package takes ``lax.top_k(-keys, n)``, which breaks ties toward the lower
index; ``torch.topk`` promises no order for ties, so the port takes the
first ``n`` of a *stable* ascending sort.  Both put NaN last, so the merged
keys and the gathered rows are bit-identical to the JAX package's for the
same inputs, and the buffer -> batch concatenation order makes every merge
schedule (fused loop, batch-at-a-time) select the same rows.
"""

from __future__ import annotations

import functools
import math

import torch

__all__ = ["sort_key", "accept_mask", "make_merge_fn", "init_buffers",
           "merge_core", "merge_scan", "merge_parts"]


def sort_key(d):
    """Scalar sorting distance per batch member; for 2-D distances the LAST
    column is the active one."""
    return d if d.ndim == 1 else d[..., -1]


def accept_mask(d, threshold):
    """Acceptance: every distance column within threshold."""
    ok = d <= threshold
    return ok if ok.ndim == 1 else ok.flatten(1).all(dim=1)


def init_buffers(n, batch_like, discrepancy_name):
    """Allocate top-N buffers matching a batch's shapes, dtypes and device;
    distances start at +inf."""
    buffers = {}
    for k, v in batch_like.items():
        shape = (n,) + tuple(v.shape[1:])
        if k == discrepancy_name:
            buffers[k] = torch.full(shape, math.inf, dtype=torch.float32,
                                    device=v.device)
        else:
            buffers[k] = torch.zeros(shape, dtype=v.dtype, device=v.device)
    d = batch_like[discrepancy_name]
    buffers["__key"] = torch.full((n,), math.inf, dtype=torch.float32,
                                  device=d.device)
    return buffers


def merge_core(buffers, batch, threshold, discrepancy_name):
    """Top-N merge: (buffers, batch, threshold) -> (buffers', n_accepted).

    Keeps the N smallest effective distances across everything seen so far.
    Rejected rows (above threshold, or NaN) get +inf keys, so they never
    displace an accepted row.  ``n_accepted`` is a 0-d tensor on the
    device: reading it is the caller's choice of synchronisation point.
    """
    d = batch[discrepancy_name]
    ok = accept_mask(d, threshold)
    keys_eff = torch.where(ok, sort_key(d).to(torch.float32), math.inf)
    n = buffers["__key"].shape[0]
    cat = torch.cat([buffers["__key"], keys_eff])
    keys, idx = torch.sort(cat, stable=True)
    idx = idx[:n]
    out = {"__key": keys[:n]}
    for k, v in batch.items():
        merged = torch.cat([buffers[k], v.to(buffers[k].dtype)])
        out[k] = merged.index_select(0, idx)
    return out, ok.sum()


def merge_scan(buffers, batch, threshold, discrepancy_name):
    """Merge used by the fused rejection loop.  Only the flat merge is
    ported; the JAX package's threshold-culled variant is a tuning step
    still to be re-derived on this hardware."""
    return merge_core(buffers, batch, threshold, discrepancy_name)


def make_merge_fn(discrepancy_name):
    """Standalone merge for the batch-at-a-time path."""
    return functools.partial(merge_core, discrepancy_name=discrepancy_name)


def merge_parts(parts, n, device):
    """The top-N over several buffers, on ``device``: the device list's
    last merge.  Each buffer's rows carry their global simulation index in
    ``"__pos"`` (-1 on the initial padding), and the result keeps the rows
    and the order of one merge over every batch in turn: ascending key,
    ties to the earlier simulation, the padding before any rejected row.
    A single buffer without ``"__pos"`` is returned as it is."""
    if not parts:
        return None
    if len(parts) == 1 and "__pos" not in parts[0]:
        return {k: v.to(device) for k, v in parts[0].items()}
    cat = {k: torch.cat([p[k].to(device) for p in parts]) for k in parts[0]}
    order = torch.sort(cat.pop("__pos"), stable=True).indices
    by_key = torch.sort(cat["__key"].index_select(0, order), stable=True)
    order = order.index_select(0, by_key.indices[:n])
    return {k: v.index_select(0, order) for k, v in cat.items()}
