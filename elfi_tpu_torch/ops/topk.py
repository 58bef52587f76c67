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

The fused loop's merge (:func:`merge_scan`) takes the threshold-culled
merge, :func:`merge_core_culled`, for large batches: the same result from
the few rows that beat the buffer's N-th key, through the CUDA kernel
``csrc/topn_cull.cu`` on the card (:mod:`.kernels.topn`).
"""

from __future__ import annotations

import functools
import math

import torch

from ..utils.profiling import annotate
from .kernels import topn as _topn

__all__ = ["sort_key", "accept_mask", "make_merge_fn", "init_buffers",
           "merge_core", "merge_core_culled", "merge_scan", "merge_parts"]


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


def merge_core_culled(buffers, batch, threshold, discrepancy_name,
                      small_k=1024):
    """Threshold-culled top-N merge, bit-identical to :func:`merge_core`.

    The buffer is sorted, so its last key ``kth`` is the current N-th
    best, and a batch key ``>= kth`` can never enter it: buffer rows
    precede batch rows in the flat merge's concatenation, so even an exact
    tie loses.  Only the rows that beat ``kth`` are merged.  ``small_k``
    is a width or an ascending cascade of widths, as in the JAX package;
    batches of at most 4 x the widest take the flat merge.

    On the card one host call launches the kernel
    (:func:`.kernels.topn.topn_cull`), which counts the candidates on the
    device and stays exact for any count, with no width.  On the CPU the
    plain version reads the count and picks the narrowest width that holds
    it, or the flat merge, as the JAX function's ``lax.cond`` cascade does.
    """
    widths = _topn._widths(small_k)
    if batch[discrepancy_name].shape[0] <= 4 * widths[-1]:
        return merge_core(buffers, batch, threshold, discrepancy_name)
    out, _, n_acc = _topn._cull(buffers, batch, threshold, discrepancy_name,
                                widths)
    return out, n_acc


# The three constants below are scripts/torch_merge_ab.py's A/B on an
# NVIDIA H100 80GB HBM3 at 700.00 W: fused MA2 rejection, 2**28
# simulations, 5000 samples; device ms a batch (profiled) and the best of
# three walls, every arm equal to the flat merge with no unroll.  Numbers
# with the cull kernel redesigned for Hopper; the first kernel's chose the
# same values.

#: the fused loop's merge: "culled" (:func:`merge_core_culled` for batches
#: of at least :data:`CULL_MIN_BATCH` rows) or "flat" (:func:`merge_core`).
#: Culled beat flat at every batch: device ms a batch 0.592 -> 0.3715 on
#: the kernel graph at 2**21 (2.37e9 -> 3.83e9 sims/s), 0.556 -> 0.485 on
#: the plain graph at 2**17, 0.968 -> 0.887 at 2**18, 0.345 -> 0.275 at
#: 2**16 (no unroll, width 4096).
MERGE_VARIANT = "culled"
#: the culled merge's width(s) (an int or an ascending tuple): the small
#: batch rule's and the CPU cascade's; the kernel needs none.  1024, 4096,
#: 16384 and the cascade (1024, 4096, 16384) tie in device ms at 2**21
#: (0.3713, 0.3715, 0.3716, 0.3712) and within the walls' spread
#: elsewhere; 4096, the JAX package's value, stays.
CULL_SMALL_K = 4096
#: the smallest merged batch that takes the culled merge: the smallest
#: batch measured, 2**16, already gains (above); smaller batches were not
#: measured (and at most 4 x the widest width merge flat anyway)
CULL_MIN_BATCH = 1 << 16


def merge_scan(buffers, batch, threshold, discrepancy_name, fresh=False):
    """Merge used by the fused rejection loop, honouring
    :data:`MERGE_VARIANT`, :data:`CULL_SMALL_K` and :data:`CULL_MIN_BATCH`
    as the JAX package's ``merge_scan`` does.

    ``fresh=True`` (the caller's own count: the buffer has taken fewer
    rows than it holds) takes the flat merge.  The buffer's N-th key is
    then +inf, so every accepted row of the batch is a candidate: the
    count the JAX cascade sends to its flat merge.  After that the count
    is at most the rows a batch accepts, or about N B / (rows seen), and
    the kernel's chunks hold any count without a host read.
    """
    b = batch[discrepancy_name].shape[0]
    if MERGE_VARIANT == "culled" and b >= CULL_MIN_BATCH and not fresh:
        return merge_core_culled(buffers, batch, threshold, discrepancy_name,
                                 small_k=CULL_SMALL_K)
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
    A single buffer without ``"__pos"`` is returned as it is; otherwise
    the merge, the copies onto ``device`` included, is one span
    ``elfi.merge_parts``."""
    if not parts:
        return None
    if len(parts) == 1 and "__pos" not in parts[0]:
        return {k: v.to(device) for k, v in parts[0].items()}
    with annotate("elfi.merge_parts"):
        cat = {k: torch.cat([p[k].to(device) for p in parts])
               for k in parts[0]}
        order = torch.sort(cat.pop("__pos"), stable=True).indices
        by_key = torch.sort(cat["__key"].index_select(0, order),
                            stable=True)
        order = order.index_select(0, by_key.indices[:n])
        return {k: v.index_select(0, order) for k, v in cat.items()}
