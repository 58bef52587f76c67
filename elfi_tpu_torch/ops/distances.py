"""Vectorised distances between batched summary vectors and the observed
summary vector (counterpart of :mod:`elfi_tpu.ops.distances`).  Only the
euclidean metric is ported so far."""

from __future__ import annotations

import torch

__all__ = ["stack_summaries", "distance_op", "DistanceOp", "METRICS"]


def stack_summaries(summaries):
    """Column-stack summaries into a (batch, d) matrix, flattening event
    dims."""
    cols = []
    for s in summaries:
        s = torch.as_tensor(s)
        if s.ndim == 0:
            s = s[None, None]
        elif s.ndim == 1:
            s = s[:, None]
        else:
            s = s.reshape(s.shape[0], -1)
        cols.append(s)
    return torch.cat(cols, dim=1)


def _euclidean(u, v, w=None):
    d = u - v
    if w is not None:
        d = d * torch.sqrt(w)
    return torch.sqrt(torch.sum(d * d, dim=-1))


METRICS = {"euclidean": _euclidean}


class DistanceOp:
    """Picklable discrepancy op ``op(*summaries, observed) -> (batch,)``;
    ``w`` is a non-negative weight vector (``scipy.spatial.distance.cdist``
    semantics)."""

    def __init__(self, metric, w=None):
        if metric not in METRICS:
            raise ValueError(f"Unknown metric {metric!r}. Available: "
                             f"{sorted(METRICS)}")
        self.metric = metric
        self.w = None if w is None else torch.as_tensor(w, dtype=torch.float32)

    def __call__(self, *summaries, observed):
        u = stack_summaries(summaries)
        v = stack_summaries(observed)
        w = None if self.w is None else self.w.to(u.device)
        return METRICS[self.metric](u, v, w)


def distance_op(metric, w=None):
    """Build a discrepancy op ``fn(*summaries, observed) -> (batch,)``."""
    return DistanceOp(metric, w=w)
