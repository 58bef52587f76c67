"""Vectorised distances between batched summary vectors and the observed
summary vector (counterpart of :mod:`elfi_tpu.ops.distances`).

Weighted-metric semantics follow ``scipy.spatial.distance`` as the JAX
package's do (the tests hold both against ``cdist``); scipy's weighted
chebyshev treats ``w`` as a mask (``w > 0`` keeps the coordinate), not a
scale.  Weights, variances and inverse covariances are float32, as in the
JAX package.
"""

from __future__ import annotations

import torch

__all__ = ["stack_summaries", "distance_op", "DistanceOp",
           "CallableDistanceOp", "AdaptiveDistanceOp",
           "adaptive_distance_op", "METRICS"]


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


def _sqeuclidean(u, v, w=None):
    d = u - v
    if w is not None:
        d = d * torch.sqrt(w)
    return torch.sum(d * d, dim=-1)


def _cityblock(u, v, w=None):
    d = torch.abs(u - v)
    if w is not None:
        d = d * w
    return torch.sum(d, dim=-1)


def _chebyshev(u, v, w=None):
    d = torch.abs(u - v)
    if w is not None:
        # scipy semantics: w is a coordinate mask (w > 0 keeps), not a scale
        d = torch.where(w > 0, d, -torch.inf)
    return torch.amax(d, dim=-1)


def _canberra(u, v, w=None):
    num = torch.abs(u - v)
    den = torch.abs(u) + torch.abs(v)
    t = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    if w is not None:
        t = t * w
    return torch.sum(t, dim=-1)


def _braycurtis(u, v, w=None):
    dn = torch.abs(u - v)
    dd = torch.abs(u + v)
    if w is not None:
        dn = dn * w
        dd = dd * w
    num = torch.sum(dn, dim=-1)
    den = torch.sum(dd, dim=-1)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def _cosine(u, v, w=None):
    if w is None:
        w = 1.0
    un = torch.sqrt(torch.sum(w * u * u, dim=-1))
    vn = torch.sqrt(torch.sum(w * v * v, dim=-1))
    return 1.0 - torch.sum(w * u * v, dim=-1) / (un * vn)


def _correlation(u, v, w=None):
    if w is None:
        umean = torch.mean(u, dim=-1, keepdim=True)
        vmean = torch.mean(v, dim=-1, keepdim=True)
    else:
        wsum = torch.sum(w)
        umean = torch.sum(w * u, dim=-1, keepdim=True) / wsum
        vmean = torch.sum(w * v, dim=-1, keepdim=True) / wsum
    return _cosine(u - umean, v - vmean, w)


def _hamming(u, v, w=None):
    ne = (u != v).to(u.dtype if u.is_floating_point() else torch.float32)
    if w is None:
        return torch.mean(ne, dim=-1)
    return torch.sum(w * ne, dim=-1) / torch.sum(w)


def _jensenshannon(u, v, w=None):
    # scipy normalises each row to a probability vector and uses natural log
    p = u / torch.sum(u, dim=-1, keepdim=True)
    q = v / torch.sum(v, dim=-1, keepdim=True)
    m = 0.5 * (p + q)

    def _kl_term(a, b):
        ratio = torch.where(a > 0, a / torch.where(a > 0, b, 1.0), 1.0)
        return torch.where(a > 0, a * torch.log(ratio), 0.0)

    js = 0.5 * torch.sum(_kl_term(p, m) + _kl_term(q, m), dim=-1)
    return torch.sqrt(torch.clamp(js, min=0.0))


def _minkowski(u, v, w, p):
    d = torch.abs(u - v)
    if w is not None:
        d = d * w ** (1.0 / p)
    return torch.sum(d ** p, dim=-1) ** (1.0 / p)


def _seuclidean(u, v, V):
    d = u - v
    return torch.sqrt(torch.sum(d * d / V, dim=-1))


def _mahalanobis(u, v, VI):
    d = u - v
    return torch.sqrt(torch.einsum("...i,ij,...j->...", d, VI, d))


METRICS = {
    "euclidean": _euclidean,
    "sqeuclidean": _sqeuclidean,
    "cityblock": _cityblock,
    "manhattan": _cityblock,
    "chebyshev": _chebyshev,
    "canberra": _canberra,
    "braycurtis": _braycurtis,
    "cosine": _cosine,
    "correlation": _correlation,
    "hamming": _hamming,
    "jensenshannon": _jensenshannon,
}

# Metrics whose scipy implementation accepts a weight vector ``w``.
_WEIGHTED = frozenset({
    "euclidean", "sqeuclidean", "cityblock", "manhattan", "chebyshev",
    "canberra", "braycurtis", "cosine", "correlation", "hamming",
    "minkowski", "wminkowski",
})


def _float32(x):
    return None if x is None else torch.as_tensor(x, dtype=torch.float32)


class DistanceOp:
    """Discrepancy op ``op(*summaries, observed) -> (batch,)``.

    ``p``/``w``/``V``/``VI`` follow ``scipy.spatial.distance.cdist``:
    ``p`` for minkowski, ``w`` a non-negative weight vector, ``V`` the
    variance vector for seuclidean, ``VI`` the inverse covariance for
    mahalanobis.
    """

    #: its programs may be captured as CUDA graphs
    #: (:meth:`~elfi_tpu_torch.compile.compiler.CompiledProgram.jitted`):
    #: tensor arithmetic only, with its parameters on the device once
    capturable = True

    def __init__(self, metric, p=None, w=None, V=None, VI=None):
        if metric in ("minkowski", "wminkowski"):
            if p is None:
                raise ValueError("minkowski distance requires p")
        elif metric == "seuclidean":
            if V is None:
                raise ValueError("seuclidean distance requires V "
                                 "(variance vector)")
        elif metric == "mahalanobis":
            if VI is None:
                raise ValueError("mahalanobis distance requires VI "
                                 "(inverse covariance matrix)")
        elif metric not in METRICS:
            raise ValueError(
                f"Unknown metric {metric!r}. Available: "
                f"{sorted(METRICS) + ['minkowski', 'seuclidean', 'mahalanobis']}")
        if w is not None and metric not in _WEIGHTED:
            raise ValueError(
                f"metric {metric!r} does not support a weight vector w "
                "(scipy cdist semantics)")
        self.metric = metric
        self.p = p
        self.w, self.V, self.VI = _float32(w), _float32(V), _float32(VI)
        self._on = {}

    def __getstate__(self):
        # the per-device copies are made again on first use after loading
        return {**self.__dict__, "_on": {}}

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.__dict__.setdefault("_on", {})

    def _param(self, name, device):
        """``w``, ``V`` or ``VI`` on ``device``, copied there once (a copy
        from the host in every call would wait for the device, and could
        not be captured in a CUDA graph)."""
        key = (name, device)
        if key not in self._on:
            p = getattr(self, name)
            self._on[key] = None if p is None else p.to(device)
        return self._on[key]

    def __call__(self, *summaries, observed):
        u = stack_summaries(summaries)
        v = stack_summaries(observed)
        w = self._param("w", u.device)
        if self.metric in ("minkowski", "wminkowski"):
            return _minkowski(u, v, w, float(self.p))
        if self.metric == "seuclidean":
            return _seuclidean(u, v, self._param("V", u.device))
        if self.metric == "mahalanobis":
            return _mahalanobis(u, v, self._param("VI", u.device))
        return METRICS[self.metric](u, v, w)


def distance_op(metric, p=None, w=None, V=None, VI=None):
    """Build a discrepancy op ``fn(*summaries, observed) -> (batch,)``."""
    return DistanceOp(metric, p=p, w=w, V=V, VI=VI)


class CallableDistanceOp:
    """Wrap a user metric ``metric(u, v) -> (batch,)`` as a discrepancy op."""

    def __init__(self, metric):
        self.metric = metric

    def __call__(self, *summaries, observed):
        u = stack_summaries(summaries)
        v = stack_summaries(observed)
        return self.metric(u, v)


class AdaptiveDistanceOp:
    """Discrepancy op of :class:`~elfi_tpu_torch.model.model.AdaptiveDistance`:
    one weighted-euclidean column per accumulated weight vector in
    ``holder['w']`` (``None`` = unweighted), reference
    ``elfi_model.py:1135-1151``.

    ``holder['w']`` is a host-side list of float64 arrays; each call uses
    them as float32 tensors on the summaries' device, copied from the
    host, so it is not marked ``capturable`` and its programs are not
    captured as CUDA graphs."""

    def __init__(self, holder):
        self.holder = holder

    def __call__(self, *summaries, observed):
        u = stack_summaries(summaries)
        v = stack_summaries(observed)
        cols = []
        for w in self.holder.get("w", [None]):
            if w is None:
                cols.append(_euclidean(u, v))
            else:
                w = torch.as_tensor(w, dtype=torch.float32, device=u.device)
                cols.append(_euclidean(u * w, v * w))
        return torch.stack(cols, dim=1)


def adaptive_distance_op(state_holder):
    return AdaptiveDistanceOp(state_holder)
