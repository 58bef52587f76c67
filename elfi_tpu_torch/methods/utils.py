"""Host-side bookkeeping helpers of the method layer (counterpart of
:mod:`elfi_tpu.methods.utils`); numpy in, numpy out, as in the JAX
package."""

from __future__ import annotations

import numpy as np

__all__ = [
    "arr2d_to_batch", "batch_to_arr2d", "ceil_to_batch_size",
    "normalize_weights", "compute_ess", "weighted_var",
    "weighted_sample_quantile",
]


def arr2d_to_batch(x, names):
    """(n, d) array -> batch dict keyed by sorted parameter names."""
    x = np.atleast_2d(x)
    if x.shape[1] != len(names):
        raise ValueError(f"Array width {x.shape[1]} != len(names) {len(names)}")
    return {name: x[:, i] for i, name in enumerate(names)}


def batch_to_arr2d(batch, names):
    """Batch dict -> (n, d) array, columns in ``names`` order."""
    if not names:
        return np.empty((0, 0))
    cols = []
    for n in names:
        c = np.asarray(batch[n])
        cols.append(c.reshape(c.shape[0], -1) if c.ndim > 1 else c[:, None])
    return np.concatenate(cols, axis=1)


def ceil_to_batch_size(n, batch_size):
    return int(batch_size * np.ceil(n / batch_size))


def normalize_weights(weights):
    w = np.atleast_1d(np.asarray(weights, np.float64))
    s = w.sum()
    if s == 0:
        raise ValueError("All weights are zero")
    return w / s


def compute_ess(weights):
    """Kish effective sample size."""
    w = normalize_weights(weights)
    return 1.0 / np.sum(w ** 2)


def weighted_var(x, weights=None):
    """Unbiased weighted variance per dimension."""
    x = np.atleast_2d(np.asarray(x, np.float64).reshape(len(x), -1))
    if weights is None:
        return np.var(x, axis=0, ddof=1)
    w = normalize_weights(weights)
    mean = np.sum(w[:, None] * x, axis=0)
    return np.sum(w[:, None] * (x - mean) ** 2, axis=0) / (1 - np.sum(w ** 2))


def weighted_sample_quantile(x, alpha, weights=None):
    """alpha-quantile of a weighted sample: smallest x whose cumulative
    normalized weight reaches alpha."""
    x = np.asarray(x, np.float64).ravel()
    order = np.argsort(x)
    xs = x[order]
    if weights is None:
        w = np.full(len(x), 1.0 / len(x))
    else:
        w = normalize_weights(np.asarray(weights).ravel()[order])
    cum = np.cumsum(w)
    idx = int(np.searchsorted(cum, alpha, side="left"))
    return float(xs[min(idx, len(xs) - 1)])
