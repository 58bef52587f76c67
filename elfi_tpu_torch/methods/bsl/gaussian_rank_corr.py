"""Gaussian rank correlation estimator; the port's own copy of
:mod:`elfi_tpu.methods.bsl.gaussian_rank_corr`, numpy and scipy on the
host, kept identical to it."""

from __future__ import annotations

import numpy as np
import scipy.stats as ss

__all__ = ["gaussian_rank_corr", "p2P"]


def p2P(param, n_rows):
    """Upper-triangular vector -> symmetric correlation matrix with unit
    diagonal."""
    P = np.zeros((n_rows, n_rows))
    P[np.triu_indices(n_rows, 1)] = param
    P = P + P.T
    np.fill_diagonal(P, 1.0)
    return P


def gaussian_rank_corr(x):
    """Correlation of normal scores of ranks — robust to monotone marginal
    transformations."""
    x = np.asarray(x)
    n, p = x.shape[:2]
    scores = ss.norm.ppf(ss.rankdata(x, axis=0) / (n + 1))
    density = np.sum(ss.norm.ppf(np.arange(1, n + 1) / (n + 1)) ** 2)
    upper = []
    for i in range(p - 1):
        upper.append(scores[:, i] @ scores[:, i + 1:])
    return p2P(np.concatenate(upper) / density, p)
