"""Warton ridge shrinkage for covariance/correlation matrices (Warton
2008); the port's own copy of :mod:`elfi_tpu.methods.bsl.cov_warton`,
numpy on the host, kept identical to it."""

from __future__ import annotations

import numpy as np

__all__ = ["cov_warton", "corr_warton"]


def corr_warton(R, gamma):
    """Shrink a correlation matrix towards the identity."""
    ns = R.shape[0]
    return gamma * R + (1 - gamma) * np.eye(ns)


def cov_warton(S, gamma):
    """Ridge estimator: shrink the correlation part of S towards identity,
    keeping the variances."""
    if gamma < 0 or gamma > 1:
        raise ValueError("Gamma must be between 0 and 1")
    eps = 1e-5
    d = np.sqrt(np.diag(S) + eps)
    R = S / np.outer(d, d)
    return corr_warton(R, gamma) * np.outer(d, d)
