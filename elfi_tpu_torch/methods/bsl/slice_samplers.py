"""Univariate slice samplers (stepping-out + shrinkage) for the
misspecification parameters gamma of robust BSL (Frazier & Drovandi 2021);
the port's own copy of :mod:`elfi_tpu.methods.bsl.slice_samplers`, numpy
and scipy on the host, kept identical to it so that a host chain consumes
its ``RandomState`` in the same order.

Both samplers share one sweep routine; they differ only in how gamma enters
the synthetic likelihood (mean shift vs variance inflation) and in the
prior (Laplace vs exponential)."""

from __future__ import annotations

import math

import numpy as np
import scipy.stats as ss

__all__ = ["slice_gamma_mean", "slice_gamma_variance"]


def _mvn_logpdf(y, mean, cov):
    try:
        return float(ss.multivariate_normal.logpdf(y, mean=mean, cov=cov))
    except (np.linalg.LinAlgError, ValueError):
        return -math.inf


def _laplace_logprior(gamma, tau):
    rate = 1.0 / tau
    return len(gamma) * math.log(rate / 2) - rate * float(np.sum(np.abs(gamma)))


def _expon_logprior(gamma, tau):
    if np.any(gamma < 0):
        return -math.inf
    return float(np.sum(-gamma / tau - math.log(tau)))


def _slice_sweep(ssy, loglik, gamma, loglik_at, logprior, lower_bounded,
                 w, max_iter, random_state):
    """One coordinate-wise slice-sampling sweep over the gamma vector."""
    random_state = random_state or np.random
    gamma_curr = np.asarray(gamma, np.float64).copy()
    ll_curr = loglik
    for ii in range(len(gamma_curr)):
        g0 = gamma_curr[ii]
        log_height = (ll_curr + logprior(gamma_curr)
                      - random_state.exponential(1))

        lower = 0.0 if lower_bounded else g0 - w
        upper = g0 + w

        def target_at(value):
            g = gamma_curr.copy()
            g[ii] = value
            return loglik_at(g) + logprior(g), g

        if not lower_bounded:
            for _ in range(max_iter + 1):
                t, _ = target_at(lower)
                if t < log_height:
                    break
                lower -= w
        for _ in range(max_iter + 1):
            t, _ = target_at(upper)
            if t < log_height:
                break
            upper += w

        for _ in range(max_iter):
            prop = random_state.uniform(lower, upper)
            t, g = target_at(prop)
            if t > log_height:
                gamma_curr = g
                ll_curr = loglik_at(g)
                break
            if prop < g0:
                lower = prop
            else:
                upper = prop
    return gamma_curr, ll_curr


def slice_gamma_mean(ssy, loglik, gamma, sample_mean, sample_cov, tau=0.5,
                     w=1.0, max_iter=1000, random_state=None):
    """Slice-sample mean-adjustment gammas under a Laplace(tau) prior."""
    ssy = np.squeeze(np.asarray(ssy, np.float64))
    std = np.sqrt(np.diag(sample_cov))

    def loglik_at(g):
        return _mvn_logpdf(ssy, sample_mean + std * g, sample_cov)

    return _slice_sweep(ssy, loglik, gamma, loglik_at,
                        lambda g: _laplace_logprior(g, tau),
                        lower_bounded=False, w=w, max_iter=max_iter,
                        random_state=random_state)


def slice_gamma_variance(ssy, loglik, gamma, sample_mean, sample_cov,
                         tau=0.5, w=1.0, max_iter=1000, random_state=None):
    """Slice-sample variance-adjustment gammas under an Exp(1/tau) prior."""
    ssy = np.squeeze(np.asarray(ssy, np.float64))
    std = np.sqrt(np.diag(sample_cov))

    def loglik_at(g):
        return _mvn_logpdf(ssy, sample_mean,
                           sample_cov + np.diag((std * g) ** 2))

    return _slice_sweep(ssy, loglik, gamma, loglik_at,
                        lambda g: _expon_logprior(g, tau),
                        lower_bounded=True, w=w, max_iter=max_iter,
                        random_state=random_state)
