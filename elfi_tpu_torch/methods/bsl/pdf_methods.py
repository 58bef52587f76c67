"""Synthetic-likelihood estimators for BSL (counterpart of
:mod:`elfi_tpu.methods.bsl.pdf_methods`).

Two halves:

- the host estimators, numpy and scipy on a (n_sim_round, d) summary
  matrix, once per MCMC round of the host chain: the JAX package's code,
  copied as it is (glasso imports ``sklearn`` when it is asked for, and is
  a host-only option);
- the device estimators of the fused chain, torch functions on the
  tensors' device: :func:`traceable_likelihood` gives one for exactly the
  likelihoods the JAX package can trace.  They read nothing back to the
  host, so a chain of them queues on the card without waiting for it.
"""

from __future__ import annotations

import logging
import math
from functools import partial

import numpy as np
import scipy.stats as ss
import torch
from scipy.special import loggamma

from .cov_warton import corr_warton, cov_warton
from .gaussian_copula_density import gaussian_copula_density
from .gaussian_rank_corr import gaussian_rank_corr

logger = logging.getLogger(__name__)

__all__ = ["standard_likelihood", "unbiased_likelihood",
           "semiparametric_likelihood", "robust_likelihood",
           "gaussian_syn_likelihood", "gaussian_syn_likelihood_ghurye_olkin",
           "semi_param_kernel_estimate", "syn_likelihood_misspec", "wcon",
           "traceable_likelihood"]


# -- factories ------------------------------------------------------------------

def standard_likelihood(shrinkage=None, penalty=None, whitening=None,
                        standardise=False):
    return partial(gaussian_syn_likelihood, shrinkage=shrinkage,
                   penalty=penalty, whitening=whitening,
                   standardise=standardise)


def unbiased_likelihood():
    return gaussian_syn_likelihood_ghurye_olkin


def semiparametric_likelihood(shrinkage=None, penalty=None, whitening=None):
    return partial(semi_param_kernel_estimate, shrinkage=shrinkage,
                   penalty=penalty, whitening=whitening)


def robust_likelihood(adjustment):
    return partial(syn_likelihood_misspec, adjustment=adjustment)


# -- helpers --------------------------------------------------------------------

def _mvn_logpdf(y, mean, cov):
    """MVN logpdf robust to ill-conditioned covariances (-inf on failure)."""
    try:
        return float(ss.multivariate_normal.logpdf(y, mean=mean, cov=cov))
    except (np.linalg.LinAlgError, ValueError):
        logger.warning("Unable to compute logpdf due to poor sample cov")
        return -math.inf


def _apply_shrinkage(cov, shrinkage, penalty, ssx=None, mean=None,
                     standardise=False):
    if shrinkage is None:
        return cov
    if shrinkage == "warton":
        return cov_warton(cov, 1 - penalty)
    if shrinkage == "glasso":
        from sklearn.covariance import graphical_lasso
        if standardise and ssx is not None:
            std = np.sqrt(np.diag(cov))
            zs = (ssx - mean) / std
            cov = np.atleast_2d(np.cov(zs, rowvar=False))
        return graphical_lasso(cov, alpha=penalty, max_iter=200)[0]
    raise ValueError(f"Unknown shrinkage method {shrinkage!r}")


# -- host estimators ------------------------------------------------------------

def gaussian_syn_likelihood(ssx, ssy, shrinkage=None, penalty=None,
                            whitening=None, standardise=False):
    """Standard Gaussian synthetic likelihood (Price et al. 2018), with
    optional glasso / Warton shrinkage and whitening decorrelation."""
    ssx = np.asarray(ssx, np.float64)
    ssy = np.squeeze(np.asarray(ssy, np.float64))
    if whitening is not None:
        ssy = whitening @ ssy
        ssx = ssx @ whitening.T
    mean = ssx.mean(0)
    cov = np.atleast_2d(np.cov(ssx, rowvar=False))
    cov = _apply_shrinkage(cov, shrinkage, penalty, ssx=ssx, mean=mean,
                           standardise=standardise)
    return np.array([_mvn_logpdf(ssy, mean, cov)])


def wcon(k, nu):
    """log c(k, nu) from Ghurye & Olkin (1969)."""
    args = [0.5 * (nu - x) for x in range(k)]
    return (-k * nu / 2 * math.log(2) - k * (k - 1) / 4 * math.log(math.pi)
            - float(np.sum(loggamma(args))))


def gaussian_syn_likelihood_ghurye_olkin(ssx, ssy):
    """Unbiased synthetic-likelihood estimator (Ghurye & Olkin)."""
    ssx = np.asarray(ssx, np.float64)
    n, d = ssx.shape
    mu = ssx.mean(0).reshape(-1, 1)
    sigma = np.cov(ssx.T)
    y = np.asarray(ssy, np.float64).reshape(-1, 1)
    psi = (n - 1) * sigma - (y - mu) @ (y - mu).T / (1 - 1 / n)
    try:
        sign_s, logdet_sigma = np.linalg.slogdet(np.atleast_2d(sigma))
        sign_p, logdet_psi = np.linalg.slogdet(np.atleast_2d(psi))
        if sign_p <= 0:
            return np.array([-math.inf])
        A = wcon(d, n - 2) - wcon(d, n - 1) - 0.5 * d * math.log(1 - 1 / n)
        # log|(n-1) Sigma| = d log(n-1) + log|Sigma|: the exact Ghurye &
        # Olkin constant, as in the JAX package
        B = -0.5 * (n - d - 2) * (d * math.log(n - 1) + logdet_sigma)
        C = 0.5 * (n - d - 3) * logdet_psi
        loglik = -0.5 * d * math.log(2 * math.pi) + A + B + C
    except np.linalg.LinAlgError:
        loglik = -math.inf
    return np.array([loglik])


def semi_param_kernel_estimate(ssx, ssy, shrinkage=None, penalty=None,
                               whitening=None):
    """Semiparametric synthetic likelihood (An et al. 2020): Gaussian-KDE
    marginals + Gaussian copula with gaussian-rank correlation."""
    ssx = np.asarray(ssx, np.float64)
    ssy = np.squeeze(np.asarray(ssy, np.float64))
    n, ns = ssx.shape

    logpdf_y = np.zeros(ns)
    y_u = np.zeros(ns)
    sim_eta = np.zeros((n, ns))
    eta_cov = None
    for j in range(ns):
        col = ssx[:, j]
        kde = ss.gaussian_kde(col, bw_method="silverman")
        logpdf_y[j] = kde.logpdf(ssy[j]).item()
        y_u[j] = min(1.0, kde.integrate_box_1d(-np.inf, ssy[j]))
        if whitening is not None:
            sim_eta[:, j] = ss.norm.ppf(ss.rankdata(col) / (n + 1))

    rho_hat = gaussian_rank_corr(ssx)
    if whitening is not None:
        eta_cov = np.cov(sim_eta.T)
        rho_hat = gaussian_rank_corr(sim_eta @ whitening.T)

    if shrinkage == "glasso":
        from sklearn.covariance import graphical_lasso
        cov = np.cov(ssx, rowvar=False)
        std = np.sqrt(np.diag(cov))
        cov = np.outer(std, std) * rho_hat
        cov = graphical_lasso(cov, alpha=penalty)[0]
        std = np.sqrt(np.diag(cov))
        rho_hat = np.outer(1 / std, 1 / std) * cov
    elif shrinkage == "warton":
        rho_hat = corr_warton(rho_hat, 1 - penalty)
    elif shrinkage is not None:
        raise ValueError(f"Unknown shrinkage method {shrinkage!r}")

    copula = gaussian_copula_density(rho_hat, y_u, whitening, eta_cov)
    return np.array([copula + np.sum(logpdf_y)])


def syn_likelihood_misspec(ssx, ssy, gamma, adjustment):
    """Robust synthetic likelihood with mean/variance adjustment
    (Frazier & Drovandi 2021)."""
    ssx = np.asarray(ssx, np.float64)
    ssy = np.squeeze(np.asarray(ssy, np.float64))
    mean = ssx.mean(0)
    cov = np.atleast_2d(np.cov(ssx, rowvar=False))
    std = np.sqrt(np.diag(cov))
    if adjustment == "mean":
        mean = mean + std * gamma
    elif adjustment == "variance":
        cov = cov + np.diag((std * gamma) ** 2)
    else:
        raise ValueError("adjustment must be 'mean' or 'variance'")
    return _mvn_logpdf(ssy, mean, cov)


# -- device estimators for the fused BSL chain -----------------------------------

def _t_cov(x):
    """(n, d) rows -> (d, d) covariance with ddof 1, always 2-D, as
    ``jnp.atleast_2d(jnp.cov(x, rowvar=False))``.  Written out because
    ``torch.cov`` reads its degrees of freedom back to the host to check
    them, which would make the fused chain wait for the card."""
    xc = x - torch.mean(x, dim=0)
    return xc.T @ xc / (x.shape[0] - 1)


def _t_mvn_logpdf(y, mean, cov):
    """MVN log-density; -inf wherever it is not finite.  ``cholesky_ex``
    leaves a failed factor's check on the device (``info`` > 0 where the
    covariance is not positive definite, the JAX package's NaN factor)."""
    d = y.shape[0]
    L, info = torch.linalg.cholesky_ex(cov)
    sol = torch.linalg.solve_triangular(L, (y - mean)[:, None], upper=False)
    val = -0.5 * (d * math.log(2 * math.pi)
                  + 2 * torch.sum(torch.log(torch.diagonal(L)))
                  + torch.sum(sol * sol))
    return torch.where(torch.isfinite(val) & (info == 0), val, -math.inf)


def _t_cov_warton(S, gamma):
    d = torch.sqrt(torch.diagonal(S) + 1e-5)
    dd = torch.outer(d, d)
    eye = torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    return (gamma * (S / dd) + (1 - gamma) * eye) * dd


def _t_ghurye_olkin(ssx, ssy):
    n, d = ssx.shape
    mu = torch.mean(ssx, dim=0)
    sigma = _t_cov(ssx)
    diff = (ssy - mu)[:, None]
    psi = (n - 1) * sigma - diff @ diff.T / (1 - 1 / n)
    _, logdet_sigma = torch.linalg.slogdet(sigma)
    sign_p, logdet_psi = torch.linalg.slogdet(psi)
    A = wcon(d, n - 2) - wcon(d, n - 1) - 0.5 * d * math.log(1 - 1 / n)
    B = -0.5 * (n - d - 2) * (d * math.log(n - 1) + logdet_sigma)
    C = 0.5 * (n - d - 3) * logdet_psi
    val = -0.5 * d * math.log(2 * math.pi) + A + B + C
    return torch.where((sign_p > 0) & torch.isfinite(val), val, -math.inf)


def traceable_likelihood(likelihood, *, device):
    """Torch ``(ssx (n, d), ssy (d,)) -> 0-d loglik`` form of a host
    estimator, for the fused BSL chain on ``device`` (where a whitening
    matrix is put once), or ``None`` where the JAX package has no traceable
    form either: glasso shrinkage, ``standardise``, the semiparametric KDE
    and the misspecification adjustments stay on the host chain."""
    if likelihood is None or likelihood is gaussian_syn_likelihood:
        kw = {}
    elif likelihood is gaussian_syn_likelihood_ghurye_olkin:
        return _t_ghurye_olkin
    elif isinstance(likelihood, partial) \
            and likelihood.func is gaussian_syn_likelihood:
        kw = dict(likelihood.keywords)
    else:
        return None
    shrinkage = kw.get("shrinkage")
    penalty = kw.get("penalty")
    whitening = kw.get("whitening")
    if shrinkage not in (None, "warton") or kw.get("standardise", False):
        return None
    W = None if whitening is None else torch.as_tensor(
        np.asarray(whitening), dtype=torch.float32, device=device)

    def fn_t(ssx, ssy):
        if W is not None:
            ssy = W @ ssy
            ssx = ssx @ W.T
        mean = torch.mean(ssx, dim=0)
        cov = _t_cov(ssx)
        if shrinkage == "warton":
            cov = _t_cov_warton(cov, 1 - penalty)
        return _t_mvn_logpdf(ssy, mean, cov)

    return fn_t
