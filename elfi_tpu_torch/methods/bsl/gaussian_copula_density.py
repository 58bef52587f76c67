"""Gaussian copula log-density for the semiparametric BSL; the port's own
copy of :mod:`elfi_tpu.methods.bsl.gaussian_copula_density`, numpy and
scipy on the host, kept identical to it."""

from __future__ import annotations

import logging
import math

import numpy as np
from scipy.stats import norm

logger = logging.getLogger(__name__)

__all__ = ["gaussian_copula_density"]


def gaussian_copula_density(rho_hat, u, whitening=None, eta_cov=None):
    """log c(u; rho) = -1/2 (log|rho| + eta' (rho^-1 - I) eta), eta = ppf(u);
    with the whitened variant re-scaling rho by the eta covariance."""
    eta = norm.ppf(np.asarray(u, np.float64))
    if whitening is not None:
        eta = whitening @ eta
        rho_sigma = whitening @ eta_cov @ whitening.T
        d = np.diag(np.sqrt(np.diag(rho_sigma)))
        rho_hat = d @ rho_hat @ d
    if np.any(~np.isfinite(eta)):
        return -math.inf
    _, logdet = np.linalg.slogdet(rho_hat)
    try:
        prec = np.linalg.inv(rho_hat)
    except np.linalg.LinAlgError:
        logger.warning("Unable to invert the estimated correlation matrix")
        return -math.inf
    quad = eta @ prec @ eta - eta @ eta
    return float(-0.5 * (logdet + quad))
