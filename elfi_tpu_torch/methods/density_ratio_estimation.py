"""KLIEP density ratio estimation (counterpart of
:mod:`elfi_tpu.methods.density_ratio_estimation`).

The RBF matrices and the projected-gradient KLIEP iterations run on the
estimator's ``device`` in float32, as the JAX package computes them (its
default dtype is float32 and its matmuls run at full precision; PyTorch's
float32 matmuls on CUDA do not use TF32 unless a caller enables it).  The
loop checks convergence every ``conv_check_interval`` iterations, and each
check is one read back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.backends import resolve_device

__all__ = ["DensityRatioEstimation", "calculate_densratio_basis_sigma"]


def calculate_densratio_basis_sigma(sigma_1, sigma_2):
    """Heuristic basis scale (reference ``density_ratio_estimation.py:11-28``)."""
    return sigma_1 * sigma_2 / np.sqrt(np.abs(sigma_1 ** 2 - sigma_2 ** 2))


def _rbf_matrix(x, centers, sigma):
    """K[i, j] = exp(-||x_i - c_j||^2 / (2 sigma^2))."""
    d2 = torch.sum((x[:, None, :] - centers[None, :, :]) ** 2, dim=-1)
    return torch.exp(-0.5 * d2 / (sigma * sigma))


def _kliep_solve(A, b, b_normalized, weights_x, A_self, epsilon, abs_tol,
                 max_iter, conv_check_interval):
    """Projected gradient ascent for the KLIEP weights (reference
    ``density_ratio_estimation.py:183-202``).  The JAX package's
    thresholds 1e-64 and 1e-300 are 0 in float32, so they are 0 here."""
    n = A.shape[1]
    alpha = torch.full((n,), 1.0 / n, device=A.device)
    prev = A_self @ alpha
    nonnull = torch.any(A > 0, dim=1)
    w_eff = torch.where(nonnull, weights_x, 0.0)
    for i in range(max_iter):
        denom = torch.clamp_min(A @ alpha, 0.0)
        grad = A.T @ torch.where(nonnull, w_eff / denom, 0.0)
        alpha = alpha + epsilon * grad
        alpha = torch.clamp_min(alpha + (1.0 - b @ alpha) * b_normalized,
                                0.0)
        alpha = alpha / (b @ alpha)
        if i % conv_check_interval == 0:
            cur = A_self @ alpha
            if float(torch.linalg.norm(cur - prev)) < abs_tol:
                break
            prev = cur
    return alpha


class DensityRatioEstimation:
    """RBF-basis density ratio estimator w(x) ~ p_x(x)/p_y(x), fitted on
    ``device`` (None: the global backend's).  An ``AdaptiveThresholdSMC``
    makes its default estimator on its own device and refuses one given on
    another."""

    def __init__(self, n=100, epsilon=0.1, max_iter=500, abs_tol=0.01,
                 conv_check_interval=20, fold=5, optimize=False,
                 device=None):
        self.n = n
        self.epsilon = epsilon
        self.max_iter = max_iter
        self.abs_tol = abs_tol
        self.conv_check_interval = conv_check_interval
        self.fold = fold
        self.sigma = None
        self.optimize = optimize
        self.device = resolve_device(device)

    def _t(self, a):
        """float64 numpy -> float32 tensor on the device (``jnp.asarray``
        of the JAX package)."""
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=self.device)

    def fit(self, x, y, weights_x=None, weights_y=None, sigma=None):
        x = np.asarray(x, np.float64).reshape(len(x), -1)
        y = np.asarray(y, np.float64).reshape(len(y), -1)
        self.x = x
        if len(x) < self.n:
            raise ValueError(
                f"Number of RBFs ({self.n}) can't be larger than number of "
                f"samples ({len(x)})")
        self.theta = x[:self.n]
        weights_x = np.ones(len(x)) if weights_x is None \
            else np.asarray(weights_x, np.float64)
        weights_y = np.ones(len(y)) if weights_y is None \
            else np.asarray(weights_y, np.float64)
        self.weights_x = weights_x / weights_x.sum()
        self.weights_y = weights_y / weights_y.sum()

        if isinstance(sigma, float):
            self.sigma = sigma
            self.optimize = False
        if self.optimize:
            if not isinstance(sigma, list):
                raise ValueError("To optimize RBF scale provide a list of "
                                 "candidate scales")
            scores = [self._lcv_score(x, y, s) for s in sigma]
            self.sigma = sigma[int(np.argmax(scores))]
        if self.sigma is None:
            raise ValueError("RBF width (sigma) must be provided on the "
                             "first call")
        self._alpha = self._solve(x, y, self.weights_x, self.sigma)

    def _solve(self, x, y, weights_x, sigma):
        centers = self._t(self.theta)
        A = _rbf_matrix(self._t(x), centers, sigma)
        B = _rbf_matrix(self._t(y), centers, sigma)
        # the JAX package forms b on the host in float64
        b = (torch.as_tensor(self.weights_y, device=self.device)
             @ B.double()).float()
        b_normalized = b / (b @ b)
        A_self = _rbf_matrix(self._t(self.x), centers, sigma)
        return _kliep_solve(A, b, b_normalized, self._t(weights_x), A_self,
                            self.epsilon, self.abs_tol, self.max_iter,
                            self.conv_check_interval)

    def _lcv_score(self, x, y, sigma):
        """Likelihood cross-validation score over folds (reference
        ``density_ratio_estimation.py:157-181``)."""
        idx = np.arange(len(x))
        folds = np.array_split(idx, self.fold)
        scores = []
        for f in folds:
            keep = np.setdiff1d(idx, f)
            alpha = self._solve(x[keep], y, self.weights_x[keep], sigma)
            vals = (_rbf_matrix(self._t(x[f]), self._t(self.theta), sigma)
                    @ alpha).cpu().numpy()
            vals = np.maximum(vals, 1e-300)
            scores.append(np.average(np.log(vals), weights=self.weights_x[f]))
        return float(np.mean(scores))

    def w(self, x):
        """Estimated density ratio at x, as numpy float32."""
        x = np.asarray(x, np.float64).reshape(len(np.atleast_2d(x)), -1)
        return (_rbf_matrix(self._t(x), self._t(self.theta), self.sigma)
                @ self._alpha).cpu().numpy()

    def max_ratio(self):
        return float(np.max(self.w(self.x)))
