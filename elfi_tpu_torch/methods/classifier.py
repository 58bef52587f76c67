"""Ratio-estimation classifiers for BOLFIRE (counterpart of
:mod:`elfi_tpu.methods.classifier`; reference
``elfi/methods/classifier.py``).

``LogisticRegression`` needs no scikit-learn: it fits the L2-penalised
primal of the JAX package's device logistic regression
(:func:`logreg_fit_core`) on standardised features, on the host path as on
the fused path, so both paths of BOLFIRE fit one problem.  The JAX
package's host path calls sklearn with ``{"solver": "liblinear",
"l1_ratio": 1.0}``, which recent sklearn reads as an L1 penalty; in
BOLFIRE's regime of overlapping classes the two give log-ratios within
0.05 of each other.

``GPClassifier`` is the JAX package's Laplace-approximation GP binary
classifier (logistic link, Newton mode finding, probit-approximated
predictive probabilities), in float32 on the device with the kernel matrix
built in float64 on the host, as the JAX package builds it."""

from __future__ import annotations

import abc
import math

import numpy as np
import torch

from ..parallel.backends import resolve_device
from .bo.gp import _cholesky, full_float32_matmul

__all__ = ["Classifier", "LogisticRegression", "GPClassifier",
           "logreg_fit_core"]

#: the one configuration the port's ``LogisticRegression`` accepts: the JAX
#: package's default sklearn configuration
DEFAULT_CONFIG = {"solver": "liblinear", "l1_ratio": 1.0}
#: Newton steps of :func:`logreg_fit_core` (the JAX fused fit's count)
LOGREG_NEWTON = 25


class Classifier(abc.ABC):
    """Ratio-estimation classifier interface."""

    @abc.abstractmethod
    def __init__(self):
        raise NotImplementedError

    @abc.abstractmethod
    def fit(self, X, y):
        raise NotImplementedError

    @abc.abstractmethod
    def predict_log_likelihood_ratio(self, X):
        raise NotImplementedError

    def predict_likelihood_ratio(self, X):
        return np.exp(self.predict_log_likelihood_ratio(X))

    @property
    @abc.abstractmethod
    def attributes(self):
        raise NotImplementedError


def _loss_change(v, step, m, yzs, ts, C):
    """The change of ``0.5 v'v + C sum softplus(-m)`` from ``v`` to ``v -
    t step`` (margins ``m - t yzs``) at every trial ``t``: (..., T).

    Summed from each row's own change, which is exact to the rounding of
    that change rather than of the loss: near the optimum a Newton step
    lowers a loss of thousands by 1e-6 or less, below the float32
    resolution of the loss itself, and comparing two rounded totals would
    stop the iteration wherever the rounding falls.  A row whose margin
    moves by less than 1 takes ``log1p(expm1(d) sigmoid(-m))``, which does
    not cancel; one that moves further takes the plain difference."""
    t = ts[:, None]
    quad = (-ts * torch.sum(v * step, dim=-1)[..., None]
            + 0.5 * ts * ts * torch.sum(step * step, dim=-1)[..., None])
    a = -m[..., None, :]
    d = t * yzs[..., None, :]
    softplus = torch.nn.functional.softplus
    rows = torch.where(d.abs() < 1,
                       torch.log1p(torch.expm1(d) * torch.sigmoid(a)),
                       softplus(a + d) - softplus(a))
    return quad + C * torch.sum(rows, dim=-1)


def logreg_fit_core(X, y, n_newton=LOGREG_NEWTON, C=1.0):
    """L2-penalised logistic regression on standardised features, on the
    device of ``X`` (..., n, f) with labels ``y`` (..., n) in {-1, +1}; the
    leading dimensions are independent problems solved as one batch.

    Solves ``min 0.5 v'v + C sum log(1 + exp(-y_i v.x_i))`` over the
    (f+1)-vector ``v`` of coefficients and intercept (the intercept
    regularised, as liblinear appends it as a unit feature) by damped
    Newton: ``H >= I``, so every Newton direction descends, and the step is
    the first of 1, 1/2, ..., 2^-19 that lowers the loss (none: no step).
    The full step diverges on badly scaled features, such as g-and-k's
    squared octiles, which span eleven orders of magnitude.

    Returns ``(w, b, mu, sd)``: the coefficients and intercept in
    standardised space and the features' means and population standard
    deviations (constant columns get 1, as sklearn's scaler gives them), so
    the log-ratio at a point x is ``((x - mu) / sd) @ w + b``.  Queues its
    work and reads nothing back: the factor is ``cholesky_ex``'s."""
    with full_float32_matmul():
        X = X.to(torch.float32)
        y = y.to(torch.float32)
        mu = torch.mean(X, dim=-2)
        sd = torch.sqrt(torch.var(X, dim=-2, correction=0))
        sd = torch.where(sd > 0, sd, 1.0)
        Xs = (X - mu[..., None, :]) / sd[..., None, :]
        f = X.shape[-1]
        Xt = torch.cat([Xs, torch.ones(Xs.shape[:-1] + (1,), device=X.device)],
                       dim=-1)
        XtT = Xt.mT
        eye = torch.eye(f + 1, device=X.device)
        ts = 0.5 ** torch.arange(20, dtype=torch.float32, device=X.device)
        v = torch.zeros(X.shape[:-2] + (f + 1,), device=X.device)
        for _ in range(n_newton):
            z0 = (Xt @ v[..., None])[..., 0]
            m = y * z0
            g = v + C * (XtT @ (-y * torch.sigmoid(-m))[..., None])[..., 0]
            W = torch.sigmoid(m) * torch.sigmoid(-m)
            H = eye + C * (XtT @ (W[..., None] * Xt))
            L, _ = torch.linalg.cholesky_ex(H)
            step = torch.cholesky_solve(g[..., None], L)[..., 0]
            zs = (Xt @ step[..., None])[..., 0]
            ok = _loss_change(v, step, m, y * zs, ts, C) < 0
            # the first step that lowers the loss; a gather, since indexing
            # with a 0-d tensor would read it on the host
            first = torch.argmax(ok.to(torch.uint8), dim=-1)
            t = torch.where(torch.any(ok, dim=-1),
                            ts.index_select(0, first.reshape(-1)).reshape(
                                first.shape), 0.0)
            v = v - t[..., None] * step
    return v[..., :f], v[..., f], mu, sd


class LogisticRegression(Classifier):
    """Logistic regression on standardised features, fitted by
    :func:`logreg_fit_core` on ``device`` (None: the global backend's,
    resolved at each fit).

    Only the JAX package's default configuration is accepted; sklearn's
    other solvers and penalties are not ported."""

    def __init__(self, config=None, class_min=0, device=None):
        if config is not None and config != DEFAULT_CONFIG:
            raise ValueError(
                f"LogisticRegression takes only the default configuration "
                f"{DEFAULT_CONFIG} (the L2 primal of logreg_fit_core); "
                f"{config} is an sklearn configuration, and the port has no "
                "sklearn")
        if not isinstance(class_min, (int, float)):
            raise TypeError("class_min has to be a non-negative number")
        self.config = dict(DEFAULT_CONFIG)
        self.class_min = class_min
        self.device = device
        self._fit = None

    def fit(self, X, y):
        device = resolve_device(self.device)
        w, b, mu, sd = logreg_fit_core(
            torch.as_tensor(np.asarray(X), dtype=torch.float32,
                            device=device),
            torch.as_tensor(np.asarray(y), dtype=torch.float32,
                            device=device))
        packed = torch.cat([w, b.reshape(1), mu, sd]).cpu().numpy()
        f = w.shape[0]
        self._fit = (packed[:f], float(packed[f]), packed[f + 1:2 * f + 1],
                     packed[2 * f + 1:])

    def predict_log_likelihood_ratio(self, X):
        """``((x - mean_) / scale_) @ coef_ + intercept_`` of each row, in
        float64 on the host: ``log p / (1 - p)``."""
        w, b, mu, sd = self._fit
        Xs = (np.atleast_2d(np.asarray(X, np.float64)) - mu) / sd
        z = Xs @ w.astype(np.float64) + b
        if self.class_min > 0:
            # p = max(sigmoid(z), class_min) in logit space
            z = np.maximum(z, math.log(self.class_min / (1 - self.class_min)))
        return z

    @property
    def attributes(self):
        w, b, mu, sd = self._fit
        return {"parameters": {"coef_": [w.tolist()], "intercept_": [b],
                               "n_iter": [LOGREG_NEWTON],
                               "mean_": mu.tolist(), "scale_": sd.tolist()}}


def _laplace_mode(K, y01, n_newton=20):
    """Newton iterations for the Laplace approximation's latent mode of a
    logistic likelihood (Rasmussen & Williams, Algorithm 3.1)."""
    n = K.shape[0]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    with full_float32_matmul():
        f = torch.zeros(n, dtype=K.dtype, device=K.device)
        for _ in range(n_newton):
            pi = torch.sigmoid(f)
            W = pi * (1 - pi)
            sW = torch.sqrt(W)
            L = _cholesky(eye + sW[:, None] * K * sW[None, :])
            b = W * f + (y01 - pi)
            a = b - sW * torch.cholesky_solve((sW * (K @ b))[:, None], L)[:, 0]
            f = K @ a
        pi = torch.sigmoid(f)
        sW = torch.sqrt(pi * (1 - pi))
        L = _cholesky(eye + sW[:, None] * K * sW[None, :])
    return f, pi, sW, L


def _laplace_predict(Kxs, Kss_diag, f, pi, sW, L, y01):
    """Predictive class-1 probability by the probit approximation."""
    with full_float32_matmul():
        mu = Kxs.T @ (y01 - pi)
        v = torch.linalg.solve_triangular(L, sW[:, None] * Kxs, upper=False)
        var = torch.clamp(Kss_diag - torch.sum(v * v, dim=0), min=1e-10)
    # MacKay's probit approximation of the logistic-Gaussian integral
    kappa = 1.0 / torch.sqrt(1.0 + math.pi * var / 8.0)
    return torch.sigmoid(kappa * mu)


class GPClassifier(Classifier):
    """Laplace-approximation GP binary classifier (the JAX package's
    replacement of GPy's ``GPClassification``, reference
    ``classifier.py:126-189``), on ``device`` (None: the global backend's).

    ARD RBF kernel with median-heuristic lengthscales; labels in {-1, +1}
    or {0, 1}."""

    def __init__(self, kernel=None, mean_function=None, class_min=0,
                 signal_var=1.0, device=None):
        self.class_min = class_min
        self.signal_var = signal_var
        self.device = device
        self._fit = None

    @staticmethod
    def _median_lengthscales(X):
        n = min(len(X), 300)
        sub = X[:n]
        d2 = np.abs(sub[:, None, :] - sub[None, :, :])
        med = np.median(d2[np.triu_indices(n, 1)], axis=0)
        return np.maximum(med, 1e-3)

    def _kern(self, A, B):
        d2 = np.sum(((A[:, None, :] - B[None, :, :]) / self._ls) ** 2, axis=-1)
        return self.signal_var * np.exp(-0.5 * d2)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self._device)

    def fit(self, X, y):
        self._device = resolve_device(self.device)
        X = np.asarray(X, np.float64)
        y01 = (np.asarray(y) > 0).astype(np.float64)
        self._ls = self._median_lengthscales(X)
        K = self._kern(X, X) + 1e-6 * np.eye(len(X))
        yt = self._tensor(y01)
        self._fit = (X, yt) + _laplace_mode(self._tensor(K), yt)

    def predict_proba(self, X):
        Xtr, y01, f, pi, sW, L = self._fit
        X = np.asarray(X, np.float64)
        p1 = _laplace_predict(
            self._tensor(self._kern(Xtr, X)),
            self._tensor(np.full(len(X), self.signal_var)), f, pi, sW, L,
            y01).cpu().numpy()
        return np.column_stack([1 - p1, p1])

    def predict_log_likelihood_ratio(self, X):
        p = np.maximum(self.predict_proba(X)[:, 1], self.class_min)
        return np.log(p / (1 - p))

    @property
    def attributes(self):
        return {"parameters": {"lengthscales": self._ls.tolist(),
                               "signal_var": self.signal_var}}
