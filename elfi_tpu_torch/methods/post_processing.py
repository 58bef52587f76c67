"""Regression adjustment of ABC samples (Lintusaari et al. 2017;
counterpart of :mod:`elfi_tpu.methods.post_processing`).

The JAX package fits sklearn's ``LinearRegression``; the port fits the same
ordinary least squares with an intercept in numpy (:class:`OLS`), so it
needs no sklearn.  Samples are numpy (the port's results are); the
observed summaries are computed on the global backend's device and copied
to the host."""

from __future__ import annotations

import warnings

import numpy as np

from ..utils import to_numpy
from . import results

__all__ = ["RegressionAdjustment", "LinearAdjustment", "adjust_posterior",
           "OLS"]


def _observed_summary(model, name):
    from ..compile.compiler import compile_program
    from ..parallel.backends import resolve_device
    prog = compile_program(model, (name,), device=resolve_device(None))
    return np.asarray(to_numpy(prog.observed_value(name))).reshape(-1)


class OLS:
    """Ordinary least squares with an intercept: the fit of sklearn's
    ``LinearRegression()`` (the centred problem solved by ``lstsq``), in
    float64.  ``coef_`` and ``intercept_`` as sklearn names them."""

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        x_mean, y_mean = X.mean(axis=0), y.mean(axis=0)
        self.coef_ = np.linalg.lstsq(X - x_mean, y - y_mean, rcond=None)[0]
        self.intercept_ = y_mean - x_mean @ self.coef_
        return self


class RegressionAdjustment:
    """Per-parameter local regression on the summary statistics."""

    _regression_model = None
    _name = "RegressionAdjustment"

    def __init__(self, **kwargs):
        self._model_kwargs = kwargs
        self._fitted = False
        self.regression_models = []
        self._X = None
        self._sample = None
        self._parameter_names = None
        self._finite = []

    @property
    def parameter_names(self):
        self._check_fitted()
        return self._parameter_names

    @property
    def sample(self):
        self._check_fitted()
        return self._sample

    @property
    def X(self):
        self._check_fitted()
        return self._X

    def _check_fitted(self):
        if not self._fitted:
            raise ValueError("The regression model must be fitted first; "
                             "use fit()")

    def fit(self, sample, model, summary_names, parameter_names=None):
        self._X = self._input_variables(model, sample, summary_names)
        self._sample = sample
        self._parameter_names = parameter_names or sample.parameter_names
        self._get_finite()
        for X, y in self._pairs():
            self.regression_models.append(
                self._regression_model(**self._model_kwargs).fit(X, y))
        self._fitted = True

    def _pairs(self):
        for i, name in enumerate(self._parameter_names):
            X = self._X[self._finite[i], :]
            p = np.asarray(self._sample.outputs[name])[self._finite[i]]
            yield X, p

    def _get_finite(self):
        finite_inputs = np.isfinite(self._X).all(axis=1)
        self._finite = [
            finite_inputs & np.isfinite(np.asarray(self._sample.outputs[p]))
            for p in self._parameter_names]
        if not all(map(all, self._finite)):
            warnings.warn("Non-finite inputs and outputs will be omitted.")

    def adjust(self):
        outputs = {}
        for i, name in enumerate(self.parameter_names):
            theta_i = np.asarray(self.sample.outputs[name])[self._finite[i]]
            outputs[name] = self._adjust(i, theta_i,
                                         self.regression_models[i])
        return results.Sample(method_name=self._name, outputs=outputs,
                              parameter_names=self._parameter_names)

    def _adjust(self, i, theta_i, regression_model):
        raise NotImplementedError

    def _input_variables(self, model, sample, summary_names):
        raise NotImplementedError


class LinearAdjustment(RegressionAdjustment):
    """Local linear regression adjustment."""

    _name = "LinearAdjustment"
    _regression_model = OLS

    def _adjust(self, i, theta_i, regression_model):
        b = regression_model.coef_
        return theta_i - self.X[self._finite[i], :] @ b

    def _input_variables(self, model, sample, summary_names):
        """Regress on the differences to the observed summaries."""
        observed = np.concatenate([_observed_summary(model, s)
                                   for s in summary_names])
        summaries = np.column_stack(
            [np.asarray(sample.outputs[name]).reshape(
                len(sample.outputs[name]), -1) for name in summary_names])
        return summaries - observed


def adjust_posterior(sample, model, summary_names, parameter_names=None,
                     adjustment="linear"):
    """Adjust a posterior sample by local regression on the differences of
    ``summary_names`` to their observed values."""
    adjustment = _get_adjustment(adjustment)
    adjustment.fit(model=model, sample=sample,
                   parameter_names=parameter_names,
                   summary_names=summary_names)
    return adjustment.adjust()


def _get_adjustment(adjustment):
    adjustments = {"linear": LinearAdjustment}
    if isinstance(adjustment, RegressionAdjustment):
        return adjustment
    if isinstance(adjustment, str):
        if adjustment in adjustments:
            return adjustments[adjustment]()
        raise ValueError(f"Could not find adjustment method: {adjustment}")
    raise ValueError("adjustment must be a string or RegressionAdjustment")
