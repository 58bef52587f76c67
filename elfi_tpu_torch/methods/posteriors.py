"""The BOLFI and BOLFIRE approximate posteriors (counterparts of
:class:`elfi_tpu.methods.posteriors.BolfiPosterior` and
:class:`elfi_tpu.methods.posteriors.BolfirePosterior`).

A sampler target is a function of rows ``theta`` (n, d) and one tuple of
fit data (the threshold, the padded GP factor with its masked ``K^-1`` or
its weights, the prior box), so the samplers evaluate all chains in one
batch."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import special
from .bo.gp import full_float32_matmul, value_and_grad
from .bo.utils import minimize, minimize_traced
# defined with ROMC; re-exported here, where the JAX package has it
from .romc import RomcPosterior  # noqa: F401
from .utils import flat_array_to_dict

__all__ = ["BolfiPosterior", "BolfirePosterior", "RomcPosterior"]


def _bolfi_box_target_for(fns):
    """The target ``Phi((h - mu) / sigma) * uniform-box prior`` in log
    space, as a function of rows and the fit data; one object per GP
    function bundle."""
    tgt = getattr(fns, "_bolfi_box_target", None)
    if tgt is None:
        def tgt(theta, data):
            h, Xp, mask, Kinv, alpha, params, lo, hi, logconst = data
            mu, var = fns.predict_inv(theta, Xp, mask, Kinv, alpha, params)
            loglik = special.norm_logcdf((h - mu) / torch.sqrt(var))
            in_box = torch.all((theta >= lo) & (theta <= hi), dim=-1)
            return torch.where(in_box, loglik + logconst, -math.inf)

        fns._bolfi_box_target = tgt
    return tgt


class BolfiPosterior:
    r"""BOLFI approximate posterior: L(theta) ~ Phi((h - mu) / sigma) with the
    GP mean and standard deviation (Gutmann & Corander 2016; reference
    ``posteriors.py:21-256``).

    ``logpdf``/``gradient_logpdf`` are host APIs (numpy in and out) over
    the GP's device; :meth:`traceable_logpdf_args` gives the target for the
    device samplers.
    """

    def __init__(self, model, threshold=None, prior=None, n_inits=10,
                 max_opt_iters=1000, seed=0):
        self.model = model
        self.prior = prior
        self.dim = model.input_dim
        self.random_state = np.random.RandomState(seed)
        self.n_inits = n_inits
        self.max_opt_iters = max_opt_iters
        if threshold is None:
            # the threshold is the minimum of the GP mean (reference
            # ``posteriors.py:64-78``), found on the device
            if getattr(model, "_factor", None) is not None:
                Xp, mask, L, alpha, params = model._factor
                _, minval = minimize_traced(
                    model.fns.mean_obj, model.bounds,
                    args=(Xp, mask, L, alpha, params),
                    n_starts=n_inits, steps=max(100, min(max_opt_iters, 300)),
                    seed=seed)
            else:
                _, minval = minimize(self.model.predict_mean,
                                     self.model.bounds,
                                     grad=self.model.predictive_gradient_mean,
                                     prior=prior, n_start_points=n_inits,
                                     maxiter=max_opt_iters,
                                     random_state=self.random_state)
            threshold = float(np.asarray(minval))
        self.threshold = threshold
        self._cache = {}

    # -- the sampler target ---------------------------------------------------
    def traceable_logpdf_args(self):
        """``(target, target_args)`` with ``target(theta, *target_args)``
        mapping rows (n, d) to (n,).  All fit data flows through
        ``target_args``; for a uniform-box prior (or none) the target is
        one object per GP function bundle."""
        fns = self.model.fns
        Xp, mask, L, alpha, params = self.model._factor
        device = Xp.device
        Kinv = fns.posterior_inverse(L, mask)
        h = torch.tensor(self.threshold, dtype=torch.float32, device=device)
        box = self.prior.box() if self.prior is not None else None
        if self.prior is None or box is not None:
            if box is None:
                d = self.dim
                lo = torch.full((d,), -math.inf, device=device)
                hi = torch.full((d,), math.inf, device=device)
                lc = torch.tensor(0.0, device=device)
            else:
                lo = torch.as_tensor(box[0], device=device)
                hi = torch.as_tensor(box[1], device=device)
                lc = torch.tensor(box[2], dtype=torch.float32, device=device)
            data = (h, Xp, mask, Kinv, alpha, params, lo, hi, lc)
            return _bolfi_box_target_for(fns), (data,)

        prior_logpdf = self.prior.traceable_logpdf()

        def target(theta, data):
            h, Xp, mask, Kinv, alpha, params = data
            mu, var = fns.predict_inv(theta, Xp, mask, Kinv, alpha, params)
            loglik = special.norm_logcdf((h - mu) / torch.sqrt(var))
            return loglik + prior_logpdf(theta)

        return target, ((h, Xp, mask, Kinv, alpha, params),)

    def traceable_logpdf(self):
        """``theta`` rows (n, d) -> (n,) over the current fit."""
        fn, (data,) = self.traceable_logpdf_args()
        return lambda theta: fn(theta, data)

    def _target(self):
        # kept per GP factor: a posterior held across a continued fit()
        # tracks the refitted model, while the threshold stays as it was
        # extracted
        factor = self.model._factor
        cached = self._cache.get("target")
        if cached is None or cached[0] is not factor:
            self._cache["target"] = (factor, self.traceable_logpdf())
        return self._cache["target"][1]

    # -- host API -------------------------------------------------------------
    def _rows(self, x):
        x = np.asarray(x, np.float32)
        return x.ndim == 1, torch.as_tensor(np.atleast_2d(x),
                                            device=self.model.device)

    def logpdf(self, x):
        single, rows = self._rows(x)
        with torch.no_grad():
            vals = self._target()(rows).cpu().numpy()
        return float(vals[0]) if single else vals

    def pdf(self, x):
        return np.exp(self.logpdf(x))

    def gradient_logpdf(self, x):
        single, rows = self._rows(x)
        _, g = value_and_grad(self._target(), rows)
        g = g.cpu().numpy()
        g = np.where(np.isfinite(g), g, 0.0)
        return g[0] if single else g

    def _unnormalized_loglikelihood(self, x):
        x = np.atleast_2d(np.asarray(x, np.float32))
        mean, var = self.model.predict(x)
        return special.norm_logcdf(torch.as_tensor(
            (self.threshold - mean.ravel()) / np.sqrt(var.ravel()),
            dtype=torch.float32)).numpy()

    def rvs(self, size=None, random_state=None):
        raise NotImplementedError(
            "Use a sampler (e.g. BOLFI.sample) to sample from the posterior")

    def plot(self, logpdf=False):
        from ..visualization import plot_gp
        return plot_gp(self.model, self.model.parameter_names or
                       [f"x{i}" for i in range(self.dim)])


def _gp_mean(fns, theta, Xp, mask, alpha, params):
    """The GP posterior mean at rows ``theta``: ``k(theta, X) alpha``."""
    with full_float32_matmul():
        return (fns.kernel(theta, Xp, params) * mask) @ alpha


def _bolfire_box_target_for(fns):
    """The target ``exp(-GP mean) * uniform-box prior`` in log space, as a
    function of rows and the fit data; one object per GP function bundle.
    The surrogate is fitted to the negative log-ratio, so the log-posterior
    subtracts its mean (reference ``posteriors.py:326``)."""
    tgt = getattr(fns, "_bolfire_box_target", None)
    if tgt is None:
        def tgt(theta, data):
            Xp, mask, alpha, params, lo, hi, logconst = data
            mu = _gp_mean(fns, theta, Xp, mask, alpha, params)
            in_box = torch.all((theta >= lo) & (theta <= hi), dim=-1)
            return torch.where(in_box, -mu + logconst, -math.inf)

        fns._bolfire_box_target = tgt
    return tgt


class BolfirePosterior:
    """BOLFIRE posterior: prior * exp(-GP mean), the GP fitted to the
    negative log-ratio (reference ``posteriors.py:259-390``, whose
    ``logpdf`` is ``prior.logpdf(x) - model.predict_mean(x)``).

    ``logpdf``/``gradient_logpdf`` are host APIs (numpy in and out) over the
    GP's device; :meth:`traceable_logpdf_args` gives the target for the
    device samplers."""

    def __init__(self, parameter_names, model, prior,
                 classifier_attributes=None, seed=0):
        self.parameter_names = parameter_names
        self.model = model
        self.prior = prior
        self.classifier_attributes = classifier_attributes or []
        self.random_state = np.random.RandomState(seed)
        self._cache = {}

    def traceable_logpdf_args(self):
        """``(target, target_args)`` with ``target(theta, *target_args)``
        mapping rows (n, d) to (n,); all fit data flows through
        ``target_args``.  For a uniform-box prior the target is one object
        per GP function bundle: ``-mu + logconst`` inside the box and
        ``-inf`` outside; otherwise ``-mu + prior logpdf``."""
        fns = self.model.fns
        Xp, mask, _, alpha, params = self.model._factor
        device = Xp.device
        box = self.prior.box() if self.prior is not None else None
        if box is not None:
            data = (Xp, mask, alpha, params,
                    torch.as_tensor(box[0], device=device),
                    torch.as_tensor(box[1], device=device),
                    torch.tensor(box[2], dtype=torch.float32, device=device))
            return _bolfire_box_target_for(fns), (data,)

        prior_logpdf = self.prior.traceable_logpdf()

        def target(theta, data):
            Xp, mask, alpha, params = data
            return (-_gp_mean(fns, theta, Xp, mask, alpha, params)
                    + prior_logpdf(theta))

        return target, ((Xp, mask, alpha, params),)

    def traceable_logpdf(self):
        """``theta`` rows (n, d) -> (n,) over the current fit."""
        fn, (data,) = self.traceable_logpdf_args()
        return lambda theta: fn(theta, data)

    def _target(self):
        # kept per GP factor, so a refitted surrogate is tracked
        factor = self.model._factor
        cached = self._cache.get("target")
        if cached is None or cached[0] is not factor:
            self._cache["target"] = (factor, self.traceable_logpdf())
        return self._cache["target"][1]

    def _rows(self, x):
        x = np.asarray(x, np.float32)
        return x.ndim == 1, torch.as_tensor(np.atleast_2d(x),
                                            device=self.model.device)

    def logpdf(self, x):
        single, rows = self._rows(x)
        with torch.no_grad():
            vals = self._target()(rows).cpu().numpy()
        return float(vals[0]) if single else vals

    def pdf(self, x):
        return np.exp(self.logpdf(x))

    def gradient_logpdf(self, x):
        single, rows = self._rows(x)
        _, g = value_and_grad(self._target(), rows)
        g = g.cpu().numpy()
        g = np.where(np.isfinite(g), g, 0.0)
        return g[0] if single else g

    @property
    def map_estimates(self):
        """The MAP point by a multi-start minimization of -logpdf on the
        host (reference ``posteriors.py:366-390``)."""
        loc, _ = minimize(lambda x: -self.logpdf(x), self.model.bounds,
                          grad=lambda x: -self.gradient_logpdf(x),
                          prior=self.prior, n_start_points=10,
                          random_state=self.random_state)
        return flat_array_to_dict(self.parameter_names, loc)
