"""Acquisition rules for Bayesian optimization (counterpart of
:mod:`elfi_tpu.methods.bo.acquisition`): the base rule with its
truncated-normal exploration noise, ``LCBSC`` and ``UniformAcquisition``.

Every surrogate evaluation goes through the GP's functions on its device;
gradients come from autograd.  The variance-based rules (MaxVar,
RandMaxVar, ExpIntVar) are not ported yet.

Streams: the JAX package keys each draw with ``fold_in(key(seed), count)``;
here the same integers seed ``torch.Generator`` streams
(:mod:`elfi_tpu_torch.utils.rng`), so the draws agree statistically.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ...ops.distributions import truncnorm
from ...utils.rng import fold_in, generator
from .utils import CostFunction, minimize, minimize_traced

__all__ = ["AcquisitionBase", "LCBSC", "UniformAcquisition"]

#: folded into the seed with the acquisition count to key the host path's
#: epsilon-greedy coin (the JAX package's constant)
_EPS_SALT = 0x0E5 * 0x10000


class AcquisitionBase:
    """Base acquisition: optimize ``evaluate`` over the model bounds and add
    truncated-normal exploration noise (reference
    ``acquisition.py:16-191``)."""

    def __init__(self, model, prior=None, n_inits=10, max_opt_iters=1000,
                 noise_var=None, exploration_rate=10, seed=None,
                 constraints=None):
        self.model = model
        self.prior = prior
        self.n_inits = int(n_inits)
        self.max_opt_iters = int(max_opt_iters)
        self.constraints = constraints
        if noise_var is not None:
            noise_var = self._transform_noise_var(noise_var)
        self.noise_var = noise_var
        self.exploration_rate = exploration_rate
        self.random_state = np.random if seed is None \
            else np.random.RandomState(seed)
        self.seed = 0 if seed is None else seed
        self._acq_count = 0

    def _transform_noise_var(self, noise_var):
        if isinstance(noise_var, dict):
            if not set(noise_var) == set(self.model.parameter_names):
                raise ValueError("Acquisition noise dictionary should "
                                 "contain all parameters")
            return [noise_var[n] for n in self.model.parameter_names]
        if isinstance(noise_var, (int, float)):
            if noise_var < 0:
                raise ValueError("Acquisition noise should be non-negative")
            return noise_var
        raise ValueError("noise_var must be a float or a dict of floats")

    def evaluate(self, x, t=None):
        raise NotImplementedError

    def evaluate_gradient(self, x, t=None):
        raise NotImplementedError

    def acquire(self, n, t=None):
        """Optimize the acquisition and return n (noise-jittered) copies of
        the minimizer (reference ``acquisition.py:129-172``).

        When the rule has a device objective (``_traced``), all restarts
        run as one batched descent on the GP's device; otherwise scipy's
        multistart on the host."""
        traced = self._traced(t)
        if traced is not None and self.constraints is None:
            obj, args = traced
            self._acq_count += 1
            xhat, _ = minimize_traced(obj, self.model.bounds, args=args,
                                      n_starts=self.n_inits,
                                      steps=min(self.max_opt_iters, 200),
                                      seed=fold_in(self.seed,
                                                   self._acq_count))
        else:
            def obj(x):
                return self.evaluate(x, t)

            def grad_obj(x):
                return self.evaluate_gradient(x, t)

            xhat, _ = minimize(
                obj, self.model.bounds,
                method="L-BFGS-B" if self.constraints is None else "SLSQP",
                constraints=self.constraints, grad=grad_obj,
                prior=self.prior, n_start_points=self.n_inits,
                maxiter=self.max_opt_iters,
                random_state=self.random_state)
        x = np.tile(np.asarray(xhat, np.float64), (n, 1))
        return self._add_noise(x)

    def _traced(self, t):
        """``(objective, args)`` of the device path, or None (host
        path)."""
        return None

    def _add_noise(self, x):
        """Truncated-normal jitter within the bounds (reference
        ``acquisition.py:174-191``); dimensions with no noise are left
        as they are."""
        if self.noise_var is None:
            return x
        noise_var = np.asanyarray(self.noise_var)
        if noise_var.ndim == 0:
            noise_var = np.tile(noise_var, self.model.input_dim)
        self._acq_count += 1
        key = fold_in(self.seed, self._acq_count)
        for i in range(self.model.input_dim):
            std = np.sqrt(noise_var[i])
            if std == 0:
                continue
            xi = x[:, i]
            a = (self.model.bounds[i][0] - xi) / std
            b = (self.model.bounds[i][1] - xi) / std
            draw = truncnorm.rvs(torch.as_tensor(a), torch.as_tensor(b),
                                 loc=torch.as_tensor(xi), scale=float(std),
                                 size=len(x),
                                 generator=generator(fold_in(key, i), "cpu"))
            x[:, i] = draw.numpy()
        return x


class LCBSC(AcquisitionBase):
    r"""GP Lower Confidence Bound Selection Criterion (Srinivas et al. 2010;
    reference ``acquisition.py:194-301``): mean - sqrt(beta_t * var) with
    beta_t = 2 log(t^(2d+2) pi^2 / (3 delta))."""

    def __init__(self, *args, delta=None, additive_cost=None, epsilon=0.0,
                 **kwargs):
        if delta is not None:
            if delta <= 0 or delta >= 1:
                logging.getLogger(__name__).warning(
                    "Parameter delta should be in the interval (0,1)")
            kwargs["exploration_rate"] = 1 / delta
        super().__init__(*args, **kwargs)
        self.name = "lcbsc"
        if additive_cost is not None and not isinstance(additive_cost,
                                                        CostFunction):
            raise TypeError("Additive cost must be type CostFunction")
        self.additive_cost = additive_cost
        if not 0.0 <= epsilon < 1.0:
            raise ValueError("epsilon must be in [0, 1)")
        # epsilon-greedy global anchoring: with probability epsilon an
        # acquisition is a uniform prior-box draw instead of the LCB
        # minimizer; 0 is classic LCBSC
        self.epsilon = float(epsilon)
        self._combined_obj = None

    def acquire(self, n, t=None):
        if self.epsilon > 0.0:
            self._acq_count += 1
            coin = torch.rand((), generator=generator(
                fold_in(self.seed, _EPS_SALT + self._acq_count), "cpu"))
            if float(coin) < self.epsilon:
                bounds = np.stack(self.model.bounds)
                return self.random_state.uniform(
                    bounds[:, 0], bounds[:, 1],
                    size=(n, self.model.input_dim))
        return super().acquire(n, t)

    @property
    def delta(self):
        return 1 / self.exploration_rate

    def _beta(self, t):
        t += 1
        d = self.model.input_dim
        return 2 * np.log(t ** (2 * d + 2) * np.pi ** 2 / (3 * self.delta))

    def evaluate(self, x, t=None):
        mean, var = self.model.predict(x, noiseless=True)
        value = mean - np.sqrt(self._beta(t) * var)
        if self.additive_cost is not None:
            value = value + self.additive_cost.evaluate(x)
        return value

    def evaluate_gradient(self, x, t=None):
        mean, var = self.model.predict(x, noiseless=True)
        grad_mean, grad_var = self.model.predictive_gradients(x)
        value = grad_mean - 0.5 * grad_var * np.sqrt(self._beta(t) / var)
        if self.additive_cost is not None:
            value = value + self.additive_cost.evaluate_gradient(x)
        return value

    def _traced(self, t):
        factor = getattr(self.model, "_factor", None)
        if factor is None:
            return None
        Xp, mask, L, alpha, params = factor
        # the cached-inverse predict: each of the descent's evaluations is
        # a matmul instead of a triangular solve
        Kinv = self.model.fns.posterior_inverse(L, mask)
        beta = torch.tensor(np.float32(self._beta(t)), device=Xp.device)
        neg_lcb = self.model.fns.neg_lcb_obj_inv
        if self.additive_cost is None:
            return neg_lcb, (Xp, mask, Kinv, alpha, params, beta)
        cost_tr = getattr(self.additive_cost, "traceable", None)
        if cost_tr is None:
            return None
        if self._combined_obj is None:
            scale = self.additive_cost.scale

            def combined(theta, X, m, Ki, a, p, b):
                return neg_lcb(theta, X, m, Ki, a, p, b) \
                    + scale * cost_tr(theta)

            self._combined_obj = combined
        return self._combined_obj, (Xp, mask, Kinv, alpha, params, beta)


class UniformAcquisition(AcquisitionBase):
    """Uniform random acquisition (reference ``acquisition.py:824-845``)."""

    def acquire(self, n, t=None):
        bounds = np.stack(self.model.bounds)
        return self.random_state.uniform(bounds[:, 0], bounds[:, 1],
                                         size=(n, self.model.input_dim))
