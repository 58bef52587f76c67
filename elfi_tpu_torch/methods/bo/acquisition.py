"""Acquisition rules for Bayesian optimization (counterpart of
:mod:`elfi_tpu.methods.bo.acquisition`): the base rule with its
truncated-normal exploration noise, ``LCBSC``, the variance rules
``MaxVar``, ``RandMaxVar`` and ``ExpIntVar``, and ``UniformAcquisition``.

Every surrogate evaluation goes through the GP's functions on its device;
gradients come from autograd.  The variance rules use the skew-normal CDF
of :mod:`elfi_tpu_torch.ops.special`, so their objectives run inside the
device descent (:func:`~.utils.minimize_traced`) and RandMaxVar's chain on
the device samplers.

Streams: the JAX package keys each draw with ``fold_in(key(seed), count)``;
here the same integers seed ``torch.Generator`` streams
(:mod:`elfi_tpu_torch.utils.rng`), so the draws agree statistically.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ...ops import special
from ...ops.distributions import truncnorm
from ...utils.rng import fold_in, generator
from .gp import full_float32_matmul, value_and_grad
from .utils import CostFunction, minimize, minimize_traced

__all__ = ["AcquisitionBase", "LCBSC", "MaxVar", "RandMaxVar", "ExpIntVar",
           "UniformAcquisition"]

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


def _indicator_moments(eps, mean, var, noise):
    """First two posterior moments of the ABC indicator estimate
    ``p(theta) = Phi((eps - f) / sqrt(noise))`` when the GP gives
    ``f ~ N(mean, var)`` (any broadcastable shapes).

    ``E[p] = Phi(eps; mean, sqrt(noise + var))`` and ``E[p^2]`` is the CDF
    of a skew normal with shape ``sqrt(noise / (noise + 2 var))``, both
    differentiable by autograd (the reference evaluates them with scipy and
    hand-derived gradients, ``acquisition.py:392-469``)."""
    width = torch.sqrt(noise + var)
    shape = torch.sqrt(noise) * torch.rsqrt(noise + 2.0 * var)
    first = special.norm_cdf(eps, loc=mean, scale=width)
    second = special.skewnorm_cdf(eps, shape, loc=mean, scale=width)
    return first, second


class MaxVar(AcquisitionBase):
    r"""Maximise the variance of the unnormalised approximate posterior
    (Jarvenpaa et al. 2019; reference ``acquisition.py:304-469``).

    The rule is one objective on the GP's device: the descent
    (:func:`~.utils.minimize_traced`) runs all restarts as one batch on the
    log of ``prior(theta)^2 Var[p(theta)]``, and ``evaluate_gradient`` is
    its autograd gradient."""

    def __init__(self, model, prior, quantile_eps=.01, **opts):
        super().__init__(model, prior=prior, **opts)
        self.name = "max_var"
        self.quantile_eps = quantile_eps
        self.eps = .1
        self._fns = None
        self._gp_args_cache = None

    def _build_fns(self):
        """The objective family, built once per instance, so that the
        captured descents keyed on it are replayed across acquisitions;
        per-call data (the GP factor, eps) comes through the arguments.
        Predictions use the cached inverse (a matmul per evaluation)."""
        if self._fns is not None:
            return self._fns
        prior_logpdf = self.prior.traceable_logpdf()
        predict_noiseless = self.model.fns.predict_noiseless_inv

        def log_value(theta, Xp, mask, Kinv, alpha, params, eps):
            mean, var = predict_noiseless(theta, Xp, mask, Kinv, alpha,
                                          params)
            first, second = _indicator_moments(eps, mean, var,
                                               params["noise"])
            var_p = torch.clamp(second - first ** 2, min=1e-32)
            return 2.0 * prior_logpdf(theta) + torch.log(var_p)

        def neg_log_value(theta, *args):
            return -log_value(theta, *args)

        def value(theta, *args):
            return torch.exp(log_value(theta, *args))

        self._fns = dict(neg_log=neg_log_value, log_value=log_value,
                         value=value)
        return self._fns

    def _gp_args(self):
        """``(Xp, mask, Kinv, alpha, params, eps)`` of the current GP factor
        and eps, kept until either changes: the constrained host path
        evaluates once per optimizer iteration."""
        factor = self.model._factor
        if factor is None:
            raise ValueError("GP has no evidence yet")
        cached = self._gp_args_cache
        if cached is not None and cached[0] is factor \
                and cached[1] == self.eps:
            return cached[2]
        Xp, mask, L, alpha, params = factor
        Kinv = self.model.fns.posterior_inverse(L, mask)
        args = (Xp, mask, Kinv, alpha, params,
                torch.tensor(np.float32(self.eps), device=Xp.device))
        self._gp_args_cache = (factor, self.eps, args)
        return args

    def _update_eps(self):
        # the quantile of the evidence targets
        self.eps = float(np.percentile(np.asarray(self.model.Y),
                                       self.quantile_eps * 100))

    def _traced(self, t):
        return self._build_fns()["neg_log"], self._gp_args()

    def _rows(self, theta_new):
        return torch.atleast_2d(torch.as_tensor(
            np.asarray(theta_new, np.float32), device=self.model.device))

    def acquire(self, n, t=None):
        self._update_eps()
        if self.constraints is None:
            obj, args = self._traced(t)
            self._acq_count += 1
            xhat, _ = minimize_traced(obj, self.model.bounds, args=args,
                                      n_starts=self.n_inits,
                                      steps=min(self.max_opt_iters, 200),
                                      seed=fold_in(self.seed,
                                                   self._acq_count))
        else:
            # the constrained host path; this rule maximises
            xhat, _ = minimize(lambda x: -self.evaluate(x, t),
                               self.model.bounds, method="SLSQP",
                               constraints=self.constraints,
                               grad=lambda x: -self.evaluate_gradient(x, t),
                               prior=self.prior,
                               n_start_points=self.n_inits,
                               maxiter=self.max_opt_iters,
                               random_state=self.random_state)
        return self._add_noise(np.tile(np.asarray(xhat, np.float64), (n, 1)))

    def evaluate(self, theta_new, t=None):
        """``prior^2 Var[p]`` at each row of theta_new, (n, 1)."""
        with torch.no_grad():
            vals = self._build_fns()["value"](self._rows(theta_new),
                                              *self._gp_args())
        return vals.cpu().numpy()[:, None]

    def evaluate_gradient(self, theta_new, t=None):
        """Autograd gradient of :meth:`evaluate`, (n, d); non-finite
        entries are 0."""
        args = self._gp_args()
        value = self._build_fns()["value"]
        _, g = value_and_grad(lambda th: value(th, *args),
                              self._rows(theta_new))
        g = g.cpu().numpy()
        return np.where(np.isfinite(g), g, 0.0)


class RandMaxVar(MaxVar):
    r"""Sample the MaxVar density with the device NUTS or Metropolis
    chain (reference ``acquisition.py:472-626``)."""

    def __init__(self, model, prior, quantile_eps=.01, sampler="nuts",
                 n_samples=50, warmup=None, limit_faulty_init=1000,
                 init_from_prior=False, sigma_proposals=None, **opts):
        super().__init__(model, prior, quantile_eps, **opts)
        self.name = "rand_max_var"
        self.name_sampler = sampler
        self._n_samples = n_samples
        self._warmup = warmup or n_samples // 2
        self._limit_faulty_init = limit_faulty_init
        self._init_from_prior = init_from_prior
        self._sigma_proposals = sigma_proposals

    def _traceable_logpdf(self):
        """The log of the MaxVar density over the current fit, rows
        ``theta`` (n, d) -> (n,)."""
        log_value = self._build_fns()["log_value"]
        args = self._gp_args()
        return lambda theta: log_value(theta, *args)

    def acquire(self, n, t=None):
        from .. import mcmc
        from ..utils import resolve_sigmas
        if n > self._n_samples:
            raise ValueError("The number of acquisitions has to be lower "
                             "than the number of the samples")
        gp = self.model
        self._update_eps()
        log_value = self._build_fns()["log_value"]
        args = self._gp_args()

        # every candidate start drawn up front and scored in one batch (the
        # reference probes them one at a time, acquisition.py:551-575)
        n_try = self._limit_faulty_init
        if self._init_from_prior:
            inits = np.atleast_2d(np.asarray(
                self.prior.rvs(size=n_try, seed=self.seed), np.float64))
            for j, b in enumerate(gp.bounds):
                inits[:, j] = np.clip(inits[:, j], *b)
        else:
            bounds = np.asarray(gp.bounds)
            inits = self.random_state.uniform(
                bounds[:, 0], bounds[:, 1], size=(n_try, len(bounds)))
        with torch.no_grad():
            logps = log_value(self._rows(inits), *args).cpu().numpy()
        finite = np.isfinite(logps)
        if not finite.any():
            raise RuntimeError("Unable to find a suitable initial point")
        theta_init = inits[int(np.argmax(finite))]

        if self.name_sampler == "metropolis":
            sigmas = resolve_sigmas(self.model.parameter_names,
                                    self._sigma_proposals, self.model.bounds)
            samples = mcmc.metropolis(self._n_samples, theta_init, log_value,
                                      sigmas, seed=self.seed,
                                      target_args=args)
        elif self.name_sampler == "nuts":
            # the bounds widths as a diagonal mass matrix
            bw = np.asarray([hi - lo for lo, hi in gp.bounds], np.float32)
            samples = mcmc.nuts(self._n_samples, theta_init, log_value,
                                seed=self.seed, scales=bw, target_args=args)
        else:
            raise ValueError("Incompatible sampler")
        if n > 1:
            samples = samples[self._warmup:]
            return self.random_state.permutation(samples)[:n]
        return samples[-1:]


def _lookahead_state_fn(fns):
    """The per-round precompute of ExpIntVar for the GP functions ``fns``:
    the posterior moments at the integration nodes, the cross term
    ``K^-1 k(X, P)`` that turns each candidate's lookahead covariance into
    one matmul, and the current indicator mean Phi at every node."""

    def state(Xp, mask, Kinv, alpha, params, eps, points):
        # full-precision float32 matmuls: the K^-1 cross terms cancel like
        # the GP variance's quadratic form
        with full_float32_matmul():
            mean_p, var_p = fns.predict_noiseless_inv(points, Xp, mask, Kinv,
                                                      alpha, params)
            kxp = fns.cross_cov(Xp, points, params) * mask[:, None]
            kinv_kxp = Kinv @ kxp
        phi_p, _ = _indicator_moments(eps, mean_p, var_p, params["noise"])
        return mean_p, var_p, kinv_kxp, phi_p

    return state


class ExpIntVar(MaxVar):
    r"""Expected Integrated Variance acquisition (Jarvenpaa et al. 2019;
    reference ``acquisition.py:629-821``).

    Each round one precompute gives the integration nodes' state
    (:func:`_lookahead_state_fn`); the expected loss is then a function on
    the device whose every evaluation is a few matmuls against the cached
    cross term, so the descent runs all restarts as one batch."""

    def __init__(self, model, prior, quantile_eps=.01, integration="grid",
                 d_grid=.2, n_samples_imp=100, iter_imp=2, sampler="nuts",
                 n_samples=2000, sigma_proposals=None, **opts):
        super().__init__(model, prior, quantile_eps, **opts)
        self.name = "exp_int_var"
        self._integration = integration
        self._n_samples_imp = n_samples_imp
        self._iter_imp = iter_imp
        self._points = None          # integration nodes (host)
        self._weights = None         # omega_i * prior_i^2 (device)
        self._state = None           # (points, mean_p, var_p, kinv_kxp, phi_p)
        self._loss = None
        if integration == "importance":
            self.density_is = RandMaxVar(model=model, prior=prior,
                                         n_inits=self.n_inits,
                                         seed=self.seed,
                                         quantile_eps=quantile_eps,
                                         sampler=sampler,
                                         n_samples=n_samples,
                                         sigma_proposals=sigma_proposals)
        elif integration == "grid":
            axes = [np.arange(lo, hi, d_grid) for lo, hi in self.model.bounds]
            mesh = np.meshgrid(*axes, indexing="ij")
            self._points = np.stack([m.ravel() for m in mesh], axis=1)
        else:
            raise ValueError("Unknown integration method")

    def _build_loss(self):
        if self._loss is not None:
            return self._loss
        prior_logpdf = self.prior.traceable_logpdf()
        kernel = self.model.fns.cross_cov
        fmax = torch.finfo(torch.float32).max

        def loss(theta, Xp, mask, Kinv, alpha, params, eps, points, mean_p,
                 var_p, kinv_kxp, phi_p, weights):
            # the lookahead variance reduction at every integration node
            # from one observation at each row of theta
            with full_float32_matmul():
                kxt = kernel(theta, Xp, params) * mask
                prior_var = kernel(theta[:, None, :], theta[:, None, :],
                                   params)[:, 0, 0]
                var_new = torch.clamp(
                    prior_var - torch.sum((kxt @ Kinv) * kxt, dim=-1),
                    min=1e-10)
                cov = kernel(theta, points, params) - kxt @ kinv_kxp
            shrink = cov ** 2 / (params["noise"] + var_new[:, None])
            total = params["noise"] + var_p
            shape = torch.sqrt(torch.clamp(total - shrink, min=0.0)
                               / (total + shrink))
            phi_look = special.skewnorm_cdf(eps, shape, loc=mean_p,
                                            scale=torch.sqrt(total))
            # E[Var after], integrated: sum_i omega_i prior_i^2 (Phi - look)
            out = torch.sum(weights * (phi_p - phi_look), dim=-1)
            return torch.where(torch.isfinite(prior_logpdf(theta)), out, fmax)

        self._loss = loss
        return loss

    def _refresh_state(self, t):
        self._update_eps()
        refresh_points = self._integration == "importance" and (
            self._points is None or t is None or t % self._iter_imp == 0)
        if refresh_points:
            self._points = np.asarray(
                self.density_is.acquire(self._n_samples_imp))
        points = self._rows(self._points)
        args = self._gp_args()
        with torch.no_grad():
            state = _lookahead_state_fn(self.model.fns)(*args, points)
            if refresh_points or self._weights is None:
                prior2 = torch.exp(2.0 * self.prior.traceable_logpdf()(points))
                if self._integration == "importance":
                    # self-normalised importance weights from the MaxVar
                    # density
                    dens = self._build_fns()["value"](points, *args)
                    omega = 1.0 / torch.clamp(dens, min=1e-32)
                    omega = omega / torch.sum(omega)
                else:
                    omega = 1.0 / points.shape[0]
                self._weights = omega * prior2
        self._state = (points,) + tuple(state)

    def _loss_args(self):
        return self._gp_args() + self._state + (self._weights,)

    def acquire(self, n, t=None):
        self._refresh_state(t)
        if self.constraints is not None:
            # the constrained host path; this rule minimises the loss
            theta_min, _ = minimize(
                lambda x: self.evaluate(x, t), self.model.bounds,
                method="SLSQP", constraints=self.constraints,
                grad=lambda x: self.evaluate_gradient(x, t),
                prior=self.prior, n_start_points=self.n_inits,
                maxiter=self.max_opt_iters,
                random_state=self.random_state)
            return self._add_noise(np.tile(np.asarray(theta_min, np.float64),
                                           (n, 1)))
        self._acq_count += 1
        theta_min, _ = minimize_traced(
            self._build_loss(), self.model.bounds, args=self._loss_args(),
            n_starts=self.n_inits, steps=min(self.max_opt_iters, 200),
            seed=fold_in(self.seed, self._acq_count))
        return self._add_noise(np.tile(np.asarray(theta_min, np.float64),
                                       (n, 1)))

    def evaluate(self, theta_new, t=None):
        """The expected integrated loss at each row of theta_new, (n,)."""
        if self._state is None:
            self._refresh_state(t)
        with torch.no_grad():
            vals = self._build_loss()(self._rows(theta_new),
                                      *self._loss_args())
        return vals.cpu().numpy()

    def evaluate_gradient(self, theta_new, t=None):
        """Autograd gradient of the lookahead loss, (n, d); non-finite
        entries are 0."""
        if self._state is None:
            self._refresh_state(t)
        args = self._loss_args()
        loss = self._build_loss()
        _, g = value_and_grad(lambda th: loss(th, *args),
                              self._rows(theta_new))
        g = g.cpu().numpy()
        return np.where(np.isfinite(g), g, 0.0)


class UniformAcquisition(AcquisitionBase):
    """Uniform random acquisition (reference ``acquisition.py:824-845``)."""

    def acquire(self, n, t=None):
        bounds = np.stack(self.model.bounds)
        return self.random_state.uniform(bounds[:, 0], bounds[:, 1],
                                         size=(n, self.model.input_dim))
