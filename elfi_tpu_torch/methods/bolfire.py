"""BOLFIRE: Bayesian Optimization and classification for Likelihood-Free
Inference by Ratio Estimation (counterpart of
:mod:`elfi_tpu.methods.bolfire`; reference
``elfi/methods/inference/bolfire.py``).

Per round: simulate ``n_training_data`` feature rows at the acquired
theta, fit the classifier of the likelihood rows against the marginal rows,
and feed the negative log-ratio at the observed features to the GP
surrogate.  Two fits:

- the host loop (:meth:`BOLFIRE.fit` with ``fused=False``, through
  :meth:`ModelBased.infer`): a round of batches at each acquired point, the
  classifier fitted on the device and read back, the GP updated on the
  host;
- the fused fit (:meth:`BOLFIRE._fused_fit`): BOLFI's segmented loop with
  the simulation of the discrepancy replaced by a classifier round.  The
  initial rounds are one batched logistic regression; each acquisition
  then selects theta (BOLFI's selector, plus the ``-log prior`` cost for a
  prior that is not the bounds box), simulates the round's features and
  fits the classifier, all queued on the device.  The per-round
  coefficients stay on the device and are read once, with the evidence,
  after the last segment.

Streams: the JAX package's integers are folded into the seed on the host
(:func:`~elfi_tpu_torch.utils.rng.fold_in`) and each seeds a
``torch.Generator``: the initial thetas of a box prior at ``fold_in(seed,
0x1B01F1)`` (else the prior program's batch 0), the features of initial
round i in the model's batch i and of acquisition t in batch
``n_initial_evidence + t``; selection, acquisition noise and the GP's
restarts as BOLFI's fused fit draws them.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from ..compile.compiler import compile_program
from ..model.extensions import ModelPrior
from ..parallel.backends import NativeBackend
from ..utils.rng import fold_in, generator
from . import mcmc
from .base import ModelBased
from .bo.acquisition import LCBSC, AcquisitionBase
from .bo.gp import GPRegression, _pad_cap
from .bo.utils import CostFunction
from .bolfi import (_LOOP_SALT, _install_fused_gp, _make_gp_loop_fns,
                    _make_theta_selector, refit_schedule)
from .classifier import (LOGREG_NEWTON, Classifier, LogisticRegression,
                         logreg_fit_core)
from .posteriors import BolfirePosterior
from .results import BolfireSample
from .utils import batch_to_arr2d, resolve_sigmas

logger = logging.getLogger(__name__)

__all__ = ["BOLFIRE"]

#: folded into the seed to key the initial thetas of a box prior (the JAX
#: package's constant)
_INIT_SALT = 0x1B01F1
#: the prior cost outside the support (float32)
_COST_CAP = 1e30


class _FusedBolfireSpec(NamedTuple):
    """The configuration of one fused BOLFIRE fit."""
    cap: int
    d: int
    n_init: int
    n_restarts: int
    n_inits_acq: int
    rng_off: int
    pnames: tuple
    feat_names: tuple
    lo: tuple
    hi: tuple
    noise_std: tuple | None
    gp_scales: tuple
    epsilon: float
    n_train: int


def _prior_cost_fn(prior):
    """``-log prior`` of rows ``theta`` (n, d) -> (n,) for the fused
    acquisition objective of a prior that is not the bounds box.  As the
    host path's ``ModelPrior.gradient_logpdf``: outside the support the
    value is 1e30 and the gradient 0, since a -inf log prior would give the
    Adam descent NaN gradients."""
    lp = prior.traceable_logpdf()

    class _PriorCost(torch.autograd.Function):
        @staticmethod
        def forward(ctx, theta):
            ctx.save_for_backward(theta)
            c = -lp(theta)
            return torch.where(torch.isfinite(c), c, _COST_CAP)

        @staticmethod
        def backward(ctx, ct):
            theta, = ctx.saved_tensors
            with torch.enable_grad():
                x = theta.detach().requires_grad_(True)
                c = -lp(x)
                g = None
                if c.requires_grad:
                    g, = torch.autograd.grad(c, x, ct, allow_unused=True)
            if g is None:
                return torch.zeros_like(theta)
            return torch.where(torch.isfinite(g), g, 0.0)

    return _PriorCost.apply


class _FusedBolfirePrograms(NamedTuple):
    """The functions of one fused BOLFIRE fit."""
    features_at: object
    neg_log_ratio: object
    select: object
    u_to_params: object
    init_run: object
    step: object
    refit_run: object


def _fused_bolfire_programs(spec, feat_fn, prior_fn=None, cost_fn=None,
                            device=None):
    """The functions of one fused BOLFIRE fit, built per fit; none of them
    reads anything back from ``device``.

    ``features_at(seed, idx, theta)``: the round's feature rows, the
    model's batch ``idx`` at ``theta``.  ``neg_log_ratio(feats, marginal,
    obs)``: the classifier rounds of ``feats`` (..., n_train, f) as one
    batched logistic regression; ``(-log-ratio at obs, w, b, mu, sd)``.
    ``init_run(seed, marginal, obs)``: the initial thetas (uniform box
    draws when ``prior_fn`` is None, else one batch of the prior program),
    their rounds, then the GP's initial fit; returns ``(Xc, yc, u, shapes,
    coefs)``.  ``step(seed, Xc, yc, n, params, t, beta, marginal, obs)``:
    one acquisition (BOLFI's ``select``, with ``cost_fn`` added to its
    objective when given) and its round in the model's batch ``n_init +
    t``, written into row ``n`` of ``Xc``/``yc``; returns the round's
    ``(w, b, mu, sd)``.  ``refit_run`` is BOLFI's scheduled refit."""
    cap, d, n_init, n_train = spec.cap, spec.d, spec.n_init, spec.n_train
    pnames, feat_names = spec.pnames, spec.feat_names
    lo = torch.as_tensor(np.asarray(spec.lo, np.float32), device=device)
    hi = torch.as_tensor(np.asarray(spec.hi, np.float32), device=device)
    _, u_to_params, init_gp_fit, refit_run = _make_gp_loop_fns(
        (cap, n_init, spec.n_restarts, spec.rng_off, spec.gp_scales),
        device=device)
    select = _make_theta_selector(
        (cap, d, spec.n_inits_acq, spec.rng_off, spec.lo, spec.hi,
         spec.noise_std, float(spec.epsilon)), cost_fn, device=device)

    def features_at(seed, idx, theta):
        out = feat_fn(seed, idx, {p: theta[j] for j, p in enumerate(pnames)})
        return torch.cat([out[nm].reshape(n_train, -1) for nm in feat_names],
                         dim=1).to(torch.float32)

    def neg_log_ratio(feats, marginal, obs):
        # classifier rounds of likelihood rows (+1) against the marginal
        # rows (-1), batched over feats' leading dimensions; the negative
        # log-ratio at the observed features (reference bolfire.py:126-144)
        X = torch.cat([feats, marginal.expand(feats.shape[:-2]
                                              + marginal.shape)], dim=-2)
        y = torch.cat([torch.ones(n_train, device=device),
                       -torch.ones(marginal.shape[0], device=device)])
        w, b, mu, sd = logreg_fit_core(X, y.expand(X.shape[:-1]),
                                       n_newton=LOGREG_NEWTON)
        z = torch.sum((obs[0] - mu) / sd * w, dim=-1) + b
        return -z, w, b, mu, sd

    def init_run(seed, marginal, obs):
        if prior_fn is None:
            u = torch.rand((n_init, d), device=device, generator=generator(
                fold_in(seed, _INIT_SALT), device))
            theta0 = lo + (hi - lo) * u
        else:
            out0 = prior_fn(seed, 0, {})
            theta0 = torch.stack([out0[p].reshape(-1) for p in pnames],
                                 dim=1).to(torch.float32)
        feats = torch.stack([features_at(seed, i, theta0[i])
                             for i in range(n_init)])
        y0, *coefs = neg_log_ratio(feats, marginal, obs)
        Xc, yc, u, shapes = init_gp_fit(seed, theta0, y0)
        return Xc, yc, u, shapes, coefs

    def step(seed, Xc, yc, n, params, t, beta, marginal, obs):
        theta = select(fold_in(seed, _LOOP_SALT), Xc, yc, n, params, t, beta)
        y_new, *coefs = neg_log_ratio(features_at(seed, n_init + t, theta),
                                      marginal, obs)
        Xc[n] = theta
        yc[n] = y_new
        return coefs

    return _FusedBolfirePrograms(features_at, neg_log_ratio, select,
                                 u_to_params, init_run, step, refit_run)


class BOLFIRE(ModelBased):
    """BOLFIRE method (reference ``bolfire.py``)."""

    def __init__(self, model, n_training_data, feature_names=None,
                 marginal=None, seed_marginal=None, classifier=None,
                 bounds=None, n_initial_evidence=0, acq_noise_var=0,
                 exploration_rate=10, update_interval=1, target_model=None,
                 acquisition_method=None, **kwargs):
        super().__init__(model, n_training_data,
                         feature_names=feature_names, **kwargs)
        self._random_state = np.random.RandomState(self.seed)
        self.marginal = self._resolve_marginal(marginal, seed_marginal)
        self.classifier = self._resolve_classifier(classifier)
        self.bounds = bounds
        self.acq_noise_var = acq_noise_var
        self.exploration_rate = exploration_rate
        self.update_interval = update_interval
        self.target_model = self._resolve_target_model(target_model)
        self.prior = ModelPrior(self.model,
                                parameter_names=self.parameter_names,
                                device=self.device)
        self.n_initial_evidence = self._resolve_n_initial_evidence(
            n_initial_evidence)
        self.acquisition_method = self._resolve_acquisition_method(
            acquisition_method)
        self.state["n_evidence"] = 0
        self.state["last_GP_update"] = self.n_initial_evidence
        self.classifier_attributes = []
        self._init_round()

    @property
    def parameter_names(self):
        return self.target_model.parameter_names

    @property
    def n_evidence(self):
        return self.state["n_evidence"]

    def extract_result(self):
        return BolfirePosterior(self.parameter_names, self.target_model,
                                self.prior, self.classifier_attributes,
                                seed=self.seed)

    def predict_log_ratio(self, X, y, X_obs):
        """Train the classifier and evaluate log L/marginal at the observed
        features (reference ``bolfire.py:126-144``)."""
        self.classifier.fit(X, y)
        return self.classifier.predict_log_likelihood_ratio(X_obs)

    def fit(self, n_evidence, bar=True, fused=None):
        """Fit the surrogate.  ``fused=None`` takes the fused loop where it
        is eligible (:meth:`_fused_eligible`, and at least the initial
        evidence asked for); ``False`` runs the host loop, ``True`` asserts
        eligibility."""
        logger.info("BOLFIRE: Fitting the surrogate model...")
        if not (isinstance(n_evidence, int) and n_evidence > 0):
            raise TypeError("n_evidence must be a positive integer")
        if n_evidence < self.n_evidence:
            logger.warning("Requesting less evidence than already exists")
        if fused and self.pool is not None:
            raise ValueError("fused=True requires: no pool")
        # fewer rounds than the initial evidence: the host loop stops at
        # n_evidence, where the fused fit would run every initial round
        eligible = (n_evidence >= self.n_initial_evidence
                    and self._fused_eligible())
        if fused is None:
            fused = eligible
        elif fused and not eligible:
            raise ValueError("fused=True but this configuration is not "
                             "eligible for the fused BOLFIRE fit")
        if fused:
            self._fused_fit(n_evidence)
            return self.extract_result()
        return self.infer(n_evidence, bar=bar)

    def sample(self, n_samples, warmup=None, n_chains=4, initials=None,
               algorithm="nuts", sigma_proposals=None, n_evidence=None,
               bar=True, **kwargs):
        """Sample the BOLFIRE posterior, all chains as one batch on the
        device."""
        if self.state["n_batches"] == 0:
            self.fit(n_evidence, bar=bar)
        if algorithm not in ("nuts", "metropolis"):
            raise ValueError("The given algorithm is not supported")
        posterior = self.extract_result()
        warmup = warmup or n_samples // 2

        if initials is not None:
            initials = np.asarray(initials)
            if initials.shape != (n_chains, self.target_model.input_dim):
                raise ValueError(
                    "The shape of initials must be (n_chains, n_params)")
        else:
            # rank the evidence points by posterior logpdf: with sharp
            # surrogates the smallest-mean points can sit outside the prior
            # support or in deep posterior valleys
            candidates = np.asarray(self.target_model.X)
            lps = posterior.logpdf(candidates)
            ok = np.isfinite(lps)
            candidates, lps = candidates[ok], lps[ok]
            if len(candidates) < n_chains:
                raise ValueError("sample: cannot find enough acceptable "
                                 "initialization points")
            initials = candidates[np.argsort(-lps)][:n_chains]

        target, target_args = posterior.traceable_logpdf_args()
        if algorithm == "nuts":
            # the bounds widths as a diagonal NUTS mass matrix
            widths = np.asarray([hi - lo for lo, hi in
                                 self.target_model.bounds], np.float32)
            chains = mcmc.nuts_chains(n_samples, initials, target,
                                      n_adapt=warmup, seed=self.seed,
                                      target_args=target_args,
                                      scales=kwargs.pop("scales", widths),
                                      **kwargs)
        else:
            sigmas = resolve_sigmas(self.parameter_names, sigma_proposals,
                                    self.target_model.bounds)
            chains = mcmc.metropolis_chains(n_samples, initials, target,
                                            sigmas, warmup=0,
                                            seed=self.seed,
                                            target_args=target_args,
                                            **kwargs)
        logger.info("%d chains of %d iterations acquired", n_chains,
                    n_samples)
        return BolfireSample(method_name="BOLFIRE", chains=chains,
                             parameter_names=self.parameter_names,
                             warmup=warmup, n_sim=self.state["n_sim"],
                             seed=self.seed)

    # -- internals ---------------------------------------------------------
    def _resolve_marginal(self, marginal, seed_marginal=None):
        if marginal is None:
            if seed_marginal is None:
                # derived from the method seed, so a fit is deterministic
                # per seed; an offset stream of its own leaves the initial
                # evidence draws of _random_state unchanged
                seed_marginal = int(np.random.RandomState(
                    (self.seed + 0x9E3779B9) % 2**32).randint(2**31))
            batch = self.model.generate(self.n_sim_round,
                                        outputs=self.feature_names,
                                        seed=seed_marginal,
                                        device=self.device)
            marginal = batch_to_arr2d(batch, self.feature_names)
            logger.info("New marginal data (%d x %d) generated",
                        *marginal.shape)
            return marginal
        marginal = np.asarray(marginal)
        if marginal.ndim == 2:
            return marginal
        raise TypeError("marginal must be a 2d numpy array")

    def _resolve_classifier(self, classifier):
        if classifier is None:
            return LogisticRegression(device=self.device)
        if isinstance(classifier, Classifier):
            return classifier
        raise ValueError("classifier must be an instance of Classifier")

    def _resolve_n_initial_evidence(self, n):
        if isinstance(n, int) and n >= 0:
            return n
        raise ValueError("n_initial_evidence must be a non-negative integer")

    def _resolve_target_model(self, target_model):
        if target_model is None:
            return GPRegression(self.model.parameter_names, self.bounds,
                                device=self.device)
        if isinstance(target_model, GPRegression):
            return target_model
        raise TypeError("target_model must be a GPRegression")

    def _resolve_acquisition_method(self, acquisition_method):
        self._default_acquisition = acquisition_method is None
        if acquisition_method is None:
            # the additive -log prior cost (reference bolfire.py:333-346),
            # with its version on tensors for the device descent
            cost = CostFunction(self.prior.logpdf,
                                self.prior.gradient_logpdf, scale=-1,
                                traceable=self.prior.traceable_logpdf())
            return LCBSC(model=self.target_model, prior=self.prior,
                         noise_var=self.acq_noise_var,
                         exploration_rate=self.exploration_rate,
                         seed=self.seed, additive_cost=cost)
        if isinstance(acquisition_method, AcquisitionBase):
            return acquisition_method
        raise TypeError("acquisition_method must be an AcquisitionBase")

    @property
    def current_params(self):
        return self._current_params

    def _init_round(self):
        super()._init_round()
        if self.n_evidence < self.n_initial_evidence:
            self._current_params = self.prior.rvs(
                1, seed=int(self._random_state.randint(2**31)))
        else:
            t = self.n_evidence - self.n_initial_evidence
            self._current_params = self.acquisition_method.acquire(1, t)

    def _fused_eligible(self):
        """Whether :meth:`_fused_fit` can replace the host round loop: the
        native client, the default LCBSC and GP kernel, the default
        classifier, one batch per round, fresh state with initial evidence,
        and a prior and feature graph that run on the device.  A uniform
        prior box equal to the bounds takes the path without the prior cost
        (constant over the box); any other prior adds ``-log prior`` to the
        objective and draws the initial evidence from the prior program.
        A pool stores and replays batch by batch: the host loop."""
        clf = self.classifier
        acq = self.acquisition_method
        if not (self.pool is None
                and self.batch_size == self.n_sim_round
                and isinstance(self.client, NativeBackend)
                and type(acq) is LCBSC
                and acq.constraints is None
                and self._default_acquisition
                and type(clf) is LogisticRegression
                and clf.class_min == 0
                and not getattr(self.target_model, "custom_kernel", False)
                and self.state["n_evidence"] == 0
                and self.n_initial_evidence > 0):
            return False
        if self._fused_box() is None and compile_program(
                self.model, tuple(self.parameter_names),
                device=self.device).host:
            return False
        return not compile_program(
            self.model, tuple(self.feature_names),
            override_names=tuple(self.parameter_names),
            device=self.device).host

    def _fused_box(self):
        """The prior box when it is uniform and equal to the bounds (the
        fused path without the prior cost), else ``None``."""
        box = self.prior.box()
        if box is None:
            return None
        bounds = np.asarray(self.target_model.bounds, np.float64)
        if not (np.allclose(box[0], bounds[:, 0])
                and np.allclose(box[1], bounds[:, 1])):
            return None
        return box

    def _fused_fit(self, n_evidence):
        """The segmented fused fit (:func:`_fused_bolfire_programs`): the
        initial rounds and GP fit, then one segment of acquisitions per
        refit window, each followed by its refit; one copy to the host at
        the end (:meth:`_fused_segment` reads nothing)."""
        gp = self.target_model
        acq = self.acquisition_method
        dev = self.device
        d = gp.input_dim
        n_init = self.n_initial_evidence
        n_total = int(n_evidence)
        n_acq = n_total - n_init
        cap = _pad_cap(n_total)
        bounds = np.asarray(gp.bounds, np.float32)
        if acq.noise_var is not None:
            noise_std = tuple(np.sqrt(np.broadcast_to(np.asarray(
                acq.noise_var, np.float32), (d,))).tolist())
        else:
            noise_std = None
        betas = torch.as_tensor(np.asarray(
            [acq._beta(t) for t in range(max(n_acq, 1))], np.float32),
            device=dev)
        _, segments = refit_schedule(n_init, n_total, self.update_interval)

        feat_fn = compile_program(
            self.model, tuple(self.feature_names),
            override_names=tuple(self.parameter_names),
            device=dev).traceable(batch_size=self.n_sim_round)
        # bounds-scaled kernel distances, as GPRegression's
        gp_scales = np.asarray(1.0 / np.maximum(bounds[:, 1] - bounds[:, 0],
                                                1e-12), np.float32)
        spec = _FusedBolfireSpec(
            cap=cap, d=d, n_init=n_init, n_restarts=gp._n_restarts,
            n_inits_acq=acq.n_inits, rng_off=max(n_acq, 1000),
            pnames=tuple(self.parameter_names),
            feat_names=tuple(self.feature_names),
            lo=tuple(bounds[:, 0].tolist()), hi=tuple(bounds[:, 1].tolist()),
            noise_std=noise_std, gp_scales=tuple(gp_scales.tolist()),
            epsilon=float(getattr(acq, "epsilon", 0.0)),
            n_train=self.n_sim_round)
        if self._fused_box() is not None:
            prior_fn = cost_fn = None
        else:
            prior_fn = compile_program(
                self.model, tuple(self.parameter_names),
                device=dev).traceable(batch_size=n_init)
            cost_fn = _prior_cost_fn(self.prior)
        progs = _fused_bolfire_programs(spec, feat_fn, prior_fn, cost_fn,
                                        device=dev)

        seed = self.seed
        marginal = torch.as_tensor(self.marginal, dtype=torch.float32,
                                   device=dev)
        obs = torch.as_tensor(self.observed, dtype=torch.float32, device=dev)
        Xc, yc, u, shapes, coefs0 = progs.init_run(seed, marginal, obs)
        # each round's (w, b, mu, sd), kept on the device until the end
        coefs = [torch.zeros((n_total,) + c.shape[1:], device=dev)
                 for c in coefs0]
        for buf, c in zip(coefs, coefs0):
            buf[:n_init] = c
        n = n_init
        for seg_start, seg_len, do_refit in segments:
            n = self._fused_segment(progs, Xc, yc, u, n,
                                    range(seg_start, seg_start + seg_len),
                                    betas, marginal, obs, coefs)
            if do_refit:
                u = progs.refit_run(seed, Xc, yc, u, shapes, n,
                                    seg_start + seg_len - 1)
        # the one copy to the host
        parts = [Xc, yc, u] + coefs
        packed = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        Xf, yf, uf, W, B, MU, SD = np.split(
            packed, np.cumsum([p.numel() for p in parts])[:-1])
        W, MU, SD = (a.reshape(n_total, -1) for a in (W, MU, SD))

        _install_fused_gp(gp, Xf.reshape(cap, d), yf, uf, n_total, n_init,
                          gp_scales)
        # with the scaler's mean and scale, each round's attributes give
        # its log-ratio at a query point (the JAX package keeps only the
        # standardised coefficients)
        self.classifier_attributes = [
            {"parameters": {"coef_": [W[i].tolist()],
                            "intercept_": [float(B[i])],
                            "n_iter": [LOGREG_NEWTON],
                            "mean_": MU[i].tolist(),
                            "scale_": SD[i].tolist()}}
            for i in range(n_total)]
        self.state["n_evidence"] = n_total
        self.state["n_batches"] = n_total
        self.state["n_sim"] = n_total * self.n_sim_round
        # the evidence count at the last refit, as the host loop leaves it
        # (the JAX package sets n_total even when the last segment did not
        # refit, so a continued fit would refit late)
        refits = [n_init + start + length
                  for start, length, refit in segments if refit]
        self.state["last_GP_update"] = refits[-1] if refits else n_init
        self.state["round"] = n_total
        self.state["n_sim_round"] = 0
        self.objective["round"] = n_total
        self.objective["n_batches"] = n_total

    def _fused_segment(self, progs, Xc, yc, u, n, ts, betas, marginal, obs,
                       coefs):
        """Queue one segment of acquisitions: for each step ``t``, select a
        point and run its classifier round, written into row ``n`` of the
        evidence buffers and of the round coefficients ``coefs`` (in
        place).  Returns the new evidence count; reads nothing from the
        device."""
        seed = self.seed
        params = progs.u_to_params(u)
        for t in ts:
            for buf, c in zip(coefs, progs.step(seed, Xc, yc, n, params, t,
                                                betas[t], marginal, obs)):
                buf[n] = c
            n += 1
        return n

    def _process_simulated(self):
        """Classifier fit -> negative log-ratio -> GP update (reference
        ``bolfire.py:371-391``)."""
        X, y = self._generate_training_data(self.simulated, self.marginal)
        neg_log_ratio = -1 * self.predict_log_ratio(X, y, self.observed)
        self.classifier_attributes.append(self.classifier.attributes)
        self.state["n_evidence"] += 1
        optimize = self._should_optimize()
        self.target_model.update(self._current_params, neg_log_ratio,
                                 optimize)
        if optimize:
            self.state["last_GP_update"] = self.target_model.n_evidence

    @staticmethod
    def _generate_training_data(likelihood, marginal):
        X = np.vstack((likelihood, marginal))
        y = np.concatenate((np.ones(len(likelihood)),
                            -1 * np.ones(len(marginal))))
        return X, y

    def _should_optimize(self):
        current = self.target_model.n_evidence + 1
        next_update = self.state["last_GP_update"] + self.update_interval
        return current >= self.n_initial_evidence and current >= next_update
