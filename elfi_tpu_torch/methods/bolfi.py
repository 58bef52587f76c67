"""BayesianOptimization and BOLFI (counterpart of
:mod:`elfi_tpu.methods.bolfi`; reference
``elfi/methods/inference/bolfi.py``).

Two fits:

- the host loop (:meth:`BOLFI.fit` with ``fused=False``, through
  :meth:`ParameterInference.infer`): batches of the model at the acquired
  points, evidence and GP on the host, each acquisition one device descent;
- the fused fit (:meth:`BOLFI._fused_fit`): the JAX package's segmented
  loop -- an initial program (the initial evidence and the GP's MAP fit),
  one segment of acquisitions per refit window, and the scheduled refits --
  queued on the device from one host loop that reads nothing back until the
  fit ends.  An acquisition factors the GP, replays the captured Adam
  descent of the LCB objective from its uniform starts
  (:func:`~.bo.utils.descend`), takes the best, mixes in the epsilon-greedy
  uniform draw and the truncated-normal acquisition noise, and simulates
  the model at the acquired point.

Streams: the JAX package folds indices into ``key(seed)``; here the same
integers, from :func:`~elfi_tpu_torch.utils.rng.fold_in` on the host, seed
``torch.Generator`` streams on the device at the JAX package's offsets
(acquisition starts at ``off + t``, acquisition noise at ``2 off + t``,
refit restarts at ``3 off + t``, epsilon draws at ``4 off + t``, all folded
into ``fold_in(seed, 0x5EED)``, with ``off = max(n_acq, 1000)``), and the
simulation at the point acquired at step t is the model's batch ``t + 1``.
The fit therefore agrees with the JAX package's statistically.

Posterior sampling runs all chains as one batch on the device
(:func:`~.mcmc.nuts_chains`).
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from ..compile.compiler import compile_program
from ..model.extensions import ModelPrior
from ..ops.distributions import truncnorm
from ..parallel.backends import NativeBackend
from ..utils.rng import fold_in, generator
from . import mcmc
from .base import ParameterInference
from .bo.acquisition import LCBSC
from .bo.gp import GPRegression, _pad_cap, make_gp_fns, rbf_bias_kernel
from .bo.utils import descend, minimize_traced, stochastic_optimization
from .posteriors import BolfiPosterior
from .results import BolfiSample, OptimizationResult
from .utils import (arr2d_to_batch, batch_to_arr2d, ceil_to_batch_size,
                    resolve_sigmas)

logger = logging.getLogger(__name__)

__all__ = ["BayesianOptimization", "BOLFI"]

#: folded into the seed to key the fused loop's own draws (the JAX
#: package's constant)
_LOOP_SALT = 0x5EED


def refit_schedule(n_init, n_evidence, update_interval):
    """Which acquisitions ``t`` of a fused fit end with a hyperparameter
    refit (reference ``bolfi.py:289-293``: when the count crosses
    ``n_init`` and every ``update_interval`` points after), and the
    segments ``(start, length, refit)`` they cut the fit into."""
    n_acq = n_evidence - n_init
    refit = np.zeros(max(n_acq, 1), bool)
    last = n_init
    for t in range(n_acq):
        cur = n_init + t + 1
        if cur >= n_init and cur >= last + update_interval:
            refit[t] = True
            last = cur
    segments, start = [], 0
    for t in range(n_acq):
        if refit[t]:
            segments.append((start, t + 1 - start, True))
            start = t + 1
    if start < n_acq:
        segments.append((start, n_acq - start, False))
    return refit, segments


def _make_theta_selector(sel_spec, cost_fn=None, device=None):
    """Theta selection of one fused LCBSC acquisition: masked GP factor ->
    batched Adam LCB descent -> epsilon-greedy uniform anchor ->
    truncated-normal acquisition noise.

    ``sel_spec = (cap, d, n_inits_acq, rng_off, lo, hi, noise_std,
    epsilon)`` with lo/hi/noise_std float tuples (noise_std ``None``: no
    acquisition noise).  ``cost_fn`` (rows (n, d) -> (n,), optional) is
    added to the LCB objective: BOLFIRE's ``-log prior`` cost for a prior
    that is not the bounds box.  Returns ``select(rseed, Xc, yc, n, params,
    t, beta)`` with the evidence count ``n`` and the step ``t`` host
    integers; it queues its work on ``device`` and reads nothing back."""
    cap, d, n_inits_acq, rng_off, lo_t, hi_t, noise_std_t, eps = sel_spec
    eps = float(eps)
    fns = make_gp_fns(rbf_bias_kernel)
    if cost_fn is None:
        objective = fns.neg_lcb_obj_inv
    else:
        def objective(theta, *args):
            return fns.neg_lcb_obj_inv(theta, *args) + cost_fn(theta)
    lo_np = np.asarray(lo_t, np.float32)
    hi_np = np.asarray(hi_t, np.float32)
    lo = torch.as_tensor(lo_np, device=device)
    hi = torch.as_tensor(hi_np, device=device)
    lr = float(np.max(hi_np - lo_np) / np.float32(10.0))
    slots = torch.arange(cap, device=device)
    if noise_std_t is not None:
        noise_std = torch.as_tensor(np.asarray(noise_std_t, np.float32),
                                    device=device)
        safe = torch.where(noise_std > 0, noise_std, 1.0)

    def select(rseed, Xc, yc, n, params, t, beta):
        # the masked K^-1 once per step, so that each evaluation of the
        # descent is a matmul instead of a cap-deep triangular solve
        mask = (slots < n).to(torch.float32)
        L, alpha = fns.posterior_factor(Xc, yc, mask, params)
        Kinv = fns.posterior_inverse(L, mask)
        u = torch.rand((n_inits_acq, d), device=device,
                       generator=generator(fold_in(rseed, rng_off + t),
                                           device))
        starts = lo + (hi - lo) * u
        xs, fs = descend(objective, starts, 150, lr, lo, hi,
                         (Xc, mask, Kinv, alpha, params, beta))
        best = torch.argmin(torch.where(torch.isfinite(fs), fs, math.inf))
        theta = xs.index_select(0, best.reshape(1))[0]
        if eps > 0.0:
            kexp = fold_in(rseed, 4 * rng_off + t)
            coin = torch.rand((), device=device,
                              generator=generator(fold_in(kexp, 0), device))
            unif = lo + (hi - lo) * torch.rand(
                (d,), device=device,
                generator=generator(fold_in(kexp, 1), device))
            theta = torch.where(coin < eps, unif, theta)
        if noise_std_t is not None:
            # dimensions with no noise pass theta through, as the host
            # path's _add_noise skips them; with std 0 the bounds would be
            # 0/0 wherever the minimizer sits on a bound
            prop = truncnorm.rvs(
                (lo - theta) / safe, (hi - theta) / safe, loc=theta,
                scale=safe, size=(d,),
                generator=generator(fold_in(rseed, 2 * rng_off + t), device))
            theta = torch.where(noise_std > 0, prop, theta)
        return theta

    return select


def _install_fused_gp(gp, Xf, yf, uf, n_total, n_init, gp_scales):
    """Install a fused fit's results (evidence and MAP log hyperparameters,
    as numpy) into the host :class:`~.bo.gp.GPRegression`, as the host loop
    would have left it."""
    gp._x = np.asarray(Xf[:n_total], np.float64)
    gp._y = np.asarray(yf[:n_total], np.float64)
    vals = np.exp(np.asarray(uf, np.float64))
    gp.params = dict(zip(("sigma2", "ell", "bias", "noise"),
                         vals.tolist()))
    gp.params["scales"] = np.asarray(gp_scales)
    y0 = gp._y[:n_init]
    gp._prior_shapes = np.array([
        (np.max(np.abs(y0)) / 3.0) ** 2 + 1e-6,
        1.0 / 3.0,
        (np.max(np.abs(y0)) / 3.0) ** 2 / 4.0 + 1e-6, 0.0])
    gp._refactor()


def _make_gp_loop_fns(gp_spec, device=None):
    """GP-surrogate management of a fused BO loop: the hyperparameter
    heuristics, the initial MAP fit and the scheduled warm refit.

    ``gp_spec = (cap, n_init, n_restarts, rng_off, gp_scales)`` with
    ``gp_scales`` a float tuple.  Returns ``(heuristic_params, u_to_params,
    init_gp_fit, refit_run)``; none of them reads anything back from
    ``device``."""
    cap, n_init, n_restarts, rng_off, gp_scales_t = gp_spec
    fns = make_gp_fns(rbf_bias_kernel)
    gp_scales = torch.as_tensor(np.asarray(gp_scales_t, np.float32),
                                device=device)
    slots = torch.arange(cap, device=device)
    lr = torch.tensor(0.1, device=device)
    third = torch.tensor(1.0 / 3.0, device=device)
    zero = torch.tensor(0.0, device=device)

    def heuristic_params(y):
        # initial log-hyperparameters and Gamma prior shapes from the
        # initial evidence (GPRegression._init_hyperparams)
        kv = (torch.max(torch.abs(y)) / 3.0) ** 2 + 1e-6
        bv = kv / 4.0 + 1e-6
        nv = torch.clamp(torch.max(y) ** 2 / 100.0, min=1e-6)
        u0 = torch.log(torch.stack([kv, third, bv, nv]))
        shapes = torch.stack([kv, third, bv, zero])
        return u0, shapes

    def u_to_params(u):
        v = torch.exp(u)
        return {"sigma2": v[0], "ell": v[1], "bias": v[2], "noise": v[3],
                "scales": gp_scales}

    def init_gp_fit(master, X0, y0):
        d = X0.shape[1]
        Xp = torch.zeros((cap, d), device=device)
        Xp[:n_init] = X0
        yp = torch.zeros((cap,), device=device)
        yp[:n_init] = y0
        mask0 = (slots < n_init).to(torch.float32)
        u0, shapes = heuristic_params(y0)
        rseed = fold_in(master, _LOOP_SALT)
        z = torch.randn((n_restarts, 4), device=device,
                        generator=generator(fold_in(rseed, 0), device))
        starts0 = u0 + 0.5 * z
        starts0[0] = u0
        u0, _ = fns.optimize_restarts_core(
            starts0, Xp, yp, mask0, shapes, lr,
            const_params={"scales": gp_scales})
        return Xp, yp, u0, shapes

    def refit_run(master, Xc, yc, u, shapes, n, t):
        rseed = fold_in(master, _LOOP_SALT)
        mask = (slots < n).to(torch.float32)
        z = torch.randn((n_restarts, 4), device=device, generator=generator(
            fold_in(rseed, 3 * rng_off + t), device))
        st = u + 0.5 * z
        st[0] = u
        # warm-started from the current hyperparameters (the first restart
        # is u), so 120 steps do where the initial fit takes 250
        u_new, _ = fns.optimize_restarts_core(
            st, Xc, yc, mask, shapes, lr, steps=120,
            const_params={"scales": gp_scales})
        return u_new

    return heuristic_params, u_to_params, init_gp_fit, refit_run


class BayesianOptimization(ParameterInference):
    """GP-surrogate optimization of the target node (reference
    ``bolfi.py:26-397``)."""

    def __init__(self, model, target_name=None, bounds=None,
                 initial_evidence=None, update_interval=10, target_model=None,
                 acquisition_method=None, acq_noise_var=0, acq_epsilon=0.0,
                 exploration_rate=10, batch_size=1,
                 batches_per_acquisition=None, async_acq=False, **kwargs):
        model, target_name = self._resolve_model(model, target_name)
        output_names = [target_name] + model.parameter_names
        super().__init__(model, output_names, batch_size=batch_size, **kwargs)

        target_model = target_model or GPRegression(
            self.model.parameter_names, bounds=bounds, device=self.device)
        self.target_name = target_name
        self.target_model = target_model

        n_precomputed = 0
        n_initial, precomputed = self._resolve_initial_evidence(
            initial_evidence)
        if precomputed is not None:
            params = batch_to_arr2d(precomputed,
                                    self.target_model.parameter_names)
            n_precomputed = len(params)
            self.target_model.update(params, precomputed[target_name])

        self.batches_per_acquisition = batches_per_acquisition or \
            self.max_parallel_batches
        prior = ModelPrior(self.model,
                           parameter_names=self.target_model.parameter_names,
                           device=self.device)
        self.acquisition_method = acquisition_method or LCBSC(
            self.target_model, prior=prior, noise_var=acq_noise_var,
            epsilon=acq_epsilon,
            exploration_rate=exploration_rate, seed=self.seed)

        self.n_initial_evidence = n_initial
        self.n_precomputed_evidence = n_precomputed
        self.update_interval = update_interval
        self.async_acq = async_acq
        self.state["n_evidence"] = self.n_precomputed_evidence
        self.state["last_GP_update"] = self.n_initial_evidence
        self.state["acquisition"] = []

    def _resolve_initial_evidence(self, initial_evidence):
        precomputed = None
        n_required = max(10, 2 ** self.target_model.input_dim + 1)
        n_required = ceil_to_batch_size(n_required, self.batch_size)
        if initial_evidence is None:
            n_initial_evidence = n_required
        elif np.isscalar(initial_evidence):
            n_initial_evidence = int(initial_evidence)
        else:
            precomputed = initial_evidence
            n_initial_evidence = len(precomputed[self.target_name])
        if n_initial_evidence < 0:
            raise ValueError("Number of initial evidence must be >= 0")
        if n_initial_evidence < n_required:
            logger.warning("We recommend at least %d initialization points "
                           "(now %d)", n_required, n_initial_evidence)
        if precomputed is None and n_initial_evidence % self.batch_size:
            n_initial_evidence = ceil_to_batch_size(n_initial_evidence,
                                                    self.batch_size)
        return n_initial_evidence, precomputed

    @property
    def n_evidence(self):
        return self.state.get("n_evidence", 0)

    @property
    def acq_batch_size(self):
        return self.batch_size * self.batches_per_acquisition

    def set_objective(self, n_evidence=None):
        if n_evidence is None:
            n_evidence = self.objective.get("n_evidence", self.n_evidence)
        if n_evidence < self.n_evidence:
            logger.warning("Requesting less evidence than already exists")
        self.objective["n_evidence"] = n_evidence
        self.objective["n_sim"] = n_evidence - self.n_precomputed_evidence

    def extract_result(self):
        gp = self.target_model
        if getattr(gp, "_factor", None) is not None:
            Xp, mask, L, alpha, params = gp._factor
            x_min, _ = minimize_traced(gp.fns.mean_obj, gp.bounds,
                                       args=(Xp, mask, L, alpha, params),
                                       n_starts=20, steps=200,
                                       seed=self.seed)
        else:
            x_min, _ = stochastic_optimization(gp.predict_mean, gp.bounds,
                                               seed=self.seed)
        batch_min = arr2d_to_batch(np.asarray(x_min)[None],
                                   gp.parameter_names)
        outputs = arr2d_to_batch(gp.X, gp.parameter_names)
        outputs[self.target_name] = gp.Y
        return OptimizationResult(x_min=batch_min, outputs=outputs,
                                  **self._extract_result_kwargs())

    def update(self, batch, batch_index):
        super().update(batch, batch_index)
        self.state["n_evidence"] += self.batch_size
        batch = {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                 else np.asarray(v) for k, v in batch.items()}
        params = batch_to_arr2d(batch, self.target_model.parameter_names)
        optimize = self._should_optimize()
        self.target_model.update(params, batch[self.target_name], optimize)
        if optimize:
            self.state["last_GP_update"] = self.target_model.n_evidence

    def prepare_new_batch(self, batch_index):
        t = self._get_acquisition_index(batch_index)
        if t < 0:
            return None  # initial evidence from the prior
        acquisition = self.state["acquisition"]
        if len(acquisition) == 0:
            acquisition = self.acquisition_method.acquire(
                self.acq_batch_size, t=t)
        batch = arr2d_to_batch(acquisition[:self.batch_size],
                               self.target_model.parameter_names)
        self.state["acquisition"] = acquisition[self.batch_size:]
        return batch

    def _get_acquisition_index(self, batch_index):
        acq_batch_size = self.batch_size * self.batches_per_acquisition
        initial_offset = self.n_initial_evidence - self.n_precomputed_evidence
        starting_sim_index = self.batch_size * batch_index
        return (starting_sim_index - initial_offset) // acq_batch_size

    def _allow_submit(self, batch_index):
        if not super()._allow_submit(batch_index):
            return False
        if self.async_acq:
            return True
        t = self._get_acquisition_index(batch_index)
        if t < 0:
            return True
        # synchronous acquisition: wait for the pending evidence first
        if len(self.state["acquisition"]) == 0 and self.batches.has_pending:
            return False
        return True

    def _should_optimize(self):
        current = self.target_model.n_evidence + self.batch_size
        next_update = self.state["last_GP_update"] + self.update_interval
        return current >= self.n_initial_evidence and current >= next_update

    def plot_state(self, **options):
        """Live view: in 2-D the GP mean's contour with the acquired points,
        the newest in red; else
        :func:`~elfi_tpu_torch.visualization.plot_gp`."""
        gp = self.target_model
        if gp.input_dim == 2 and gp.n_evidence > 0:
            from ..visualization import draw_contour
            return draw_contour(
                lambda g: gp.predict(g)[0].ravel(), gp.bounds,
                parameter_names=gp.parameter_names,
                title="GP posterior mean", points=gp.X, **options)
        from ..visualization import plot_gp
        return plot_gp(gp, gp.parameter_names)

    def plot_discrepancy(self, axes=None, **kwargs):
        from ..visualization import plot_discrepancy
        return plot_discrepancy(self.target_model,
                                self.target_model.parameter_names,
                                axes=axes, **kwargs)

    def plot_gp(self, axes=None, resol=50, const=None, bounds=None,
                true_params=None, **kwargs):
        from ..visualization import plot_gp
        return plot_gp(self.target_model,
                       self.target_model.parameter_names, axes, resol,
                       const, bounds, true_params, **kwargs)


class BOLFI(BayesianOptimization):
    """Bayesian Optimization for Likelihood-Free Inference (Gutmann &
    Corander 2016; reference ``bolfi.py:400-598``)."""

    def fit(self, n_evidence, threshold=None, bar=True, fused=None,
            vis=None):
        """Fit the GP surrogate to the discrepancy, then extract the
        posterior (reference ``bolfi.py:417-440``).

        ``fused`` (default: where eligible and no ``vis``) runs the whole BO
        loop queued on the device (:meth:`_fused_fit`); ``fused=False``
        runs the host loop, which ``vis`` (live plots) needs."""
        logger.info("BOLFI: Fitting the surrogate model...")
        if n_evidence is None:
            raise ValueError("n_evidence must be specified")
        if fused and self.pool is not None:
            raise ValueError("fused=True requires: no pool")
        if fused is None:
            fused = self._fused_eligible() and vis is None
        if fused:
            self._fused_fit(n_evidence)
        else:
            self.infer(n_evidence, bar=bar, vis=vis)
        return self.extract_posterior(threshold)

    def _fused_eligible(self):
        prog = compile_program(self.model, (self.target_name,),
                               override_names=tuple(self.parameter_names),
                               device=self.device)
        acq = self.acquisition_method
        return (self.pool is None
                and self.batch_size == 1
                and self.n_precomputed_evidence == 0
                and isinstance(self.client, NativeBackend)
                and type(acq) is LCBSC
                and acq.additive_cost is None
                and acq.constraints is None
                and not prog.host
                # the fused loop holds the RBF + bias heuristics; custom
                # kernels go through the host loop
                and not getattr(self.target_model, "custom_kernel", False)
                and self.state["n_evidence"] == 0)

    def _fused_fit(self, n_evidence):
        """The segmented fused BO loop: the initial fit, then one segment of
        acquisitions per refit window, each followed by its refit; one copy
        to the host at the end (:meth:`_fused_segment` reads nothing)."""
        gp = self.target_model
        acq = self.acquisition_method
        dev = self.device
        d = gp.input_dim
        n_init = self.n_initial_evidence
        n_total = int(n_evidence)
        n_acq = n_total - n_init
        cap = _pad_cap(n_total)
        rng_off = max(n_acq, 1000)
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

        init_fn = compile_program(
            self.model, (self.target_name,) + tuple(self.parameter_names),
            device=dev).traceable(batch_size=n_init)
        sim_fn = compile_program(
            self.model, (self.target_name,),
            override_names=tuple(self.parameter_names),
            device=dev).traceable(batch_size=1)
        # bounds-scaled kernel distances, as GPRegression's
        gp_scales = np.asarray(1.0 / np.maximum(bounds[:, 1] - bounds[:, 0],
                                                1e-12), np.float32)
        _, u_to_params, init_gp_fit, refit_run = _make_gp_loop_fns(
            (cap, n_init, gp._n_restarts, rng_off,
             tuple(gp_scales.tolist())), device=dev)
        select = _make_theta_selector(
            (cap, d, acq.n_inits, rng_off, tuple(bounds[:, 0].tolist()),
             tuple(bounds[:, 1].tolist()), noise_std,
             float(getattr(acq, "epsilon", 0.0))), device=dev)

        seed = self.seed
        out = init_fn(seed, 0, {})
        y0 = out[self.target_name].reshape(-1).to(torch.float32)
        X0 = torch.stack([out[p].reshape(-1) for p in self.parameter_names],
                         dim=1).to(torch.float32)
        Xc, yc, u, shapes = init_gp_fit(seed, X0, y0)
        n = n_init
        for seg_start, seg_len, do_refit in segments:
            n = self._fused_segment(select, sim_fn, u_to_params, Xc, yc, u,
                                    n, range(seg_start, seg_start + seg_len),
                                    betas)
            if do_refit:
                u = refit_run(seed, Xc, yc, u, shapes, n,
                              seg_start + seg_len - 1)
        # the one copy to the host
        packed = torch.cat([Xc.reshape(-1), yc, u]).cpu().numpy()
        Xf = packed[:cap * d].reshape(cap, d)
        yf = packed[cap * d:cap * d + cap]
        uf = packed[cap * d + cap:]

        _install_fused_gp(gp, Xf, yf, uf, n_total, n_init, gp_scales)
        self.state["n_evidence"] = n_total
        self.state["n_batches"] = n_total
        self.state["n_sim"] = n_total
        # the evidence count at the last refit, as the host loop leaves it
        # (the JAX package sets n_total even when the last segment did not
        # refit, so a continued fit would refit late)
        refits = [n_init + start + length
                  for start, length, refit in segments if refit]
        self.state["last_GP_update"] = refits[-1] if refits else n_init
        self.objective["n_evidence"] = n_total
        self.objective["n_sim"] = n_total

    def _fused_segment(self, select, sim_fn, u_to_params, Xc, yc, u, n, ts,
                       betas):
        """Queue one segment of acquisitions: for each step ``t``, select a
        point, simulate the model's batch ``t + 1`` there and write both
        into row ``n`` of the evidence buffers ``Xc``/``yc`` (in place).
        Returns the new evidence count; reads nothing from the device."""
        seed = self.seed
        rseed = fold_in(seed, _LOOP_SALT)
        params = u_to_params(u)
        pnames = self.parameter_names
        for t in ts:
            theta = select(rseed, Xc, yc, n, params, t, betas[t])
            overrides = {p: theta[i:i + 1] for i, p in enumerate(pnames)}
            y_new = sim_fn(seed, t + 1, overrides)[self.target_name]
            Xc[n] = theta
            yc[n] = y_new.reshape(())
            n += 1
        return n

    def extract_posterior(self, threshold=None):
        if self.state["n_evidence"] == 0:
            raise ValueError("Model is not fitted yet; see fit()")
        prior = ModelPrior(self.model,
                           parameter_names=self.target_model.parameter_names,
                           device=self.device)
        return BolfiPosterior(self.target_model, threshold=threshold,
                              prior=prior, seed=self.seed)

    def sample(self, n_samples, warmup=None, n_chains=4, threshold=None,
               initials=None, algorithm="nuts", sigma_proposals=None,
               n_evidence=None, bar=True, **kwargs):
        """Sample the BOLFI posterior, all chains as one batch on the
        device."""
        if self.state["n_batches"] == 0:
            self.fit(n_evidence)
        if algorithm not in ("nuts", "metropolis"):
            raise ValueError("Unknown posterior sampler")
        posterior = self.extract_posterior(threshold)
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
            # the bounds widths as a diagonal NUTS mass matrix: one step
            # size must serve every parameter
            widths = np.asarray([hi - lo for lo, hi in
                                 self.target_model.bounds], np.float32)
            chains = mcmc.nuts_chains(n_samples, initials, target,
                                      n_adapt=warmup, seed=self.seed,
                                      target_args=target_args,
                                      scales=kwargs.pop("scales", widths),
                                      **kwargs)
        else:
            sigmas = resolve_sigmas(self.target_model.parameter_names,
                                    sigma_proposals,
                                    self.target_model.bounds)
            chains = mcmc.metropolis_chains(n_samples, initials, target,
                                            sigmas, warmup=0,
                                            seed=self.seed,
                                            target_args=target_args,
                                            **kwargs)

        logger.info("%d chains of %d iterations acquired. Effective sample "
                    "size and Rhat for each parameter:", n_chains, n_samples)
        self.ess = {}
        self.rhat = {}
        for ii, node in enumerate(self.target_model.parameter_names):
            self.ess[node] = mcmc.eff_sample_size(chains[:, warmup:, ii],
                                                  device=self.device)
            self.rhat[node] = mcmc.gelman_rubin_statistic(
                chains[:, warmup:, ii], device=self.device)
            logger.info("%s ESS=%.1f Rhat=%.4f", node, self.ess[node],
                        self.rhat[node])

        return BolfiSample(method_name="BOLFI", chains=chains,
                           parameter_names=self.target_model.parameter_names,
                           warmup=warmup,
                           threshold=float(posterior.threshold),
                           n_sim=self.state["n_evidence"], seed=self.seed)
