"""BSL: Bayesian Synthetic Likelihood via Metropolis-Hastings MCMC (Price
et al. 2018); counterpart of :mod:`elfi_tpu.methods.bsl.method`.

Two chains:

- the host chain (:meth:`BSL.infer` through
  :class:`~elfi_tpu_torch.methods.base.ModelBased`): each round's
  ``n_sim_round`` simulations at one parameter value run as batches on the
  device; the synthetic-likelihood estimate, the proposal and the accept
  are numpy on the host, from one ``np.random.RandomState(seed)`` consumed
  in the JAX package's order;
- the fused chain (:meth:`BSL._run_fused`): one Python loop that queues
  every step -- proposal, the round's simulations, the estimate, the
  accept -- on the device and reads nothing back until the chain ends,
  the counterpart of the JAX package's one jitted ``lax.scan``.  Its
  proposal normals and accept uniforms come from one ``torch.Generator``
  on the device, so it agrees with the host chain statistically, not
  bitwise.
"""

from __future__ import annotations

import contextlib
import logging
from functools import partial

import numpy as np
import torch

from ...compile.compiler import compile_program
from ...model.extensions import ModelPrior
from ...parallel.backends import NativeBackend, ShardedBackend
from ...utils import capture
from ...utils.rng import fold_in, generator
from ..base import ModelBased
from ..results import BslSample
from ..utils import batch_to_arr2d
from .pdf_methods import gaussian_syn_likelihood, traceable_likelihood
from .slice_samplers import slice_gamma_mean, slice_gamma_variance

logger = logging.getLogger(__name__)

__all__ = ["BSL"]

#: folded into the seed to key the fused chain's proposal and accept
#: stream (the JAX package's constant)
_CHAIN_SALT = 0xB51
#: MH steps in one CUDA graph of the fused chain.  Each chain records its
#: first block eagerly and captures its second (its graphs are its own),
#: and runs the steps past the last whole block eagerly, so a smaller
#: block costs a chain less before it replays.  scripts/torch_capture_ab.py
#: --phases bsl on an NVIDIA H100 80GB HBM3 at 700.00 W, MA2 at the JAX
#: bench's point (1000 steps of 500 simulations), best of three: 0.240 /
#: 0.273 / 0.497 ms a step at 16 / 32 / 64 (1.687 eagerly).
_CHAIN_BLOCK = 16


class BSL(ModelBased):
    """Bayesian synthetic likelihood sampler."""

    def __init__(self, model, n_sim_round, feature_names=None,
                 likelihood=None, **kwargs):
        super().__init__(model, n_sim_round, feature_names=feature_names,
                         **kwargs)
        self.random_state = np.random.RandomState(self.seed)
        self.likelihood = likelihood or gaussian_syn_likelihood
        self.is_misspec = (isinstance(likelihood, partial)
                           and "adjustment" in likelihood.keywords)
        self.param_names = None
        self.prior = None
        self.sigma_proposals = None
        self.burn_in = 0
        self.logit_transform_bound = None
        self.gamma_sampler = None
        self.gamma_sampler_state = {}

    @property
    def parameter_names(self):
        return self.param_names or self.model.parameter_names

    def sample(self, n_samples, sigma_proposals, params0=None,
               param_names=None, burn_in=0, logit_transform_bound=None,
               tau=0.5, w=1, max_iter=1000, fused=None, bar=True, **kwargs):
        """Run the MH chain for ``n_samples`` rounds.

        ``fused=True`` (default when eligible) runs the whole chain on the
        device from one host loop that never waits for the device
        (:meth:`_run_fused`).  Eligible when the estimator has a device
        form (standard, Warton, unbiased), there is no misspecification
        adjustment, ``batch_size == n_sim_round``, the backend is native or
        a device list (the chain runs on its first device) and the model
        has no host nodes.
        """
        self.sigma_proposals = np.atleast_2d(sigma_proposals)
        self.param_names = param_names
        self.prior = ModelPrior(self.model,
                                parameter_names=self.parameter_names,
                                device=self.device)
        self.burn_in = burn_in
        self.logit_transform_bound = None if logit_transform_bound is None \
            else np.asarray(logit_transform_bound)
        if self.is_misspec:
            self.gamma_sampler, gamma0 = self._resolve_gamma_sampler(
                tau, w, max_iter)
        else:
            gamma0 = None
        self._init_state(n_samples, params0, gamma0)

        loglik_t = None if self.is_misspec \
            else traceable_likelihood(self.likelihood, device=self.device)
        eligible = (loglik_t is not None and self.pool is None
                    and self.batch_size == self.n_sim_round
                    and isinstance(self.client, (NativeBackend,
                                                 ShardedBackend))
                    and not kwargs)
        prog = None
        if eligible:
            # the parameter nodes are DECLARED overrides of the program
            prog = compile_program(
                self.model, tuple(self.feature_names),
                override_names=tuple(sorted(self.parameter_names)),
                device=self.device)
            eligible = not prog.host
        if fused is None:
            fused = eligible
        if fused and not eligible:
            raise ValueError(
                "fused=True requires a traceable estimator (standard/"
                "Warton/unbiased), no misspecification adjustment, no pool, "
                "batch_size == n_sim_round and a device-traceable model")
        if not fused:
            return self.infer(n_samples, bar=bar, **kwargs)
        self.bar = bar
        self._run_fused(n_samples, prog, loglik_t)
        return self.extract_result()

    def _resolve_gamma_sampler(self, tau, w, max_iter):
        adjustment = self.likelihood.keywords["adjustment"]
        sampler = {"mean": slice_gamma_mean,
                   "variance": slice_gamma_variance}[adjustment]
        sampler = partial(sampler, tau=tau, w=w, max_iter=max_iter,
                          random_state=self.random_state)
        gamma0 = {"mean": 0.0, "variance": tau}[adjustment]
        return sampler, np.repeat(gamma0, self.observed.size)

    def _init_state(self, n_samples, params0=None, gamma0=None):
        super()._init_state()
        if params0 is None:
            batch = self.model.generate(1, self.parameter_names,
                                        seed=self.seed, device=self.device)
            params0 = batch_to_arr2d(batch, self.parameter_names)
        else:
            params0 = np.atleast_2d(params0)
            if not np.all(np.isfinite(self.prior.logpdf(params0))):
                raise ValueError(
                    f"Initial point {params0} is outside prior support")
        self.state["n_samples"] = 0
        self.num_accepted = 0
        self.state["params"] = np.zeros((n_samples,
                                         len(self.parameter_names)))
        self.state["params"][0] = params0
        self.state["logprior"] = np.zeros(n_samples)
        self.state["logprior"][0] = float(np.asarray(
            self.prior.logpdf(params0)).ravel()[0])
        self.state["logposterior"] = np.zeros(n_samples)
        if self.is_misspec:
            self.state["gamma"] = np.zeros((n_samples, self.observed.size))
            self.state["gamma"][0] = gamma0
            self.gamma_sampler_state = {"gamma": gamma0}

    def extract_result(self):
        samples_all = {p: self.state["params"][:, i]
                       for i, p in enumerate(self.parameter_names)}
        if self.is_misspec:
            samples_all["gamma"] = self.state["gamma"][:]
        acc_rate = self.num_accepted / max(
            self.state["n_samples"] - self.burn_in, 1)
        return BslSample(method_name="BSL", samples_all=samples_all,
                         acc_rate=acc_rate, burn_in=self.burn_in,
                         n_sim=self.state["n_sim"],
                         parameter_names=self.parameter_names)

    @property
    def current_params(self):
        return self.state["params"][self.state["n_samples"]]

    def _chain_repeat_prev(self, n):
        """Reject: chain row ``n`` repeats row ``n - 1``."""
        st = self.state
        st["logprior"][n] = st["logprior"][n - 1]
        st["params"][n] = st["params"][n - 1]
        st["logposterior"][n] = st["logposterior"][n - 1]

    def _refresh_gamma(self, n):
        """Slice-sample the misspecification gamma given the current chain
        position, and fold its likelihood into row ``n - 1``."""
        gamma, ll = self.gamma_sampler(self.observed,
                                       **self.gamma_sampler_state)
        self.gamma_sampler_state.update(gamma=gamma, loglik=ll)
        self.state["gamma"][n] = gamma
        self.state["logposterior"][n - 1] = ll + self.state["logprior"][n - 1]

    def _init_round(self):
        """Draw the next MH candidate.  Candidates outside the prior
        support are rejected on the spot -- no simulation round is spent on
        them, the chain just repeats and the round budget shrinks by one."""
        st = self.state
        while st["n_samples"] < len(st["params"]):
            n = st["n_samples"]
            if self.is_misspec:
                self._refresh_gamma(n)
            candidate = self._propagate_state()
            logprior = float(np.asarray(
                self.prior.logpdf(candidate)).ravel()[0])
            if np.isfinite(logprior):
                st["logprior"][n] = logprior
                st["params"][n] = candidate
                st["n_sim_round"] = 0
                return
            self._chain_repeat_prev(n)
            st["n_samples"] += 1
            self.set_objective(self.objective["round"] - 1)

    def _estimate_loglikelihood(self):
        """Synthetic log-likelihood of the observed summaries under the
        round's simulated feature matrix (non-finite simulations estimate
        to -inf)."""
        if not np.all(np.isfinite(self.simulated)):
            return -np.inf
        kwargs = {"gamma": self.gamma_sampler_state["gamma"]} \
            if self.is_misspec else {}
        return float(np.asarray(self.likelihood(
            self.simulated, self.observed, **kwargs)).ravel()[0])

    def _process_simulated(self):
        """MH accept/reject for the finished round."""
        st = self.state
        n = st["n_samples"]
        loglikelihood = self._estimate_loglikelihood()
        if not np.isfinite(loglikelihood):
            if n == 0:
                raise RuntimeError("Estimated likelihood not finite on "
                                   "initialisation round")
            logger.warning("Estimated likelihood not finite")
        st["logposterior"][n] = loglikelihood + st["logprior"][n]

        accept = n == 0 or (self.random_state.uniform()
                            < np.minimum(1.0, self._get_mh_ratio()))
        if accept:
            if self.is_misspec:
                # the gamma sampler conditions on the accepted round's sims
                self.gamma_sampler_state.update(
                    loglik=loglikelihood,
                    sample_mean=np.mean(self.simulated, axis=0),
                    sample_cov=np.cov(self.simulated, rowvar=False))
            self.num_accepted += int(n >= self.burn_in)
        else:
            self._chain_repeat_prev(n)
        st["n_samples"] += 1

    def _propagate_state(self):
        """Gaussian random-walk proposal, optionally in logit space."""
        mean = self.state["params"][self.state["n_samples"] - 1]
        if self.logit_transform_bound is not None:
            tilde = _logit_transform(mean, self.logit_transform_bound)
            draw = self.random_state.multivariate_normal(
                tilde, self.sigma_proposals)
            prop = _logit_back_transform(draw, self.logit_transform_bound)
        else:
            prop = self.random_state.multivariate_normal(
                mean, self.sigma_proposals)
        return np.atleast_2d(prop)

    def _get_mh_ratio(self):
        n = self.state["n_samples"]
        res = self.state["logposterior"][n] - \
            self.state["logposterior"][n - 1]
        if self.logit_transform_bound is not None:
            res += _logit_jacobian(self.state["params"][n],
                                   self.logit_transform_bound) - \
                _logit_jacobian(self.state["params"][n - 1],
                                self.logit_transform_bound)
        return np.exp(np.clip(res, -700, 700))

    # -- the fused chain -----------------------------------------------------------
    def _run_fused(self, n_samples, prog, loglik_t):
        """The whole MH chain queued on the device, then ONE copy of the
        chain to the host.  Everything the loop needs is put on the device
        first (:meth:`_fused_chain` copies nothing from the host)."""
        dev = self.device
        d = len(self.parameter_names)
        observed = torch.as_tensor(
            np.asarray(self.observed, np.float64).ravel(),
            dtype=torch.float32).to(dev)
        Lprop = torch.linalg.cholesky(torch.as_tensor(
            self.sigma_proposals, dtype=torch.float32)).to(dev)
        theta0 = torch.as_tensor(self.state["params"][0],
                                 dtype=torch.float32).to(dev)
        logit = _traceable_logit(self.logit_transform_bound, d, dev)
        thetas, posts, n_acc = self._fused_chain(
            n_samples, prog.traceable(self.batch_size), loglik_t, observed,
            Lprop, theta0, logit, capturable=prog.capturable)
        # the one copy to the host: the chain, its log-posteriors and the
        # accept count (exact in float32 up to 2**24 steps) in one tensor
        packed = torch.cat([thetas.reshape(-1), posts,
                            n_acc.to(torch.float32).reshape(1)]).cpu()
        packed = packed.numpy()
        self.state["params"][:] = packed[:n_samples * d].reshape(n_samples, d)
        self.state["logposterior"][:] = packed[n_samples * d:-1]
        self.state["n_samples"] = n_samples
        self.num_accepted = int(packed[-1])
        self.state["n_sim"] = n_samples * self.batch_size
        self.state["n_batches"] = n_samples

    def _fused_chain(self, n_samples, fn, loglik_t, observed, Lprop, theta0,
                     logit, capturable=False):
        """Queue the chain: step ``i`` simulates batch index ``i`` of the
        per-batch program ``fn`` at the step's proposal (step 0 at
        ``theta0``).  Returns the device tensors ``thetas`` (n, d),
        ``posts`` (n,) and the 0-d count of accepted steps past the
        burn-in.  Nothing here reads from the device or copies from the
        host: the host only queues work.

        On a CUDA device, with a ``capturable`` program, blocks of
        :data:`_CHAIN_BLOCK` steps are CUDA graphs
        (:class:`~elfi_tpu_torch.utils.capture.Replays`: the first block
        runs eagerly and recorded, the second captures, the rest replay),
        with the chain's generator registered with the graph, so its
        offsets advance across replays as they do eagerly; step 0 and a
        shorter last block run eagerly.  Either way the chain is the eager
        chain, bit for bit."""
        dev = theta0.device
        d = theta0.shape[0]
        B = self.batch_size
        pnames = list(self.parameter_names)
        feats = list(self.feature_names)
        seed = self.seed
        burn_in = self.burn_in
        prior_logpdf = self.prior.traceable_logpdf()
        to_tilde, back, jac = logit
        gen = generator(fold_in(seed, _CHAIN_SALT), dev)

        def loglik_of(theta, i):
            out = fn(seed, i, {p: theta[j].expand(B)
                               for j, p in enumerate(pnames)})
            sx = torch.column_stack([out[f].reshape(B, -1) for f in feats])
            ll = loglik_t(sx, observed)
            return torch.where(torch.isfinite(sx).all(), ll, -np.inf)

        thetas = torch.empty((n_samples, d), dtype=torch.float32, device=dev)
        posts = torch.empty((n_samples,), dtype=torch.float32, device=dev)
        theta = theta0
        logpost = loglik_of(theta0, 0) + prior_logpdf(theta0[None, :])[0]
        thetas[0] = theta
        posts[0] = logpost

        def block(state, start, length):
            """Steps ``start .. start + length - 1``; the step index is
            also a device counter (``state["i"]``), so a graph of the
            block writes each replay's rows."""
            theta, logpost = state["theta"], state["logpost"]
            n_acc, first = state["n_acc"], state["i"]
            for j in range(length):
                i = first + j
                z = torch.randn((d,), generator=gen, device=dev)
                prop = back(to_tilde(theta) + Lprop @ z)
                post = loglik_of(prop, start + j) \
                    + prior_logpdf(prop[None, :])[0]
                ratio = post - logpost + jac(prop) - jac(theta)
                u = torch.rand((), generator=gen, device=dev)
                accept = (torch.log(u) < torch.clamp(ratio, -700, 700)) \
                    & torch.isfinite(post)
                theta = torch.where(accept, prop, theta)
                logpost = torch.where(accept, post, logpost)
                n_acc = n_acc + (accept & (i >= burn_in))
                thetas.index_copy_(0, i.reshape(1), theta[None])
                posts.index_copy_(0, i.reshape(1), logpost.reshape(1))
            return dict(theta=theta, logpost=logpost, n_acc=n_acc,
                        i=first + length), None

        state = dict(theta=theta, logpost=logpost,
                     n_acc=torch.zeros((), dtype=torch.int64, device=dev),
                     i=torch.ones((), dtype=torch.int64, device=dev))
        captured = capture.enabled(dev) and capturable
        replays = capture.Replays()
        with capture.on_side_stream(dev) if captured \
                else contextlib.nullcontext():
            i = 1
            while i < n_samples:
                length = min(_CHAIN_BLOCK, n_samples - i)
                if captured and length == _CHAIN_BLOCK:
                    state, _ = replays(
                        "block", state,
                        lambda st, start: block(st, start, _CHAIN_BLOCK),
                        {"node": seed}, i, dev, persistent=(gen,))
                else:
                    state.update(block(state, i, length)[0])
                i += length
        self._chain_replays = replays
        return thetas, posts, state["n_acc"]


def _traceable_logit(bound, d, device):
    """Torch versions of the logit transform triple (to-tilde, back,
    log-Jacobian) on ``device``, with the per-coordinate bound types and
    bounds put there once."""
    if bound is None:
        return (lambda x: x), (lambda y: y), (lambda x: 0.0)
    a = np.asarray(bound[:, 0], np.float64)
    b = np.asarray(bound[:, 1], np.float64)
    t = _bound_types(bound)

    def on_device(v, dtype=torch.float32):
        return torch.as_tensor(v, dtype=dtype).to(device)

    M0 = on_device(t == 0, torch.bool)
    M1 = on_device(t == 1, torch.bool)
    M2 = on_device(t == 2, torch.bool)
    a_s = on_device(np.where(np.isfinite(a), a, 0.0))
    b_s = on_device(np.where(np.isfinite(b), b, 1.0))
    eps = 1e-12

    def to_tilde(x):
        v0 = torch.log(torch.clamp(x - a_s, min=eps)
                       / torch.clamp(b_s - x, min=eps))
        v1 = -torch.log(torch.clamp(b_s - x, min=eps))
        v2 = torch.log(torch.clamp(x - a_s, min=eps))
        return torch.where(M0, v0, torch.where(M1, v1, torch.where(M2, v2, x)))

    def back(y):
        ey = torch.exp(y)
        v0 = a_s / (1 + ey) + b_s / (1 + 1 / ey)
        v1 = b_s - 1 / ey
        v2 = a_s + ey
        return torch.where(M0, v0, torch.where(M1, v1, torch.where(M2, v2, y)))

    def jac(x):
        y = to_tilde(x)
        ey = torch.exp(y)
        j0 = torch.log(b_s - a_s) - torch.log(1 / ey + 2 + ey)
        j = torch.where(M0, j0, torch.where(M1 | M2, y, 0.0))
        return torch.sum(j)

    return to_tilde, back, jac


def _bound_types(bound):
    """0: both finite, 1: only upper finite, 2: only lower finite, 3: none."""
    return np.isinf(bound[:, 0]) * 1 + np.isinf(bound[:, 1]) * 2


def _logit_transform(theta, bound):
    """Map params to unbounded space per coordinate."""
    theta = np.asarray(theta, np.float64).ravel()
    a, b = bound[:, 0], bound[:, 1]
    t = _bound_types(bound)
    out = np.empty_like(theta)
    for i, ty in enumerate(t):
        x = theta[i]
        if ty == 0:
            out[i] = np.log((x - a[i]) / (b[i] - x))
        elif ty == 1:
            out[i] = np.log(1 / (b[i] - x))
        elif ty == 2:
            out[i] = np.log(x - a[i])
        else:
            out[i] = x
    return out


def _logit_back_transform(tilde, bound):
    tilde = np.asarray(tilde, np.float64).ravel()
    a, b = bound[:, 0], bound[:, 1]
    t = _bound_types(bound)
    out = np.empty_like(tilde)
    for i, ty in enumerate(t):
        y = tilde[i]
        ey = np.exp(y)
        if ty == 0:
            out[i] = a[i] / (1 + ey) + b[i] / (1 + 1 / ey)
        elif ty == 1:
            out[i] = b[i] - 1 / ey
        elif ty == 2:
            out[i] = a[i] + ey
        else:
            out[i] = y
    return out


def _logit_jacobian(theta, bound):
    """log |d theta / d tilde| evaluated at the transformed value of theta."""
    tilde = _logit_transform(theta, bound)
    a, b = bound[:, 0], bound[:, 1]
    t = _bound_types(bound)
    logj = np.zeros(len(tilde))
    for i, ty in enumerate(t):
        y = tilde[i]
        if ty == 0:
            ey = np.exp(y)
            logj[i] = np.log(b[i] - a[i]) - np.log(1 / ey + 2 + ey)
        elif ty in (1, 2):
            logj[i] = y
    return float(np.sum(logj))
