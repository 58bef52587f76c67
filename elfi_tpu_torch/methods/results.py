"""Inference result containers (counterpart of
:mod:`elfi_tpu.methods.results`); numpy in, numpy out.  The plotting
methods import :mod:`elfi_tpu_torch.visualization` (and so matplotlib)
when they are called."""

from __future__ import annotations

import io
import json
import pickle
import sys
from collections import OrderedDict

import numpy as np

from .utils import compute_ess, normalize_weights, weighted_sample_quantile

__all__ = ["ParameterInferenceResult", "OptimizationResult", "Sample",
           "SmcSample", "BolfiSample", "BolfireSample", "BslSample",
           "RomcSample"]


class ParameterInferenceResult:
    """Base result: method name, numpy outputs, parameter names, meta."""

    def __init__(self, method_name, outputs, parameter_names, **kwargs):
        self.method_name = method_name
        self.outputs = {k: np.asarray(v) for k, v in outputs.items()}
        self.parameter_names = list(parameter_names)
        self.meta = kwargs

    def __getattr__(self, item):
        # surface meta entries (seed, n_sim, threshold, ...) as attributes
        meta = self.__dict__.get("meta", {})
        if item in meta:
            return meta[item]
        raise AttributeError(item)


class OptimizationResult(ParameterInferenceResult):
    """Result of an optimization run (reference ``results.py:55-70``)."""

    def __init__(self, x_min, **kwargs):
        super().__init__(**kwargs)
        self.x_min = x_min


class Sample(ParameterInferenceResult):
    """Sampling result with optional weights."""

    def __init__(self, method_name, outputs, parameter_names,
                 discrepancy_name=None, weights=None, **kwargs):
        super().__init__(method_name=method_name, outputs=outputs,
                         parameter_names=parameter_names, **kwargs)
        self.samples = OrderedDict(
            (n, self.outputs[n]) for n in self.parameter_names)
        self.discrepancy_name = discrepancy_name
        self.weights = None if weights is None else np.asarray(weights)

    # -- views ---------------------------------------------------------------
    @property
    def n_samples(self):
        return len(next(iter(self.samples.values())))

    @property
    def dim(self):
        return len(self.samples)

    @property
    def samples_array(self):
        cols = [np.asarray(v).reshape(self.n_samples, -1)
                for v in self.samples.values()]
        return np.column_stack(cols)

    @property
    def discrepancies(self):
        if self.discrepancy_name is None:
            return None
        d = self.outputs[self.discrepancy_name]
        return d if d.ndim == 1 else d[..., -1]

    # -- statistics ------------------------------------------------------------
    @property
    def sample_means(self):
        w = self.weights if self.weights is not None else \
            np.ones(self.n_samples)
        w = normalize_weights(w)
        return OrderedDict((n, np.sum(w.reshape(-1, *([1] * (np.ndim(v) - 1)))
                                      * np.asarray(v), axis=0))
                           for n, v in self.samples.items())

    @property
    def sample_means_array(self):
        return np.array(list(self.sample_means.values()), dtype=float)

    def sample_quantiles(self, alpha):
        return OrderedDict(
            (n, weighted_sample_quantile(v, alpha, self.weights))
            for n, v in self.samples.items())

    def sample_means_and_95CIs(self):
        out = OrderedDict()
        lo, hi = self.sample_quantiles(0.025), self.sample_quantiles(0.975)
        for n, m in self.sample_means.items():
            out[n] = dict(mean=float(np.ravel(m)[0]), CI95_lower=lo[n],
                          CI95_upper=hi[n])
        return out

    def get_sample_covariance(self):
        x = self.samples_array
        w = self.weights if self.weights is not None else np.ones(len(x))
        w = normalize_weights(w)
        mean = np.sum(w[:, None] * x, axis=0)
        diff = x - mean
        return (w[:, None] * diff).T @ diff / (1 - np.sum(w ** 2))

    @property
    def effective_sample_size(self):
        w = self.weights if self.weights is not None else \
            np.ones(self.n_samples)
        return compute_ess(w)

    @property
    def idata(self):
        """arviz ``InferenceData`` of the samples (one chain); a dict of
        numpy arrays where arviz is not installed."""
        try:
            import arviz as az
        except ImportError:
            return {k: np.asarray(v) for k, v in self.samples.items()}
        return az.convert_to_inference_data(
            {k: np.asarray(v)[None] for k, v in self.samples.items()})

    # -- io -----------------------------------------------------------------
    def __str__(self):
        return self.summary_string()

    def __repr__(self):
        return self.summary_string()

    def summary_string(self):
        buf = io.StringIO()
        buf.write(f"Method: {self.method_name}\n")
        buf.write(f"Number of samples: {self.n_samples}\n")
        if "n_sim" in self.meta:
            buf.write(f"Number of simulations: {self.meta['n_sim']}\n")
        if "threshold" in self.meta and self.meta["threshold"] is not None:
            thr = np.asarray(self.meta['threshold'], dtype=float).ravel()
            buf.write(f"Threshold: {float(thr[-1]):.3g}\n")
        buf.write(self.parameter_summary_string())
        return buf.getvalue()

    def parameter_summary_string(self):
        means = self.sample_means
        return "Sample means: " + ", ".join(
            f"{n}: {float(np.ravel(v)[0]):.3g}" for n, v in means.items()) + "\n"

    def summary(self):
        sys.stdout.write(self.summary_string())

    def save(self, fname):
        """Save as .csv / .json / .pkl by extension."""
        if fname.endswith(".pkl"):
            with open(fname, "wb") as f:
                pickle.dump(self, f)
        elif fname.endswith(".csv"):
            arr = self.samples_array
            header = ",".join(self.parameter_names)
            np.savetxt(fname, arr, delimiter=",", header=header, comments="")
        elif fname.endswith(".json"):
            payload = {n: np.asarray(v).tolist()
                       for n, v in self.samples.items()}
            if self.weights is not None:
                payload["__weights__"] = self.weights.tolist()
            with open(fname, "w") as f:
                json.dump(payload, f)
        else:
            raise ValueError("Unknown extension; use .pkl/.csv/.json")

    # -- plotting -------------------------------------------------------------
    def plot_marginals(self, selector=None, bins=20, axes=None, **kwargs):
        from ..visualization import plot_marginals
        return plot_marginals(self.samples, selector, bins, axes, **kwargs)

    def plot_pairs(self, selector=None, bins=20, axes=None, **kwargs):
        from ..visualization import plot_pairs
        return plot_pairs(self.samples, selector, bins, axes, **kwargs)


class SmcSample(Sample):
    """SMC result with the population of every round."""

    def __init__(self, method_name, outputs, parameter_names, populations,
                 **kwargs):
        super().__init__(method_name=method_name, outputs=outputs,
                         parameter_names=parameter_names, **kwargs)
        self.populations = populations

    @property
    def n_populations(self):
        return len(self.populations)

    def posterior_means(self, round=-1):
        return self.populations[round].sample_means

    def plot_populations(self, **kwargs):
        """:func:`~elfi_tpu_torch.visualization.plot_pairs` of each
        round's population."""
        from ..visualization import plot_pairs
        for pop in self.populations:
            plot_pairs(pop.samples, **kwargs)

    def sample_means_summary(self, all=False):
        if not all:
            self.summary()
            return
        for i, pop in enumerate(self.populations):
            sys.stdout.write(f"Population {i}: "
                             + pop.parameter_summary_string())


class BolfiSample(Sample):
    """BOLFI MCMC result: chains (n_chains, n_iters, dim), flattened past
    the warm-up into the outputs (reference ``results.py:507-543``)."""

    def __init__(self, method_name, chains, parameter_names, warmup, **kwargs):
        chains = np.asarray(chains)
        n_chains, n_iters, dim = chains.shape
        concat = chains[:, warmup:, :].reshape(-1, dim)
        outputs = {n: concat[:, i] for i, n in enumerate(parameter_names)}
        super().__init__(method_name=method_name, outputs=outputs,
                         parameter_names=parameter_names, **kwargs)
        self.chains = chains
        self.warmup = warmup
        self.n_chains = n_chains

    def plot_traces(self, selector=None, axes=None, **kwargs):
        from ..visualization import plot_traces
        return plot_traces(self, selector, axes, **kwargs)


class BolfireSample(BolfiSample):
    """BOLFIRE MCMC result, laid out as :class:`BolfiSample` (reference
    ``results.py:608-639``)."""


class BslSample(Sample):
    """BSL MCMC result: the chain past ``burn_in`` as the sample, the
    whole chain in ``samples_all``."""

    def __init__(self, method_name, samples_all, parameter_names, burn_in=0,
                 **kwargs):
        samples = {n: np.asarray(v)[burn_in:]
                   for n, v in samples_all.items()}
        super().__init__(method_name=method_name, outputs=samples,
                         parameter_names=parameter_names, **kwargs)
        self.samples_all = {n: np.asarray(v) for n, v in samples_all.items()}
        self.burn_in = burn_in

    def compute_ess(self):
        """Effective sample size of each parameter's chain past the burn-in
        (:func:`~elfi_tpu_torch.methods.mcmc.eff_sample_size` on the global
        backend's device)."""
        from .mcmc import eff_sample_size
        return {n: float(eff_sample_size(np.asarray(v)[None]))
                for n, v in self.samples.items()}

    def plot_traces(self, selector=None, axes=None, **kwargs):
        """The whole chain, one trace per parameter, the burn-in marked."""
        from types import SimpleNamespace

        from ..visualization import plot_traces
        chains = np.stack(list(self.samples_all.values()), axis=-1)[None]
        trace = SimpleNamespace(chains=chains,
                                parameter_names=self.parameter_names,
                                warmup=self.burn_in)
        return plot_traces(trace, selector, axes, **kwargs)


class RomcSample(Sample):
    """ROMC result (reference ``results.py:642-684``): the box points of
    every region with their importance weights."""

    def __init__(self, method_name, outputs, parameter_names,
                 discrepancy_name, weights, **kwargs):
        super().__init__(method_name=method_name, outputs=outputs,
                         parameter_names=parameter_names,
                         discrepancy_name=discrepancy_name, weights=weights,
                         **kwargs)
