"""Pre-sampling tuning tools for BSL (counterpart of
:mod:`elfi_tpu.methods.bsl.pre_sample_methods`): inspect features,
estimate log-SL variability, whitening matrices and shrinkage penalties
before running the MCMC.

Each function resolves the global backend's device once (the current CUDA
device unless a backend on another device was set) and simulates there;
the estimates are numpy on the host.  The plots import matplotlib when
they are called."""

from __future__ import annotations

import numpy as np
import scipy.stats as ss

from ...compile.compiler import compile_program
from ...parallel.backends import resolve_device
from ..utils import batch_to_arr2d
from .pdf_methods import gaussian_syn_likelihood

__all__ = ["plot_features", "plot_covariance_matrix", "log_SL_stdev",
           "estimate_whitening_matrix", "select_penalty"]


def _as_param_dict(model, theta):
    return theta if isinstance(theta, dict) else \
        dict(zip(model.parameter_names, np.atleast_1d(theta)))


def _simulate_features(model, theta, n_sim, feature_names, seed=None,
                       device=None):
    params = _as_param_dict(model, theta)
    ssx = model.generate(int(n_sim), outputs=list(feature_names),
                         with_values=params, seed=seed, device=device)
    return batch_to_arr2d(ssx, feature_names)


def _observed_features(model, feature_names, device):
    prog = compile_program(model, tuple(feature_names), device=device)
    obs = [prog.observed_value(n).cpu().numpy().reshape(1, -1)
           for n in feature_names]
    return np.column_stack(obs)


def _names(feature_names):
    return [feature_names] if isinstance(feature_names, str) \
        else list(feature_names)


def plot_features(model, theta, n_sim, feature_names, seed=None):
    """Histogram each simulated feature against the observed value."""
    import matplotlib.pyplot as plt
    feature_names = _names(feature_names)
    device = resolve_device()
    ssx = _simulate_features(model, theta, n_sim, feature_names, seed,
                             device)
    obs = _observed_features(model, feature_names, device).ravel()
    k = ssx.shape[1]
    ncols = min(4, k)
    nrows = -(-k // ncols)
    fig, axes = plt.subplots(nrows, ncols, squeeze=False,
                             figsize=(3 * ncols, 2.5 * nrows))
    for j in range(k):
        ax = axes[j // ncols][j % ncols]
        ax.hist(ssx[:, j], bins=30)
        ax.axvline(obs[j], color="r")
    return axes


def plot_covariance_matrix(model, theta, n_sim, feature_names, corr=False,
                           precision=False, colorbar=True, seed=None):
    """Heatmap of the feature covariance/correlation/precision matrix."""
    import matplotlib.pyplot as plt
    feature_names = _names(feature_names)
    ssx = _simulate_features(model, theta, n_sim, feature_names, seed,
                             resolve_device())
    mat = np.cov(ssx, rowvar=False)
    if corr:
        d = np.sqrt(np.diag(mat))
        mat = mat / np.outer(d, d)
    if precision:
        mat = np.linalg.inv(mat)
    fig, ax = plt.subplots()
    im = ax.matshow(mat)
    if colorbar:
        fig.colorbar(im)
    return ax


def log_SL_stdev(model, theta, n_sim, feature_names, likelihood=None, M=20,
                 seed=None):
    """Std of the log synthetic likelihood over M replicate estimates, per
    requested n_sim."""
    feature_names = _names(feature_names)
    likelihood = likelihood or gaussian_syn_likelihood
    device = resolve_device()
    observed = _observed_features(model, feature_names, device)
    n_sim = np.atleast_1d(n_sim)
    max_sim = int(np.max(n_sim))
    ll = np.zeros((len(n_sim), M))
    child_seeds = np.random.SeedSequence(seed).generate_state(M)
    for i in range(M):
        ssx = _simulate_features(model, theta, max_sim, feature_names,
                                 seed=int(child_seeds[i] % (2**31)),
                                 device=device)
        for n_i, n in enumerate(n_sim):
            ll[n_i, i] = float(np.asarray(likelihood(ssx[:int(n)], observed))
                               .ravel()[0])
    return np.std(ll, axis=1)


def estimate_whitening_matrix(model, n_sim, theta, feature_names,
                              likelihood_type="standard", seed=None):
    """PCA whitening matrix from simulations at a point estimate
    (Priddle et al. 2021)."""
    if likelihood_type not in ("standard", "semiparametric"):
        raise ValueError(f"Unsupported likelihood type {likelihood_type!r}")
    feature_names = _names(feature_names)
    ssx = _simulate_features(model, theta, n_sim, feature_names, seed,
                             resolve_device())
    ns = ssx.shape[0]
    if likelihood_type == "semiparametric":
        ssx = ss.norm.ppf(ss.rankdata(ssx, axis=0) / (ns + 1))
    z = (ssx - ssx.mean(0)) / ssx.std(0)
    cov = np.cov(z.T)
    w, v = np.linalg.eigh(cov)
    return (np.diag(np.maximum(w, 1e-12) ** -0.5) @ v.T).round(8)


def select_penalty(model, n_sim, theta, feature_names, likelihood=None,
                   lmdas=None, M=20, sigma=1.5, shrinkage="glasso",
                   whitening=None, seed=None, verbose=False):
    """Pick the shrinkage penalty whose log-SL std is closest to ``sigma``
    (An et al. 2019)."""
    from functools import partial
    feature_names = _names(feature_names)
    if lmdas is None:
        lmdas = list(np.exp(np.arange(-5.5, -1.5, 0.2))) \
            if shrinkage == "glasso" else list((np.arange(0.2, 0.8, 0.02)))
    n_lambda = len(lmdas)
    n_sim = np.atleast_1d(n_sim)
    device = resolve_device()
    observed = _observed_features(model, feature_names, device)
    likelihood = likelihood or gaussian_syn_likelihood
    max_sim = int(np.max(n_sim))
    ll = np.zeros((M, len(n_sim), n_lambda))
    child_seeds = np.random.SeedSequence(seed).generate_state(M)
    for m_i in range(M):
        ssx = _simulate_features(model, theta, max_sim, feature_names,
                                 seed=int(child_seeds[m_i] % (2**31)),
                                 device=device)
        for n_i, n in enumerate(n_sim):
            for l_i, lmda in enumerate(lmdas):
                fn = partial(likelihood, shrinkage=shrinkage, penalty=lmda,
                             whitening=whitening)
                ll[m_i, n_i, l_i] = float(np.asarray(
                    fn(ssx[:int(n)], observed)).ravel()[0])
    stds = np.std(ll, axis=0)   # (n_sim, n_lambda)
    closest = np.argmin(np.abs(stds - sigma), axis=1)
    if verbose:
        print("log-SL stds per penalty:", stds)
    picks = np.array([lmdas[i] for i in closest])
    return picks if len(picks) > 1 else float(picks[0])
