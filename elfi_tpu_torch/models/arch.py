"""ARCH(1) regression model in PyTorch (counterpart of
:mod:`elfi_tpu.models.arch`; reference ``elfi/examples/arch.py``).

The simulator is a draw of the normals followed by the pure recursion
:func:`arch_from_noise`, an eager loop over the time axis.  The observed
series are the JAX package's draws for any setting, from the Threefry
streams of ``key(seed_obs or 0)``; ``data/arch_observed.npz`` holds the JAX
package's series the generator is held to."""

from __future__ import annotations

from functools import partial
from itertools import combinations
from pathlib import Path

import torch

from ..model.model import Distance, Model, Prior, Simulator, Summary
from ..utils import threefry
from ._observed import first_row, memoised, observed_key, true_values
from ._stats import batch_param

__all__ = ["arch", "arch_from_noise", "get_model", "observed_data",
           "sample_mean", "sample_variance", "autocorr", "pairwise_autocorr"]

#: the JAX package's arrays, which the generator is held to
_DATA = Path(__file__).resolve().parent / "data" / "arch_observed.npz"


def arch_from_noise(t1, t2, e0, xi):
    """y_i = t1 y_{i-1} + e_i with e_i = xi_i sqrt(0.2 + t2 e_{i-1}^2)
    (Engle 1982), on ``e0`` (batch,) and ``xi`` (n_obs, batch); returns
    (batch, n_obs)."""
    b = e0.shape[0]
    t1 = batch_param(t1, b, e0.device)
    t2 = batch_param(t2, b, e0.device)
    y, e = torch.zeros_like(e0), e0
    ys = []
    for xi_i in xi:
        e = xi_i * torch.sqrt(0.2 + t2 * e ** 2)
        y = t1 * y + e
        ys.append(y)
    return torch.stack(ys, dim=1)


def arch(t1, t2, n_obs=100, batch_size=1, generator=None):
    """(batch, n_obs) ARCH(1) series on ``generator``'s device."""
    device = generator.device
    e0 = torch.randn((batch_size,), generator=generator, device=device)
    xi = torch.randn((n_obs, batch_size), generator=generator, device=device)
    return arch_from_noise(t1, t2, e0, xi)


def sample_mean(x):
    return torch.mean(x, dim=1)


def sample_variance(x):
    return torch.var(x, dim=1, correction=1)


def autocorr(x, lag=1):
    n = x.shape[1]
    mu = torch.mean(x, dim=1, keepdim=True)
    std = torch.std(x, dim=1, correction=1, keepdim=True)
    z = (x - mu) / std
    return torch.sum(z[:, lag:] * z[:, :-lag], dim=1) / (n - lag)


def pairwise_autocorr(x, lag_i=1, lag_j=1):
    return autocorr(x, lag_i) * autocorr(x, lag_j)


@memoised
def observed_data(n_obs=100, true_params=None, seed_obs=None, device=None):
    """The observed series (n_obs,), the JAX package's draw: with ``k0, k1
    = split(key(seed_obs or 0))``, ``e0 = normal(k0, (1,))`` and ``xi =
    normal(k1, (n_obs, 1))`` through :func:`arch_from_noise`, on
    ``device`` (None: the global backend's)."""
    k0, k1 = threefry.split(observed_key(seed_obs, device))
    t1, t2 = true_values(true_params or [0.3, 0.7], k0.device)
    return first_row(arch_from_noise(t1, t2, threefry.normal(k0, (1,)),
                                     threefry.normal(k1, (n_obs, 1))))


def get_model(n_obs=100, true_params=None, seed_obs=None, n_lags=5):
    """ARCH(1) inference model with mean, variance and autocorrelation
    summaries."""
    y_obs = observed_data(n_obs, true_params, seed_obs)
    m = Model(name="arch")
    t1 = Prior("uniform", -1, 2, model=m, name="t1")
    t2 = Prior("uniform", 0, 1, model=m, name="t2")
    Y = Simulator(partial(arch, n_obs=n_obs), t1, t2, observed=y_obs,
                  model=m, name="Y")
    ss = [Summary(sample_mean, Y, model=m, name="MU"),
          Summary(sample_variance, Y, model=m, name="VAR")]
    for i in range(1, n_lags + 1):
        ss.append(Summary(partial(autocorr, lag=i), Y, model=m,
                          name=f"AC_{i}"))
    for i, j in combinations(range(1, n_lags + 1), 2):
        ss.append(Summary(partial(pairwise_autocorr, lag_i=i, lag_j=j), Y,
                          model=m, name=f"PW_{i}_{j}"))
    Distance("euclidean", *ss, model=m, name="d")
    return m
