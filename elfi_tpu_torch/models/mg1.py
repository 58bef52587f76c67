"""M/G/1 queue model in PyTorch (counterpart of :mod:`elfi_tpu.models.mg1`;
reference ``elfi/examples/mg1.py``).

The simulator is a draw (exponential arrivals, uniform service fractions)
followed by the pure recursion :func:`MG1_from_noise`, an eager loop over
the departures.  The observed series are the JAX package's draws for any
setting, from the Threefry streams of ``key(seed_obs or 0)``;
``data/mg1_observed.npz`` holds the JAX package's series the generator is
held to."""

from __future__ import annotations

from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..model.model import Distance, Model, Operation, Prior, Simulator, \
    Summary
from ..utils import threefry
from ._observed import first_row, memoised, observed_key, true_values
from ._stats import batch_param, quantiles as _quantiles

__all__ = ["MG1", "MG1_from_noise", "get_model", "observed_data",
           "log_identity", "quantiles"]

#: the JAX package's arrays, which the generator is held to
_DATA = Path(__file__).resolve().parent / "data" / "mg1_observed.npz"


def MG1_from_noise(t1, t2, t3, E, V):
    """Interdeparture times of an M/G/1 queue on standard exponentials
    ``E`` and uniforms ``V``, both (n_obs, batch): interarrivals ``E /
    t3``, services ``t1 + (t2 - t1) V``; returns (batch, n_obs)."""
    b = E.shape[1]
    t1, t2, t3 = (batch_param(t, b, E.device) for t in (t1, t2, t3))
    W = E / t3
    U = t1 + (t2 - t1) * V
    sum_w = torch.zeros_like(t1)
    sum_x = torch.zeros_like(t1)
    ys = []
    for w, u in zip(W, U):
        sum_w = sum_w + w
        y = u + torch.clamp(sum_w - sum_x, min=0.0)
        sum_x = sum_x + y
        ys.append(y)
    return torch.stack(ys, dim=1)


def MG1(t1, t2, t3, n_obs=50, batch_size=1, generator=None):
    """(batch, n_obs) interdeparture times on ``generator``'s device:
    service ~ U(t1, t2), interarrivals ~ Exp(t3)."""
    device = generator.device
    E = torch.empty((n_obs, batch_size), device=device).exponential_(
        generator=generator)
    V = torch.rand((n_obs, batch_size), generator=generator, device=device)
    return MG1_from_noise(t1, t2, t3, E, V)


def log_identity(x):
    return torch.log(x)


def quantiles(x, q):
    """(batch, len(q)) quantiles of each row, as ``jnp.quantile``."""
    return _quantiles(x, q).T


@memoised
def observed_data(n_obs=50, true_params=None, seed_obs=None, device=None):
    """The observed series (n_obs,), the JAX package's draw: with ``k1, k2
    = split(key(seed_obs or 0))``, ``exponential(k1, (n_obs, 1))`` and
    ``uniform(k2, (n_obs, 1))`` through :func:`MG1_from_noise`, on
    ``device`` (None: the global backend's)."""
    k1, k2 = threefry.split(observed_key(seed_obs, device))
    params = true_values(true_params or [1., 5., 0.2], k1.device)
    return first_row(MG1_from_noise(*params,
                                    threefry.exponential(k1, (n_obs, 1)),
                                    threefry.uniform(k2, (n_obs, 1))))


def get_model(n_obs=50, true_params=None, seed_obs=None, n_quantiles=10):
    """M/G/1 inference model with log quantile summaries."""
    y = observed_data(n_obs, true_params, seed_obs)
    m = Model(name="mg1")
    Prior("uniform", 0., 10., model=m, name="t1")
    Prior("uniform", 0., 10., model=m, name="t2")
    Prior("uniform", 0., 0.5, model=m, name="t3")
    Simulator(partial(MG1, n_obs=n_obs), m["t1"], m["t2"], m["t3"],
              observed=y, model=m, name="MG1")
    q = np.linspace(0, 1, n_quantiles + 2)[1:-1]
    Summary(partial(quantiles, q=q), m["MG1"], model=m, name="log_qtls")
    log_q = Operation(log_identity, m["log_qtls"], model=m,
                      name="log_sumstats")
    Distance("euclidean", log_q, model=m, name="d")
    return m
