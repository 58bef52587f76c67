"""Ricker population model in PyTorch (counterpart of
:mod:`elfi_tpu.models.ricker`; reference ``elfi/examples/ricker.py``).

The JAX package runs the time recursion as a ``lax.scan``; here it is a
loop over the ``n_obs`` steps, each step one batched update of the whole
batch.  The stochastic model's normals and Poisson counts come from the
node's generator, so it agrees with the JAX package statistically; the
deterministic map agrees exactly.

The observed series must be the JAX package's: ``jax.random`` draws them,
and the port does not import JAX, so ``data/ricker_observed.npz`` holds the
JAX package's series for these settings only (n_obs=50, true parameters
(3.8, 0.3, 10) or 3.8):

- ``stochastic_seed_<s>``: ``get_model(seed_obs=s)`` for s in {0, 3};
- ``deterministic_seed_0``: ``get_model(stochastic=False)``, which does
  not depend on the seed;
- ``bench_seed_4``: the series of the JAX bench's BOLFI phase,
  ``stochastic_ricker(3.8, 0.3, 10, key=jax.random.key(4))``
  (:func:`bench_observed`).

The tests check each against the JAX package's draw.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..model.model import Discrepancy, Distance, Model, Prior, Simulator, \
    Summary
from ._observed import load_observed

__all__ = ["ricker", "stochastic_ricker", "get_model", "chi_squared",
           "num_zeros", "observed_data", "bench_observed"]

_DATA = Path(__file__).resolve().parent / "data" / "ricker_observed.npz"


def _batch(v, batch_size, device):
    return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32,
                                              device=device), (batch_size,))


def ricker(log_rate, stock_init=1., n_obs=50, batch_size=1, generator=None):
    """Deterministic Ricker map; (batch, n_obs)."""
    device = log_rate.device if isinstance(log_rate, torch.Tensor) else \
        (generator.device if generator is not None else None)
    log_rate = _batch(log_rate, batch_size, device)
    stock = torch.full((batch_size,), float(stock_init), device=device)
    stocks = []
    for _ in range(n_obs):
        stocks.append(stock)
        stock = stock * torch.exp(log_rate - stock)
    return torch.stack(stocks, dim=1)


def stochastic_ricker(log_rate, std, scale, stock_init=1., n_obs=50,
                      batch_size=1, generator=None):
    """Stochastic Ricker with Poisson observations (Wood 2010);
    (batch, n_obs) float32 counts."""
    device = log_rate.device if isinstance(log_rate, torch.Tensor) else \
        (generator.device if generator is not None else None)
    log_rate = _batch(log_rate, batch_size, device)
    std = _batch(std, batch_size, device)
    scale = _batch(scale, batch_size, device)
    stock = torch.full((batch_size,), float(stock_init), device=device)
    obs = []
    for _ in range(n_obs):
        z = torch.randn((batch_size,), generator=generator, device=device)
        stock = stock * torch.exp(log_rate - stock + std * z)
        obs.append(torch.poisson(scale * stock, generator=generator))
    return torch.stack(obs, dim=1)


def num_zeros(x):
    return torch.sum(x == 0, dim=1)


def chi_squared(*simulated, observed):
    """Chi-squared goodness of fit over stacked summaries (reference
    ``ricker.py:148-163``)."""
    sim = torch.column_stack([torch.as_tensor(s).to(torch.float32).reshape(
        torch.as_tensor(s).shape[0], -1) for s in simulated])
    obs = torch.column_stack([torch.as_tensor(o).to(torch.float32).reshape(
        1, -1) for o in observed])
    return torch.sum((sim - obs) ** 2 / obs, dim=1)


def mean(x):
    return torch.mean(x, dim=1)


def var(x):
    """Population variance along axis 1, as ``jnp.var``."""
    return torch.var(x, dim=1, correction=0)


def observed_data(n_obs=50, true_params=None, seed_obs=None,
                  stochastic=True):
    """The JAX package's observed series for these settings; only the
    committed settings are available."""
    if stochastic:
        return load_observed(_DATA, n_obs, 50, true_params, (3.8, 0.3, 10.),
                             seed_obs, prefix="stochastic_")
    return load_observed(_DATA, n_obs, 50, true_params, (3.8,), 0,
                         prefix="deterministic_")


def bench_observed():
    """The observed series of the JAX bench's BOLFI phase
    (``bench.py:_bench_bolfi_ricker``)."""
    with np.load(_DATA) as data:
        return data["bench_seed_4"]


def get_model(n_obs=50, true_params=None, seed_obs=None, stochastic=True):
    """Ricker inference model (reference ``ricker.py:88-146``)."""
    m = Model(name="ricker")
    y_obs = observed_data(n_obs, true_params, seed_obs, stochastic)
    if stochastic:
        sim_fn = partial(stochastic_ricker, n_obs=n_obs)
        Prior("expon", np.e, 2, model=m, name="t1")
        Prior("truncnorm", 0, 5, model=m, name="t2")
        Prior("uniform", 0, 100, model=m, name="t3")
        Simulator(sim_fn, m["t1"], m["t2"], m["t3"], observed=y_obs,
                  model=m, name="Ricker")
        s1 = Summary(mean, m["Ricker"], model=m, name="Mean")
        s2 = Summary(var, m["Ricker"], model=m, name="Var")
        s3 = Summary(num_zeros, m["Ricker"], model=m, name="n0")
        Discrepancy(chi_squared, s1, s2, s3, model=m, name="d")
    else:
        sim_fn = partial(ricker, n_obs=n_obs)
        Prior("expon", np.e, model=m, name="t1")
        Simulator(sim_fn, m["t1"], observed=y_obs, model=m, name="Ricker")
        s1 = Summary(mean, m["Ricker"], model=m, name="Mean")
        Distance("euclidean", s1, model=m, name="d")
    return m
