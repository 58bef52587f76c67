"""Ricker population model in PyTorch (counterpart of
:mod:`elfi_tpu.models.ricker`; reference ``elfi/examples/ricker.py``).

The JAX package runs the time recursion as a ``lax.scan``; here it is a
loop over the ``n_obs`` steps, each step one batched update of the whole
batch.  The stochastic model's normals and Poisson counts come from the
node's generator, so it agrees with the JAX package statistically; the
deterministic map agrees exactly.

The observed series must be the JAX package's.  :func:`observed_data`
draws them from the Threefry streams of ``key(seed_obs or 0)`` along the
JAX simulator's key tree, for any setting, and runs the recursion in XLA's
float32 arithmetic (its ``exp`` and its fused multiply-add): at these rates
the map is chaotic, and an ulp would grow into another series.
``data/ricker_observed.npz`` holds the JAX package's series the generator
is held to (n_obs=50, true parameters (3.8, 0.3, 10) or 3.8):

- ``stochastic_seed_<s>``: ``get_model(seed_obs=s)`` for s in {0, 3};
- ``deterministic_seed_0``: ``get_model(stochastic=False)``, which does
  not depend on the seed;
- ``bench_seed_4``: the series of the JAX bench's BOLFI phase,
  ``stochastic_ricker(3.8, 0.3, 10, key=jax.random.key(4))``
  (:func:`bench_observed`).
"""

from __future__ import annotations

from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..model.model import Discrepancy, Distance, Model, Prior, Simulator, \
    Summary
from ..utils import threefry, xla_math
from ._observed import memoised, observed_key, true_values

__all__ = ["ricker", "stochastic_ricker", "get_model", "chi_squared",
           "num_zeros", "observed_data", "bench_observed"]

#: the JAX package's series, which the generator is held to
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


@memoised
def observed_data(n_obs=50, true_params=None, seed_obs=None,
                  stochastic=True, device=None):
    """The observed series (n_obs,) float32, the JAX package's: the
    stochastic map's step t draws ``normal(k1, (1,))`` and ``poisson(k2,
    scale * stock, (1,))`` with ``k1, k2 = split(split(key(seed_obs or 0),
    n_obs)[t])``; the deterministic map draws nothing.  On ``device``
    (None: the global backend's)."""
    k = observed_key(seed_obs, device)
    if not stochastic:
        (log_rate,) = true_values(true_params or (3.8,), k.device)
        return _xla_series(log_rate, n_obs).cpu().numpy()
    log_rate, std, scale = true_values(true_params or (3.8, 0.3, 10.),
                                       k.device)
    keys = threefry.split(k, n_obs)

    def step(t, stock):
        k1, k2 = threefry.split(keys[t])
        stock = stock * xla_math.exp(xla_math.fma(
            std, threefry.normal(k1, (1,)), log_rate - stock))
        return stock, threefry.poisson(k2, scale * stock, (1,))
    return _xla_series(log_rate, n_obs, step).to(torch.float32).cpu().numpy()


def _xla_series(log_rate, n_obs, step=None):
    """The Ricker recursion from stock 1 at batch 1 in XLA's float32
    arithmetic: the deterministic map's stocks, or the counts that
    ``step(t, stock) -> (stock, count)`` gives.  The simulators keep
    ``torch.exp``: XLA's ``exp`` and fused multiply-add take 20.0 against
    1.57 ms for 50 steps at 2**16 members on an H100
    (``scripts/torch_xla_order_ab.py``)."""
    stock = torch.ones_like(log_rate)
    out = []
    for t in range(n_obs):
        if step is None:
            out.append(stock)
            stock = stock * xla_math.exp(log_rate - stock)
        else:
            stock, count = step(t, stock)
            out.append(count)
    return torch.cat(out)


def bench_observed(device=None):
    """The observed series of the JAX bench's BOLFI phase
    (``bench.py:_bench_bolfi_ricker``): the stochastic map at (3.8, 0.3,
    10), 50 steps, under ``key(4)``."""
    return observed_data(seed_obs=4, device=device)


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
