"""Fowler's toads movement model in PyTorch (Marchand et al. 2017;
counterpart of :mod:`elfi_tpu.models.toad`).

Batch-first, as in the JAX package: the simulator returns (batch, n_days,
n_toads).  Each day is one batched update: a return draw, an alpha-stable
step (:class:`~elfi_tpu_torch.ops.distributions.levy_stable`), a uniform
refuge day in [0, i) and a ``torch.gather`` over the site history.  The
day's draws come from :func:`toad_day_noise`, and the pure recursion
:func:`toad_from_noise` takes them, so a test can feed it the JAX
package's.  The observed data are the JAX package's draws for any setting:
:func:`observed_data` gives the day loop the draws of the JAX simulator's
key tree at batch 1; ``data/toad_observed.npz`` holds the JAX package's
positions the generator is held to."""

from __future__ import annotations

from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..model.model import Distance, Model, Prior, Simulator, Summary
from ..ops.distributions import levy_stable
from ..utils import threefry
from ._observed import first_row, memoised, observed_key, true_values
from ._stats import nanquantiles

__all__ = ["toad", "toad_from_noise", "toad_day_noise", "compute_summaries",
           "obs_mat_to_deltax", "get_model", "observed_data"]

#: the JAX package's positions, which the generator is held to
_DATA = Path(__file__).resolve().parent / "data" / "toad_observed.npz"


def toad_day_noise(i, batch_size, n_toads, generator):
    """Day ``i``'s draws: the return uniforms, the levy-stable ``(U, W)``
    and the refuge day in [0, max(i, 1)), each (batch, n_toads)."""
    shape = (batch_size, n_toads)
    device = generator.device
    r = torch.rand(shape, generator=generator, device=device)
    U, W = levy_stable.draw(shape, generator)
    ref = torch.randint(0, max(i, 1), shape, generator=generator,
                        device=device)
    return r, U, W, ref


def toad_from_noise(alpha, gamma, p0, n_days, day_noise):
    """Levy-flight foraging with a probabilistic return to a previous
    refuge; ``day_noise(i)`` gives day ``i``'s ``(r, U, W, ref)`` for i in
    1 .. n_days - 1.  Returns (batch, n_days, n_toads)."""
    r, U, W, ref = day_noise(1)
    batch_size, n_toads = r.shape
    device = r.device
    alpha = torch.as_tensor(alpha, dtype=torch.float32,
                            device=device).reshape(-1, 1)
    gamma = torch.as_tensor(gamma, dtype=torch.float32,
                            device=device).reshape(-1, 1)
    p0 = torch.as_tensor(p0, dtype=torch.float32,
                         device=device).reshape(-1, 1)
    X = torch.zeros((batch_size, n_days, n_toads), device=device)
    for i in range(1, n_days):
        if i > 1:
            r, U, W, ref = day_noise(i)
        step = levy_stable.transform(U, W, alpha, 0.0, 0.0, gamma)
        moved = X[:, i - 1] + step
        refuge = torch.gather(X, 1, ref[:, None, :].long())[:, 0]
        X[:, i] = torch.where(r < p0, refuge, moved)
    return X


def toad(alpha, gamma, p0, n_toads=66, n_days=63, batch_size=1,
         generator=None):
    """(batch, n_days, n_toads) toad positions on ``generator``'s
    device."""
    return toad_from_noise(alpha, gamma, p0, n_days, lambda i: toad_day_noise(
        i, batch_size, n_toads, generator))


def obs_mat_to_deltax(X, lag):
    """Displacements over ``lag`` days; (batch, n_toads*(n_days-lag))."""
    d = X[:, lag:, :] - X[:, :-lag, :]
    return d.reshape(d.shape[0], -1)


def compute_summaries(X, lag, p=np.linspace(0, 1, 11), thd=10):
    """Per-lag displacement summaries: the returned count, the median and
    the log quantile differences of the displacements that did not
    return; (batch, len(p) + 1).  A NaN becomes the largest float32, as
    ``jnp.nan_to_num(..., nan=inf)`` leaves it."""
    abs_disp = torch.abs(obs_mat_to_deltax(X, lag))
    ret = abs_disp < thd
    num_ret = torch.sum(ret, dim=1).to(torch.float32)
    masked = torch.where(ret, torch.nan, abs_disp)
    qs = nanquantiles(masked, np.concatenate([[0.5], np.asarray(p)]))
    logdiff = torch.log(torch.clamp(torch.diff(qs[1:], dim=0),
                                    min=float(np.exp(np.float32(-20)))))
    ssx = torch.cat([num_ret[None], qs[:1], logdiff], dim=0)
    return torch.nan_to_num(ssx, nan=torch.finfo(torch.float32).max).T


@memoised
def observed_data(true_params=None, seed_obs=None, n_toads=66, n_days=63,
                  device=None):
    """The observed positions (n_days, n_toads), the JAX package's draw on
    ``device`` (None: the global backend's): day i's key is ``split(
    key(seed_obs or 0), n_days)[i]``, split in three for the return
    uniforms, the alpha-stable ``(U, W)`` and ``randint(0, max(i, 1))``
    of the refuge day, each (1, n_toads)."""
    days = threefry.split(observed_key(seed_obs, device), n_days)
    shape = (1, n_toads)

    def day_noise(i):
        k1, k2, k3 = threefry.split(days[i], 3)
        U, W = levy_stable.draw_from_key(k2, shape)
        return (threefry.uniform(k1, shape), U, W,
                threefry.randint(k3, shape, 0, max(i, 1)))

    alpha, gamma, p0 = true_values(true_params or [1.7, 35.0, 0.6],
                                   days.device)
    return first_row(toad_from_noise(alpha, gamma, p0, n_days, day_noise))


def get_model(true_params=None, seed_obs=None, n_toads=66, n_days=63):
    """Toad movement inference model."""
    y = observed_data(true_params, seed_obs, n_toads, n_days)
    m = Model(name="toad")
    Prior("uniform", 1, 1, model=m, name="alpha")
    Prior("uniform", 0, 100, model=m, name="gamma")
    Prior("uniform", 0, 0.9, model=m, name="p0")
    Simulator(partial(toad, n_toads=n_toads, n_days=n_days), m["alpha"],
              m["gamma"], m["p0"], observed=y, model=m, name="toad")
    ss = [Summary(partial(compute_summaries, lag=lag), m["toad"], model=m,
                  name=f"S{lag}") for lag in (1, 2, 4, 8)]
    Distance("euclidean", *ss, model=m, name="d")
    return m
