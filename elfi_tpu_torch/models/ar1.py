"""AR(1) example model in PyTorch (counterpart of
:mod:`elfi_tpu.models.ar1`; reference ``elfi/examples/ar1.py``).

The simulator is a draw of the innovations followed by the pure recursion
:func:`AR1_from_noise`, an eager loop over the time axis (the JAX
package's ``lax.scan``).  The observed series are the JAX package's
draws for any setting: the innovations come from the Threefry stream of
``key(seed_obs or 0)``; ``data/ar1_observed.npz`` holds the JAX package's
series the generator is held to."""

from __future__ import annotations

from functools import partial
from pathlib import Path

import torch

from ..model.model import Distance, Model, Prior, Simulator
from ..utils import threefry
from ._observed import first_row, memoised, observed_key, true_values
from ._stats import batch_param

__all__ = ["AR1", "AR1_from_noise", "get_model", "observed_data"]

#: the JAX package's arrays, which the generator is held to
_DATA = Path(__file__).resolve().parent / "data" / "ar1_observed.npz"


def AR1_from_noise(phi, w):
    """x_i = phi x_{i-1} + w_i, x_0 = 0, on innovations ``w`` (n_obs,
    batch); returns (batch, n_obs)."""
    phi = batch_param(phi, w.shape[1], w.device)
    x = torch.zeros_like(w[0])
    xs = []
    for w_i in w:
        x = phi * x + w_i
        xs.append(x)
    return torch.stack(xs, dim=1)


def AR1(phi, n_obs=200, batch_size=1, generator=None):
    """x_i = phi x_{i-1} + w_i, w ~ N(0,1), x_0 = 0; (batch, n_obs) on
    ``generator``'s device."""
    w = torch.randn((n_obs, batch_size), generator=generator,
                    device=generator.device)
    return AR1_from_noise(phi, w)


@memoised
def observed_data(n_obs=200, true_params=None, seed_obs=None, device=None):
    """The observed series (n_obs,), the JAX package's draw: the
    innovations ``normal(key(seed_obs or 0), (n_obs, 1))`` through
    :func:`AR1_from_noise`, on ``device`` (None: the global backend's)."""
    k = observed_key(seed_obs, device)
    (phi,) = true_values(true_params or [.9], k.device)
    return first_row(AR1_from_noise(phi, threefry.normal(k, (n_obs, 1))))


def get_model(n_obs=200, true_params=None, seed_obs=None):
    """AR1 inference model."""
    y = observed_data(n_obs, true_params, seed_obs)
    m = Model(name="ar1")
    Prior("uniform", -1, 2, model=m, name="phi")
    Simulator(partial(AR1, n_obs=n_obs), m["phi"], observed=y, model=m,
              name="AR1")
    Distance("euclidean", m["AR1"], model=m, name="d")
    return m
