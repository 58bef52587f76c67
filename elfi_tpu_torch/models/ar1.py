"""AR(1) example model in PyTorch (counterpart of
:mod:`elfi_tpu.models.ar1`; reference ``elfi/examples/ar1.py``).

The simulator is a draw of the innovations followed by the pure recursion
:func:`AR1_from_noise`, an eager loop over the time axis (the JAX
package's ``lax.scan``).  The observed series are the JAX package's
(``data/ar1_observed.npz``), for the stored settings only."""

from __future__ import annotations

from functools import partial
from pathlib import Path

import torch

from ..model.model import Distance, Model, Prior, Simulator
from ._observed import load_observed_setting
from ._stats import batch_param

__all__ = ["AR1", "AR1_from_noise", "get_model", "observed_data"]

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


def observed_data(n_obs=200, true_params=None, seed_obs=None):
    """The JAX package's observed series for this setting."""
    return load_observed_setting(_DATA, n_obs=n_obs, true_params=true_params
                                 or [.9], seed_obs=seed_obs)


def get_model(n_obs=200, true_params=None, seed_obs=None):
    """AR1 inference model."""
    y = observed_data(n_obs, true_params, seed_obs)
    m = Model(name="ar1")
    Prior("uniform", -1, 2, model=m, name="phi")
    Simulator(partial(AR1, n_obs=n_obs), m["phi"], observed=y, model=m,
              name="AR1")
    Distance("euclidean", m["AR1"], model=m, name="d")
    return m
