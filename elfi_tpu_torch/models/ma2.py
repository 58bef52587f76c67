"""Moving-average(2) example model in PyTorch (counterpart of
:mod:`elfi_tpu.models.ma2`): prior -> simulator -> two autocovariance
summaries -> euclidean distance.

The observed series must be the JAX package's: the accuracy gate at
``seed_obs=271`` was calibrated for that exact ``y``.  :func:`observed_data`
draws its noise from the Threefry stream of ``key(seed_obs or 0)``, as
``jax.random`` does, for any setting; ``data/ma2_observed.npz`` holds the
JAX package's series for ``seed_obs`` in {0, 4, 271}, the arrays the
generator is held to.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..model.model import Distance, Model, Prior, Simulator, Summary
from ..ops.distributions import Distribution, draw_device
from ..utils import threefry
from ._observed import first_row, memoised, observed_key, true_values

__all__ = ["MA2", "MA2_from_noise", "autocov", "get_model", "observed_data",
           "CustomPrior1", "CustomPrior2"]

#: the JAX package's series, which the generator is held to
_DATA = Path(__file__).resolve().parent / "data" / "ma2_observed.npz"


def MA2_from_noise(t1, t2, w):
    """x_i = w_i + t1 w_{i-1} + t2 w_{i-2} on the normals ``w`` (batch,
    n_obs + 2); ``t1``/``t2`` are (batch,) tensors."""
    t1 = torch.as_tensor(t1).reshape(-1, 1)
    t2 = torch.as_tensor(t2).reshape(-1, 1)
    return w[:, 2:] + t1 * w[:, 1:-1] + t2 * w[:, :-2]


def MA2(t1, t2, n_obs=100, batch_size=1, generator=None):
    r"""x_i = w_i + t1 w_{i-1} + t2 w_{i-2}, w ~ N(0,1) i.i.d.

    Batched: ``t1``/``t2`` are (batch,) tensors; returns (batch, n_obs) on
    ``generator``'s device.
    """
    t1 = torch.as_tensor(t1)
    w = torch.randn((batch_size, n_obs + 2), generator=generator,
                    device=t1.device)
    return MA2_from_noise(t1, t2, w)


def autocov(x, lag=1):
    """Autocovariance at ``lag`` assuming zero-mean stationarity; rows are
    realizations."""
    x = torch.atleast_2d(torch.as_tensor(x))
    return torch.mean(x[:, lag:] * x[:, :-lag], dim=1)


class CustomPrior1(Distribution):
    """Triangular prior for t1 on [-b, b] (Marin et al. 2012)."""

    @classmethod
    def rvs(cls, b, size=1, generator=None):
        u = torch.rand((size,), generator=generator,
                       device=draw_device(generator))
        return torch.where(u < 0.5,
                           torch.sqrt(2. * u) * b - b,
                           -torch.sqrt(2. * (1. - u)) * b + b)

    @classmethod
    def pdf(cls, x, b):
        p = 1. / b - torch.abs(torch.as_tensor(x)) / (b * b)
        return torch.where(p < 0., 0., p)


class CustomPrior2(Distribution):
    """Prior for t2 | t1 on a triangle (Marin et al. 2012)."""

    @classmethod
    def rvs(cls, t1, a, size=1, generator=None):
        t1 = torch.as_tensor(t1)
        locs = torch.maximum(-a - t1, -a + t1)
        scales = a - locs
        shape = np.broadcast_shapes((size,), t1.shape)
        u = torch.rand(shape, generator=generator, device=t1.device)
        return locs + scales * u

    @classmethod
    def pdf(cls, x, t1, a):
        x, t1 = torch.as_tensor(x), torch.as_tensor(t1)
        locs = torch.maximum(-a - t1, -a + t1)
        scales = a - locs
        return ((x >= locs) * (x <= locs + scales)
                * 1.0 / torch.where(scales > 0, scales, 1))


#: the ops above draw only through their generator, never read the device
#: back and copy nothing from the host in a call: the model's programs may
#: be captured as CUDA graphs (``CompiledProgram.jitted``)
for _op in (MA2, autocov, CustomPrior1, CustomPrior2):
    _op.capturable = True


@memoised
def observed_data(n_obs=100, true_params=None, seed_obs=None, device=None):
    """The observed MA2 series (n_obs,), the JAX package's draw: the
    normals ``normal(key(seed_obs or 0), (1, n_obs + 2))`` through
    :func:`MA2_from_noise`, on ``device`` (None: the global backend's)."""
    k = observed_key(seed_obs, device)
    t1, t2 = true_values(true_params or (.6, .2), k.device)
    return first_row(MA2_from_noise(t1, t2,
                                    threefry.normal(k, (1, n_obs + 2))))


def get_model(n_obs=100, true_params=None, seed_obs=None):
    """Complete MA2 inference model."""
    y = observed_data(n_obs, true_params, seed_obs)
    sim_fn = partial(MA2, n_obs=n_obs)

    m = Model(name="MA2_model")
    Prior(CustomPrior1, 2, model=m, name="t1")
    Prior(CustomPrior2, m["t1"], 1, model=m, name="t2")
    Simulator(sim_fn, m["t1"], m["t2"], observed=y, model=m, name="MA2")
    Summary(autocov, m["MA2"], model=m, name="S1")
    Summary(partial(autocov, lag=2), m["MA2"], model=m, name="S2")
    Distance("euclidean", m["S1"], m["S2"], model=m, name="d")
    return m
