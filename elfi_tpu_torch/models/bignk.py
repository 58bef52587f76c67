"""Bivariate g-and-k quantile distribution model in PyTorch (counterpart of
:mod:`elfi_tpu.models.bignk`; reference ``elfi/examples/bignk.py``).

The observed sample is the JAX package's draw for any setting: the two
normal columns come from the Threefry streams of ``key(seed_obs or seed or
0)`` and its ``fold_in(key, 1)``.  ``data/bignk_observed.npz`` holds the
JAX package's samples for ``seed_obs`` in {0, 3} (n_obs=150, the default
true parameters), the arrays the generator is held to.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..model.model import Discrepancy, Model, Prior, Simulator, Summary
from ..utils import threefry
from ._observed import first_row, memoised, observed_key, true_values
from .gnk import euclidean_multiss, ss_robust

__all__ = ["BiGNK", "BiGNK_from_noise", "get_model", "observed_data"]

#: the JAX package's samples, which the generator is held to
_DATA = Path(__file__).resolve().parent / "data" / "bignk_observed.npz"
EPS = np.finfo(float).eps
TRUE_PARAMS = (3, 4, 1, 0.5, 1, 2, .5, .4, 0.6)


def BiGNK(A1, A2, B1, B2, g1, g2, k1, k2, rho, c=.8, n_obs=150,
          batch_size=1, generator=None):
    """Sample the bivariate g-and-k distribution; (batch, n_obs, 2).

    Correlated standard normal pairs per batch member (correlation rho)
    are pushed through the per-dimension quantile function.  Both normal
    columns come from ``generator`` (the JAX package draws the second from
    ``fold_in(key, 1)``).
    """
    device = torch.as_tensor(A1).device
    z1 = torch.randn((batch_size, n_obs, 1), generator=generator,
                     device=device)
    z2 = torch.randn((batch_size, n_obs, 1), generator=generator,
                     device=device)
    return BiGNK_from_noise(A1, A2, B1, B2, g1, g2, k1, k2, rho, z1, z2, c)


def BiGNK_from_noise(A1, A2, B1, B2, g1, g2, k1, k2, rho, z1, z2, c=.8):
    """The bivariate g-and-k transform of the standard normal columns
    ``z1``, ``z2`` (batch, n_obs, 1); (batch, n_obs, 2)."""
    batch_size, device = z1.shape[0], z1.device

    def col(v):
        v = torch.as_tensor(v, dtype=torch.float32, device=device)
        return torch.broadcast_to(v, (batch_size,))[:, None]

    A = torch.stack([col(A1), col(A2)], dim=-1)   # (batch, 1, 2)
    B = torch.stack([col(B1), col(B2)], dim=-1)
    g = torch.stack([col(g1), col(g2)], dim=-1)
    k = torch.stack([col(k1), col(k2)], dim=-1)
    rho = col(rho)[:, :, None]                     # (batch, 1, 1)

    # correlated normals via the 2x2 Cholesky of [[1, rho], [rho, 1]]
    z = torch.cat([z1, rho * z1 + torch.sqrt(1 - rho ** 2) * z2], dim=-1)

    gz = g * z
    term_exp = (1 - torch.exp(-gz)) / (1 + torch.exp(-gz))
    return A + B * (1 + c * term_exp) * (1 + z ** 2) ** k * z


@memoised
def observed_data(n_obs=150, true_params=None, seed_obs=None, device=None):
    """The observed bivariate sample (n_obs, 2), the JAX package's draw:
    the columns ``normal(key, (1, n_obs, 1))`` and ``normal(fold_in(key,
    1), (1, n_obs, 1))`` of ``key = key(seed_obs or 0)`` through
    :func:`BiGNK_from_noise`, on ``device`` (None: the global
    backend's)."""
    k = observed_key(seed_obs, device)
    params = true_values(true_params or TRUE_PARAMS, k.device)
    z1 = threefry.normal(k, (1, n_obs, 1))
    z2 = threefry.normal(threefry.fold_in(k, 1), (1, n_obs, 1))
    return first_row(BiGNK_from_noise(*params, z1, z2))


def get_model(n_obs=150, true_params=None, seed=None, seed_obs=None):
    """Bivariate g-and-k inference model (reference ``bignk.py:111-159``)."""
    y_obs = observed_data(n_obs, true_params, seed_obs or seed)
    m = Model(name="bignk")
    bounds = [("a1", 0, 5), ("a2", 0, 5), ("b1", 0, 5), ("b2", 0, 5),
              ("g1", -5, 10), ("g2", -5, 10), ("k1", -.5, 5.5),
              ("k2", -.5, 5.5), ("rho", -1 + EPS, 2 - 2 * EPS)]
    priors = [Prior("uniform", lo, scale, model=m, name=n)
              for n, lo, scale in bounds]
    Simulator(partial(BiGNK, n_obs=n_obs), *priors, observed=y_obs, model=m,
              name="BiGNK")
    ss = Summary(ss_robust, m["BiGNK"], model=m, name="ss_robust")
    Discrepancy(euclidean_multiss, ss, model=m, name="d")
    return m
