"""Univariate g-and-k quantile distribution model in PyTorch (counterpart of
:mod:`elfi_tpu.models.gnk`; reference ``elfi/examples/gnk.py``).

The observed sample must be the JAX package's: the gates downstream were
set on the ``y`` that ``jax.random.key(seed_obs or seed or 0)`` draws.
:func:`observed_data` draws the same normals from the Threefry stream of
that key, for any setting; ``data/gnk_observed.npz`` holds the JAX
package's samples for ``seed_obs`` in {0, 1, 2, 3} (n_obs=50, true
parameters (3, 1, 2, 0.5)), the arrays the generator is held to.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..model.model import Discrepancy, Model, Prior, Simulator, Summary
from ..ops.kernels.order_stats import sort_rows
from ..utils import threefry
from ._observed import first_row, memoised, observed_key, true_values

__all__ = ["GNK", "gnk_quantile", "get_model", "observed_data", "ss_order",
           "ss_robust", "ss_octile", "ss_octile_sq", "euclidean_multiss"]

#: the JAX package's samples, which the generator is held to
_DATA = Path(__file__).resolve().parent / "data" / "gnk_observed.npz"
TRUE_PARAMS = (3, 1, 2, .5)
#: the octiles' percentages, as ``jnp.linspace(12.5, 87.5, 7)`` gives them
_OCTILES = np.linspace(12.5, 87.5, 7, dtype=np.float32)


def gnk_quantile(z, A, B, g, k, c=0.8):
    """The g-and-k quantile function at standard normal ``z`` (batch, n),
    in the JAX ``GNK``'s form and order of operations; ``A`` .. ``k`` are
    (batch,) or scalars."""
    A, B, g, k = (torch.as_tensor(p).reshape(-1, 1) for p in (A, B, g, k))
    e = torch.exp(-g * z)
    return A + B * (1 + c * ((1 - e) / (1 + e))) * (1 + z ** 2) ** k * z


def GNK(A, B, g, k, c=0.8, n_obs=50, batch_size=1, generator=None):
    """Sample the g-and-k distribution by evaluating its quantile function
    at standard normal draws; (batch, n_obs, 1) on ``A``'s device."""
    A = torch.as_tensor(A)
    z = torch.randn((batch_size, n_obs), generator=generator,
                    device=A.device)
    return gnk_quantile(z, A, B, g, k, c)[:, :, None]


def euclidean_multiss(*simulated, observed):
    """Euclidean distance merging summary dims (reference
    ``gnk.py:116-142``)."""
    d2 = 0.0
    for s, o in zip(simulated, observed):
        s = torch.as_tensor(s)
        d2 = d2 + torch.sum((s - o) ** 2, dim=tuple(range(1, s.ndim)))
    return torch.sqrt(d2)


def ss_order(y):
    """Order statistics summary (Allingham et al. 2009): ``y`` sorted along
    dim 1, on the card by a short-row sort kernel where it takes ``y``
    (:func:`~elfi_tpu_torch.ops.kernels.order_stats.sort_rows`), else by
    ``torch.sort``."""
    return sort_rows(y)


def _percentiles(y, qs):
    """``jnp.percentile(y, qs, axis=1)`` (linear interpolation), shape
    (len(qs), batch, ...): one sort, then two gathers per percentage with
    the JAX package's float32 weights.  A row holding a NaN gives NaN, as
    there.  ``torch.quantile`` is not used: it refuses inputs above 2^24
    elements, which a batch of 2^19 samples of 50 already exceeds."""
    n = y.shape[1]
    ys = torch.sort(y, dim=1).values
    ys = torch.where(torch.isnan(ys).any(dim=1, keepdim=True), torch.nan, ys)
    pos = np.asarray(qs, np.float32) / np.float32(100) * np.float32(n - 1)
    low = np.clip(np.floor(pos), 0, n - 1)
    high = np.clip(np.ceil(pos), 0, n - 1)
    w_high = pos - np.floor(pos)
    w_low = np.float32(1) - w_high
    return torch.stack([ys[:, int(lo)] * float(wl)
                        + ys[:, int(hi)] * float(wh)
                        for lo, hi, wl, wh in zip(low, high, w_low, w_high)])


def _ss_B(y):
    L1, L3 = _percentiles(y, [25., 75.])
    return torch.where(L3 - L1 == 0, torch.finfo(torch.float32).eps, L3 - L1)


def ss_robust(y):
    """Robust 4-stat summary (Drovandi & Pettitt 2011); shape
    (batch, 4, dim)."""
    L1, L2, L3 = _percentiles(y, [25., 50., 75.])
    E1, E3, E5, E7 = _percentiles(y, [12.5, 37.5, 62.5, 87.5])
    B = _ss_B(y)
    ss_A = L2
    ss_g = (L3 + L1 - 2 * L2) / B
    ss_k = (E7 - E5 + E3 - E1) / B
    return torch.stack([ss_A, B, ss_g, ss_k], dim=1).reshape(
        y.shape[0], 4, -1)


def ss_octile(y):
    """Octile summary; shape (batch, 7, dim)."""
    E = _percentiles(y, _OCTILES)  # (7, batch, dim)
    return torch.movedim(E, 0, 1).reshape(y.shape[0], 7, -1)


def ss_octile_sq(y):
    """Octiles and their squares (14 features), the JAX package's feature
    map for classifier-based ratio estimation."""
    o = ss_octile(y).reshape(y.shape[0], -1)
    return torch.cat([o, o * o], dim=1)


#: the ops above draw only through their generator, never read the device
#: back and copy nothing from the host in a call: the model's programs may
#: be captured as CUDA graphs (``CompiledProgram.jitted``)
for _op in (GNK, ss_order, euclidean_multiss):
    _op.capturable = True


@memoised
def observed_data(n_obs=50, true_params=None, seed_obs=None, device=None):
    """The observed g-and-k sample (n_obs, 1), the JAX package's draw: the
    normals ``normal(key(seed_obs or 0), (1, n_obs))`` through
    :func:`gnk_quantile`, on ``device`` (None: the global backend's)."""
    k = observed_key(seed_obs, device)
    params = true_values(true_params or TRUE_PARAMS, k.device)
    z = threefry.normal(k, (1, n_obs))
    return first_row(gnk_quantile(z, *params)[:, :, None])


def get_model(n_obs=50, true_params=None, seed=None, seed_obs=None):
    """g-and-k inference model (reference ``gnk.py:72-114``)."""
    y_obs = observed_data(n_obs, true_params, seed_obs or seed)
    m = Model(name="gnk")
    priors = [Prior("uniform", 0, 10, model=m, name=n)
              for n in ["A", "B", "g", "k"]]
    Simulator(partial(GNK, n_obs=n_obs), *priors, observed=y_obs, model=m,
              name="GNK")
    ss = Summary(ss_order, m["GNK"], model=m, name="ss_order")
    Discrepancy(euclidean_multiss, ss, model=m, name="d")
    return m
