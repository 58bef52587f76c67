"""Gaussian noise example models in PyTorch (counterpart of
:mod:`elfi_tpu.models.gauss`; reference ``elfi/examples/gauss.py``).

The observed sample must be the JAX package's: the bench gates downstream
were set on the ``y`` that ``jax.random.key(seed_obs or 0)`` draws.
:func:`observed_data` draws the same normals from the Threefry stream of
that key, for any setting and any SPD ``cov_matrix``.
``data/gauss_observed.npz`` holds the JAX package's draws, made on the CPU
with ``elfi_tpu.models.gauss``, for these settings (n_obs=50 in both), the
arrays the generator is held to:

- ``nd_seed_0``: the 2-D mean model of the bench's SMC phase,
  ``nd_mean=True``, ``true_params=[4.0, 2.0]``, ``cov_matrix=eye(2)``,
  ``seed_obs`` None (0);
- ``1d_seed_<s>``: the 1-D model at its defaults, ``true_params=[4, .4]``,
  for ``seed_obs`` in {0, 3}.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..model.model import Discrepancy, Distance, Model, Prior, Simulator, \
    Summary
from ..utils import threefry
from ._observed import first_row, memoised, observed_key, true_values

__all__ = ["gauss", "gauss_nd_mean", "get_model", "ss_mean", "ss_var",
           "euclidean_multidim"]

#: the JAX package's samples, which the generator is held to
_DATA = Path(__file__).resolve().parent / "data" / "gauss_observed.npz"


def gauss(mu, sigma, n_obs=50, batch_size=1, generator=None):
    """1-D Gaussian observations; (batch, n_obs) on ``mu``'s device."""
    mu = torch.as_tensor(mu)
    return _gauss_from_noise(mu, sigma, torch.randn(
        (batch_size, n_obs), generator=generator, device=mu.device))


def _gauss_from_noise(mu, sigma, z):
    """``mu + sigma z`` on the standard normals ``z`` (batch, n_obs)."""
    mu = torch.as_tensor(mu).reshape(-1, 1)
    sigma = torch.as_tensor(sigma).reshape(-1, 1)
    return mu + sigma * z


def _nd_mean(mu, L, n_obs, batch_size, generator):
    z = torch.randn((batch_size, n_obs, len(mu)), generator=generator,
                    device=torch.as_tensor(mu[0]).device)
    return _nd_mean_from_noise(mu, L, z)


def _nd_mean_from_noise(mu, L, z):
    """``mu + z L^T`` on the standard normals ``z`` (batch, n_obs,
    n_dim)."""
    mus = torch.stack([torch.broadcast_to(torch.as_tensor(m).float(),
                                          (z.shape[0],)) for m in mu], dim=1)
    return mus[:, None, :] + z @ L.T


def gauss_nd_mean(*mu, cov_matrix, n_obs=15, batch_size=1, generator=None):
    """n-D Gaussian with unknown mean; (batch, n_obs, n_dim)."""
    device = torch.as_tensor(mu[0]).device
    L = torch.linalg.cholesky_ex(torch.as_tensor(
        cov_matrix, dtype=torch.float32, device=device)).L
    return _nd_mean(mu, L, n_obs, batch_size, generator)


class _GaussNdMean:
    """``gauss_nd_mean`` as the model's simulator: the Cholesky factor of
    ``cov_matrix`` is put on each device once, so a batch copies nothing
    from the host (such a copy waits for the device)."""

    def __init__(self, cov_matrix, n_obs):
        self.L = np.linalg.cholesky(np.asarray(cov_matrix, np.float32))
        self.n_obs = n_obs
        self._L_on = {}

    def __getstate__(self):
        # the per-device copies are rebuilt on first use after loading
        return {**self.__dict__, "_L_on": {}}

    def __call__(self, *mu, batch_size=1, generator=None):
        device = torch.as_tensor(mu[0]).device
        if device not in self._L_on:
            self._L_on[device] = torch.as_tensor(self.L, device=device)
        return _nd_mean(mu, self._L_on[device], self.n_obs, batch_size,
                        generator)


def ss_mean(y):
    return torch.mean(y, dim=1)


def ss_var(y):
    """Population variance along axis 1, as ``jnp.var`` forms it."""
    centered = y - torch.mean(y, dim=1, keepdim=True)
    return torch.mean(centered * centered, dim=1)


def euclidean_multidim(*simulated, observed):
    """Euclidean distance merging data dimensions (reference
    ``gauss.py:176-198``)."""
    d2 = 0.0
    for s, o in zip(simulated, observed):
        s = torch.as_tensor(s)
        d2 = d2 + torch.sum((s - o) ** 2, dim=tuple(range(1, s.ndim)))
    return torch.sqrt(d2)


#: the ops above draw only through their generator, never read the device
#: back and copy nothing from the host in a call: the model's programs may
#: be captured as CUDA graphs (``CompiledProgram.jitted``)
for _op in (gauss, _GaussNdMean, ss_mean, ss_var, euclidean_multidim):
    _op.capturable = True


@memoised
def observed_data(n_obs=50, true_params=None, seed_obs=None, nd_mean=False,
                  cov_matrix=None, device=None):
    """The observed sample, the JAX package's draw: the normals
    ``normal(key(seed_obs or 0), (1, n_obs))`` (1-D) or ``(1, n_obs,
    n_dim)`` times the float32 Cholesky factor of ``cov_matrix`` (n-D), on
    ``device`` (None: the global backend's)."""
    if true_params is None:
        true_params = [4, 4] if nd_mean else [4, .4]
    k = observed_key(seed_obs, device)
    params = true_values(true_params, k.device)
    if nd_mean:
        L = torch.as_tensor(np.linalg.cholesky(
            np.asarray(cov_matrix, np.float32)), device=k.device)
        z = threefry.normal(k, (1, n_obs, len(params)))
        return first_row(_nd_mean_from_noise(params, L, z))
    return first_row(_gauss_from_noise(*params,
                                       threefry.normal(k, (1, n_obs))))


def get_model(n_obs=50, true_params=None, seed_obs=None, nd_mean=False,
              cov_matrix=None):
    """Gaussian noise model, 1-D (mu, sigma) or n-D mean (reference
    ``gauss.py:76-140``)."""
    if true_params is None:
        true_params = [4, 4] if nd_mean else [4, .4]
    y_obs = observed_data(n_obs, true_params, seed_obs, nd_mean, cov_matrix)
    if nd_mean:
        fn = _GaussNdMean(cov_matrix, n_obs)
    else:
        fn = partial(gauss, n_obs=n_obs)

    m = Model(name="gauss")
    eps_prior = 5
    priors = []
    if nd_mean:
        for i, tp in enumerate(true_params):
            priors.append(Prior("uniform", tp - eps_prior, 2 * eps_prior,
                                model=m, name=f"mu_{i}"))
    else:
        priors.append(Prior("uniform", true_params[0] - eps_prior,
                            2 * eps_prior, model=m, name="mu"))
        priors.append(Prior("truncnorm", max(.01, true_params[1] - eps_prior),
                            2 * eps_prior, model=m, name="sigma"))
    Simulator(fn, *priors, observed=y_obs, model=m, name="gauss")
    s1 = Summary(ss_mean, m["gauss"], model=m, name="ss_mean")
    s2 = Summary(ss_var, m["gauss"], model=m, name="ss_var")
    if nd_mean:
        Discrepancy(euclidean_multidim, s1, s2, model=m, name="d")
    else:
        Distance("euclidean", s1, s2, model=m, name="d")
    return m
