"""Alpha-stable stochastic volatility model in PyTorch (Vankov et al.
2019, Priddle & Drovandi 2020; counterpart of
:mod:`elfi_tpu.models.stochastic_volatility`).

The simulator is a draw (the log-volatility normals and the
:class:`~elfi_tpu_torch.ops.distributions.levy_stable` angles and
exponentials) followed by the pure transform :func:`svm_from_noise`; the
AR(1) log-volatility is an eager loop over the time axis.  The observed
series are the JAX package's draws for any setting, from the Threefry
streams of ``key(seed_obs or 0)``;
``data/stochastic_volatility_observed.npz`` holds the JAX package's series
the generator is held to.
"""

from __future__ import annotations

from functools import partial
from pathlib import Path

import torch

from ..model.model import Constant, Distance, Model, Prior, Simulator, \
    Summary
from ..ops.distributions import levy_stable
from ..utils import threefry
from ._observed import first_row, memoised, observed_key, true_values
from ._stats import batch_param, quantiles

__all__ = ["log_vol", "shock_term", "log_vol_from_noise", "svm_from_noise",
           "alpha_stochastic_volatility_model", "get_model",
           "observed_data", "kurt", "skew"]

#: the JAX package's arrays, which the generator is held to
_DATA = Path(__file__).resolve().parent / "data" / \
    "stochastic_volatility_observed.npz"


def log_vol_from_noise(mu, phi, sigma, z0, ws, prev_x=None):
    """AR(1) log-volatilities in mean/difference form on the normals ``z0``
    (batch,) and ``ws`` (n_obs - 1, batch); returns (batch, n_obs)."""
    b = z0.shape[0]
    mu, phi, sigma = (batch_param(v, b, z0.device) for v in (mu, phi, sigma))
    if prev_x is None:
        scale0 = sigma / torch.sqrt(1 - torch.clamp(phi ** 2, max=0.99999))
        x = mu + scale0 * z0
    else:
        x = mu + phi * (prev_x - mu) + sigma * z0
    xs = [x]
    for w in ws:
        x = mu + phi * (x - mu) + sigma * w
        xs.append(x)
    return torch.stack(xs, dim=1)


def log_vol(mu, phi, sigma, n_obs, batch_size=1, generator=None,
            prev_x=None):
    """AR(1) log-volatilities in mean/difference form; (batch, n_obs) on
    ``generator``'s device: the normals drawn, then
    :func:`log_vol_from_noise`."""
    device = generator.device
    z0 = torch.randn((batch_size,), generator=generator, device=device)
    ws = torch.randn((n_obs - 1, batch_size), generator=generator,
                     device=device)
    return log_vol_from_noise(mu, phi, sigma, z0, ws, prev_x)


def shock_term(alpha, beta, kappa, eta, n_obs, batch_size=1, generator=None):
    """Alpha-stable shocks (S0, location ``eta``, scale ``kappa``);
    (batch, n_obs) on ``generator``'s device: the angles and exponentials
    drawn, then :meth:`levy_stable.transform`."""
    U, W = levy_stable.draw((batch_size, n_obs), generator)
    alpha = torch.as_tensor(alpha, dtype=torch.float32,
                            device=U.device).reshape(-1, 1)
    beta = torch.as_tensor(beta, dtype=torch.float32,
                           device=U.device).reshape(-1, 1)
    return levy_stable.transform(U, W, alpha, beta, eta, kappa)


def svm_from_noise(alpha, beta, z0, ws, U, W, kappa=1., eta=0., mu=0.,
                   phi=.95, sigma=.2, x_0=None):
    """y_t = exp(x_t / 2) v_t with the log-volatility of
    :func:`log_vol_from_noise` and alpha-stable shocks ``v`` (S0, location
    ``eta``, scale ``kappa``) from ``U`` and ``W`` (batch, n_obs)."""
    x = log_vol_from_noise(mu, phi, sigma, z0, ws, x_0)
    alpha = torch.as_tensor(alpha, dtype=torch.float32,
                            device=U.device).reshape(-1, 1)
    beta = torch.as_tensor(beta, dtype=torch.float32,
                           device=U.device).reshape(-1, 1)
    v = levy_stable.transform(U, W, alpha, beta, eta, kappa)
    return torch.exp(0.5 * x) * v


def alpha_stochastic_volatility_model(alpha, beta, kappa=1., eta=0., mu=0.,
                                      phi=.95, sigma=.2, n_obs=50, x_0=None,
                                      batch_size=1, generator=None):
    """(batch, n_obs) returns on ``generator``'s device."""
    device = generator.device
    z0 = torch.randn((batch_size,), generator=generator, device=device)
    ws = torch.randn((n_obs - 1, batch_size), generator=generator,
                     device=device)
    U, W = levy_stable.draw((batch_size, n_obs), generator)
    return svm_from_noise(alpha, beta, z0, ws, U, W, kappa, eta, mu, phi,
                          sigma, x_0)


def kurt(x):
    """Robust kurtosis from quantiles; (batch,)."""
    qs = quantiles(x, [0.05, 0.25, 0.75, 0.95])
    return (qs[3] - qs[0]) / (qs[2] - qs[1])


def skew(x):
    """Robust skewness from quantiles; (batch,)."""
    qs = quantiles(x, [0.05, 0.50, 0.95])
    return ((qs[2] - qs[1]) - (qs[1] - qs[0])) / (qs[2] - qs[0])


#: the model's fixed arguments, constants of its graph
FIXED = {"kappa": 1, "eta": 0, "mu": 0, "phi": 0.95, "sigma": 0.2}


@memoised
def observed_data(n_obs=50, true_params=None, seed_obs=None, device=None):
    """The observed series (n_obs,), the JAX package's draw: with ``k1, k2
    = split(key(seed_obs or 0))``, the log-volatility normals from
    ``split(k1)`` (``(1,)`` and ``(n_obs - 1, 1)``) and the alpha-stable
    ``(U, W)`` of ``k2`` (``(1, n_obs)``) through :func:`svm_from_noise`,
    on ``device`` (None: the global backend's)."""
    k1, k2 = threefry.split(observed_key(seed_obs, device))
    alpha, beta = true_values(true_params or [1.2, 0.5], k1.device)
    kz, kw = threefry.split(k1)
    U, W = levy_stable.draw_from_key(k2, (1, n_obs))
    return first_row(svm_from_noise(
        alpha, beta, threefry.normal(kz, (1,)),
        threefry.normal(kw, (n_obs - 1, 1)), U, W, **FIXED))


def get_model(n_obs=50, true_params=None, seed_obs=None):
    """SVM inference model for (alpha, beta)."""
    y_obs = observed_data(n_obs, true_params, seed_obs)
    fixed = FIXED
    m = Model(name="a_svm")
    Prior("uniform", 0.5, 1.5, model=m, name="alpha")
    Prior("uniform", -1, 2, model=m, name="beta")
    constants = [Constant(v, model=m, name=k) for k, v in fixed.items()]
    Simulator(partial(alpha_stochastic_volatility_model, n_obs=n_obs),
              m["alpha"], m["beta"], *constants, observed=y_obs, model=m,
              name="a_svm")
    Summary(kurt, m["a_svm"], model=m, name="kurt")
    Summary(skew, m["a_svm"], model=m, name="skew")
    Distance("euclidean", m["kurt"], m["skew"], model=m, name="d")
    return m
