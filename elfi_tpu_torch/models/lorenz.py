"""Stochastic Lorenz-96 model with parametrised closure in PyTorch (Wilks
2005, Hakkarainen et al. 2012; counterpart of
:mod:`elfi_tpu.models.lorenz`).

The simulator is a draw of the closure noise followed by the pure
transform :func:`forecast_lorenz_from_noise`: a loop of RK4 steps, each a
few batched ops on the (batch, n_obs) state.  The simulator and the six
summaries are marked ``capturable``: on a CUDA device the fused rejection
loop replays each full chunk of batches as one CUDA graph
(:mod:`elfi_tpu_torch.utils.capture`; a run shorter than a chunk runs
eagerly), so a call copies nothing from the host.  The initial state is put on a device once a process for each
setting (:func:`_initial_state`), the parameters arrive as device tensors
and are only reshaped, and the step, the noise's scale and the forcing
are Python floats.  The observed
trajectories are the JAX package's draws for any setting and initial
state: the closure noise comes from the Threefry stream of ``key(seed_obs
or 0)``; ``data/lorenz_observed.npz`` holds the JAX package's trajectories
the generator is held to (the system is chaotic over the 4 time units, so
the float32 rounding of the two packages' RK4 steps leaves a gap that
grows along the trajectory)."""

from __future__ import annotations

from functools import partial
from pathlib import Path

import numpy as np
import torch

from ..model.model import Distance, Model, Prior, Simulator, Summary
from ..utils import threefry
from ..utils.profiling import annotate
from ._observed import first_row, memoised, observed_key, true_values

__all__ = ["forecast_lorenz", "forecast_lorenz_from_noise", "get_model",
           "observed_data", "mean", "var", "cov", "xcov", "autocov"]

#: the JAX package's trajectories, which the generator is held to
_DATA = Path(__file__).resolve().parent / "data" / "lorenz_observed.npz"

# default initial state of Hakkarainen et al. (2012), 40 sites
_DEFAULT_INITIAL_STATE = np.array([
    2.40711741e-01, 4.75597337e+00, 1.19145654e+01, 1.31324866e+00,
    2.82675744e+00, 3.96016971e+00, 2.10479504e+00, 5.47742826e+00,
    5.42519447e+00, -1.45166074e+00, 2.01991521e+00, 3.93873313e+00,
    8.22837848e+00, 4.89401702e+00, -5.66278973e+00, 1.58617220e+00,
    -1.23849251e+00, -6.04649288e-01, 6.04132264e+00, 7.47588536e+00,
    1.82761402e+00, 3.19209639e+00, -7.58539653e-02, -6.00928508e-03,
    4.52902964e-01, 3.22063602e+00, 7.18613523e+00, 2.39210634e+00,
    -2.65743666e+00, 2.32046235e-01, 1.28079141e+00, 4.23344286e+00,
    6.94213238e+00, -1.15939497e+00, -5.23037351e-01, 1.54618811e+00,
    1.77863869e+00, 3.30139201e+00, 7.47769309e+00, -3.91312909e-01])


#: 1/6 in float32: a CUDA device divides a tensor by a host scalar as a
#: multiply by its reciprocal, and the CPU does the same here, so that the
#: chaotic trajectory is the same bits on both
_SIXTH = float(np.float32(1 / 6))


def _lorenz_ode(y, eta, theta1, theta2, f):
    """Lorenz-96 advection with the linear closure g = theta1 + theta2 y;
    periodic neighbours by ``torch.roll``."""
    y1 = torch.roll(y, 1, dims=1)
    adv = -torch.roll(y, 2, dims=1) * y1 + y1 * torch.roll(y, -1, dims=1)
    g = theta1 + y * theta2
    return adv - y + f - g + eta


def _rk4(y, time_step, eta, theta1, theta2, f):
    ode = partial(_lorenz_ode, eta=eta, theta1=theta1, theta2=theta2, f=f)
    k1 = time_step * ode(y)
    k2 = time_step * ode(y + k1 / 2)
    k3 = time_step * ode(y + k2 / 2)
    k4 = time_step * ode(y + k3)
    return y + (k1 + 2 * k2 + 2 * k3 + k4) * _SIXTH


#: each initial state on each device, made once (:func:`_initial_state`)
_INITIAL = {}


def _initial_state(initial_state, n_obs, device):
    """The float32 (n_obs,) initial state on ``device``: copied there at
    the first call with this state and device, the same tensor after
    that."""
    if initial_state is None:
        initial_state = _DEFAULT_INITIAL_STATE[:n_obs]
    y0 = np.asarray(initial_state, np.float32)
    key = (y0.shape, y0.tobytes(), str(device))
    if key not in _INITIAL:
        _INITIAL[key] = torch.as_tensor(y0, device=device)
    return _INITIAL[key]


def _column(theta, device):
    """A parameter as a float32 (batch, 1) column on ``device``: a
    program's float32 tensor there is reshaped, not copied."""
    return torch.as_tensor(theta, dtype=torch.float32,
                           device=device).reshape(-1, 1)


def forecast_lorenz_from_noise(theta1, theta2, es, f=10., phi=0.984,
                               initial_state=None, total_duration=4):
    """The stochastic Lorenz-96 trajectory on the closure noise ``es``
    (n_timestep - 1, batch, n_obs); returns (batch, n_timestep, n_obs)."""
    n_steps, batch_size, n_obs = es.shape
    device = es.device
    y = torch.broadcast_to(_initial_state(initial_state, n_obs, device),
                           (batch_size, n_obs))
    theta1, theta2 = _column(theta1, device), _column(theta2, device)
    time_step = total_duration / (n_steps + 1)
    # sqrt in float32, as jnp.sqrt of a Python float
    root = float(np.sqrt(np.float32(1 - phi ** 2)))
    eta = torch.zeros_like(y)
    ys = [y]
    for e in es:
        eta = phi * eta + e * root
        y = _rk4(y, time_step, eta, theta1, theta2, f)
        ys.append(y)
    return torch.stack(ys, dim=1)


def forecast_lorenz(theta1=None, theta2=None, f=10., phi=0.984, n_obs=40,
                    n_timestep=160, batch_size=1, initial_state=None,
                    generator=None, total_duration=4):
    """(batch, n_timestep, n_obs) trajectories on ``generator``'s
    device; one span ``elfi.sim`` where a profiler records an eager run
    (a replayed graph runs no Python)."""
    with annotate("elfi.sim"):
        es = torch.randn((n_timestep - 1, batch_size, n_obs),
                         generator=generator, device=generator.device)
        return forecast_lorenz_from_noise(theta1, theta2, es, f, phi,
                                          initial_state, total_duration)


def mean(x):
    return torch.mean(x, dim=(1, 2))


def var(x):
    return torch.mean(torch.var(x, dim=1, correction=0), dim=1)


def cov(x):
    x_next = torch.roll(x, -1, dims=2)
    return torch.mean(torch.mean(
        (x - torch.mean(x, dim=1, keepdim=True))
        * (x_next - torch.mean(x_next, dim=1, keepdim=True)), dim=1), dim=1)


def xcov(x, prev=True):
    x_lag = torch.roll(x, 1 if prev else -1, dims=2)
    a, b = x[:, :-1, :], x_lag[:, 1:, :]
    return torch.mean((a - torch.mean(a, dim=1, keepdim=True))
                      * (b - torch.mean(b, dim=1, keepdim=True)), dim=(1, 2))


def autocov(x):
    a, b = x[:, :-1, :], x[:, 1:, :]
    return torch.mean((a - torch.mean(a, dim=1, keepdim=True))
                      * (b - torch.mean(b, dim=1, keepdim=True)), dim=(1, 2))


#: the simulator and the summaries draw only through their generator,
#: never read the device back and copy nothing from the host in a call
#: (the initial state is made once a device): the model's programs may be
#: captured as CUDA graphs (``CompiledProgram.jitted``)
for _op in (forecast_lorenz, mean, var, cov, xcov, autocov):
    _op.capturable = True


@memoised
def observed_data(true_params=None, seed_obs=None, n_obs=40, f=10.,
                  phi=0.984, total_duration=4, n_timestep=160,
                  initial_state=None, device=None):
    """The observed trajectory (n_timestep, n_obs), the JAX package's draw:
    the closure noise ``normal(key(seed_obs or 0), (n_timestep - 1, 1,
    n_obs))`` through :func:`forecast_lorenz_from_noise`, on ``device``
    (None: the global backend's)."""
    k = observed_key(seed_obs, device)
    theta1, theta2 = true_values(true_params or [2.0, 0.1], k.device)
    es = threefry.normal(k, (n_timestep - 1, 1, n_obs))
    return first_row(forecast_lorenz_from_noise(
        theta1, theta2, es, f, phi, initial_state, total_duration))


def get_model(true_params=None, seed_obs=None, initial_state=None, n_obs=40,
              f=10., phi=0.984, total_duration=4, n_timestep=160):
    """Lorenz-96 closure-parameter inference model."""
    y_obs = observed_data(true_params, seed_obs, n_obs, f, phi,
                          total_duration, n_timestep, initial_state)
    simulator = partial(forecast_lorenz, initial_state=initial_state, f=f,
                        n_obs=n_obs, phi=phi, total_duration=total_duration,
                        n_timestep=n_timestep)
    m = Model(name="lorenz")
    Prior("uniform", 0.5, 3., model=m, name="theta1")
    Prior("uniform", 0, 0.3, model=m, name="theta2")
    Simulator(simulator, m["theta1"], m["theta2"], observed=y_obs, model=m,
              name="Lorenz")
    ss = [Summary(mean, m["Lorenz"], model=m, name="Mean"),
          Summary(var, m["Lorenz"], model=m, name="Var"),
          Summary(autocov, m["Lorenz"], model=m, name="Autocov"),
          Summary(cov, m["Lorenz"], model=m, name="Cov"),
          Summary(partial(xcov, prev=True), m["Lorenz"], model=m,
                  name="CrosscovPrev"),
          Summary(partial(xcov, prev=False), m["Lorenz"], model=m,
                  name="CrosscovNext")]
    Distance("euclidean", *ss, model=m, name="d")
    return m
