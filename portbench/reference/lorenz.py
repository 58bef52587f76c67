"""Plain reference of the Lorenz-96 configuration (Wilks 2005; Hakkarainen
et al. 2012; ELFI's ``elfi/examples/lorenz.py``): uniform priors on the
closure parameters (theta1, theta2), the stochastic Lorenz-96 system on
``n_obs`` periodic sites integrated by the classical fourth-order
Runge-Kutta method with an AR(1) closure noise held over each step, the
six summaries of the trajectory and their euclidean distance to the
observed trajectory's, in the precision asked for, batch by batch.

Written from the equations, not from the program: a site's neighbours are
found by index arithmetic modulo ``n_obs``.  The node names are the ones
the benchmark declares the model with (``portbench/models/lorenz.py``):
they key the streams.  Imports neither JAX nor the JAX package nor the
program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import streams

PARAMS = ("theta1", "theta2")
#: each parameter's prior range, the unit of a parameter gap
SCALES = (3.0, 0.3)


def neighbours(n, device):
    """The indices of each site's neighbours k - 2, k - 1 and k + 1 on the
    ring of ``n`` sites."""
    k = torch.arange(n, device=device)
    return (k - 2) % n, (k - 1) % n, (k + 1) % n


def tendency(y, eta, t1, t2, f, ring):
    """dy/dt of Lorenz-96 with the closure theta1 + theta2 y and the
    noise ``eta``: -y[k-2] y[k-1] + y[k-1] y[k+1] - y[k] + F - g + eta."""
    km2, km1, kp1 = ring
    left = y[:, km1]
    return (-y[:, km2] * left + left * y[:, kp1] - y
            + f - (t1 + t2 * y) + eta)


def rk4_step(y, dt, eta, t1, t2, f, ring):
    """One classical Runge-Kutta step of ``dt``, the noise held."""
    a = tendency(y, eta, t1, t2, f, ring)
    b = tendency(y + 0.5 * dt * a, eta, t1, t2, f, ring)
    c = tendency(y + 0.5 * dt * b, eta, t1, t2, f, ring)
    d = tendency(y + dt * c, eta, t1, t2, f, ring)
    return y + dt * (a + 2.0 * b + 2.0 * c + d) / 6.0


def trajectory(config, t1, t2, noise):
    """(batch, n_timestep, n_obs) from the initial state, each step's
    closure noise eta_t = phi eta_(t-1) + sqrt(1 - phi^2) e_t, eta_0 = 0,
    on the draws ``noise`` (n_timestep - 1, batch, n_obs)."""
    steps, batch, n = noise.shape
    dtype, device = noise.dtype, noise.device
    dt = config["total_duration"] / config["n_timestep"]
    phi, f = config["phi"], config["f"]
    scale = float(np.sqrt(1.0 - phi * phi))
    ring = neighbours(n, device)
    t1, t2 = t1.to(dtype)[:, None], t2.to(dtype)[:, None]
    out = torch.empty((batch, steps + 1, n), dtype=dtype, device=device)
    y = torch.as_tensor(np.asarray(config["initial_state"], np.float32),
                        device=device).to(dtype).expand(batch, n)
    out[:, 0] = y
    eta = torch.zeros((batch, n), dtype=dtype, device=device)
    for t in range(steps):
        eta = phi * eta + scale * noise[t]
        y = rk4_step(y, dt, eta, t1, t2, f, ring)
        out[:, t + 1] = y
    return out


def _centred(x):
    """``x`` less its mean over time, site by site."""
    return x - x.mean(dim=1, keepdim=True)


def summaries(x):
    """(batch, 6) of trajectories ``x`` (batch, time, sites): the mean; the
    variance over time, averaged over sites; the lag-one autocovariance in
    time; the covariance of each site with its right neighbour; the
    covariances of each site with its left and with its right neighbour
    one step later; each averaged over time and sites."""
    n = x.shape[2]
    _, left, right = neighbours(n, x.device)
    c = _centred(x)
    now, later = _centred(x[:, :-1]), _centred(x[:, 1:])
    cols = [x.mean(dim=(1, 2)),
            (c * c).mean(dim=(1, 2)),
            (now * later).mean(dim=(1, 2)),
            (c * c[:, :, right]).mean(dim=(1, 2)),
            (now * later[:, :, left]).mean(dim=(1, 2)),
            (now * later[:, :, right]).mean(dim=(1, 2))]
    return torch.stack(cols, dim=1)


def observed_summaries(config):
    """The observed trajectory's six summaries (float64)."""
    y = torch.as_tensor(np.asarray(config["observed"], np.float64))
    return summaries(y[None])[0].numpy()


def simulate(config, graph, seed, batch_index, batch_size, device,
             dtype=torch.float32, theta=None):
    """(theta (batch, 2), distance (batch,)) of one batch."""
    if graph != "plain":
        raise ValueError(f"no Lorenz-96 graph {graph!r}")
    if theta is None:
        theta = torch.stack(
            [lo + width * streams.node_uniform(seed, batch_index, p,
                                               batch_size, device)
             for p, (lo, width) in ((p, config["priors"][p])
                                    for p in PARAMS)], dim=1)
    theta = theta.to(dtype)
    noise = streams.node_normals(
        seed, batch_index, "Lorenz",
        (config["n_timestep"] - 1, batch_size, config["n_obs"]),
        device).to(dtype)
    x = trajectory(config, theta[:, 0], theta[:, 1], noise)
    del noise
    s = summaries(x)
    del x
    o = torch.as_tensor(observed_summaries(config), device=device).to(dtype)
    d = torch.sqrt(torch.sum((s - o) ** 2, dim=1))
    return theta, d
