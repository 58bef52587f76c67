"""Plain reference of the MA(2) configuration (Marin et al. 2012; ELFI's
``elfi/examples/ma2.py``): the triangle prior, the MA(2) series, its lag-1
and lag-2 autocovariances and their euclidean distance to the observed
ones, in the precision asked for, batch by batch.

The node names are the ones the benchmark declares the model with
(``portbench/models/ma2.py``): they key the streams.  Imports neither JAX
nor the JAX package nor the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import streams

PARAMS = ("t1", "t2")
#: each parameter's prior range, the unit of a parameter gap
SCALES = (4.0, 2.0)


def observed_summaries(config):
    """The observed lag-1 and lag-2 autocovariances (float64)."""
    y = np.asarray(config["observed"], np.float64)
    return np.array([np.mean(y[1:] * y[:-1]), np.mean(y[2:] * y[:-2])])


def prior_draw(u1, u2, dtype):
    """t1 on the triangle's base [-2, 2], then t2 given t1, from the
    uniforms u1, u2 (the program's inverse transforms)."""
    b, a = 2.0, 1.0
    u1, u2 = u1.to(dtype), u2.to(dtype)
    t1 = torch.where(u1 < 0.5, torch.sqrt(2.0 * u1) * b - b,
                     -torch.sqrt(2.0 * (1.0 - u1)) * b + b)
    locs = torch.maximum(-a - t1, -a + t1)
    t2 = locs + (a - locs) * u2
    return t1, t2


def noise(config, graph, seed, batch_index, batch_size, device, dtype):
    """The (batch, n_obs + 2) normals a batch's simulator draws: a distance
    kernel's Philox stream on the card (its plain version draws
    ``torch.randn`` off it), or the simulator node's ``torch.randn``."""
    n_w = config["n_obs"] + 2
    if graph == "kernel" and torch.device(device).type == "cuda":
        return streams.philox_normals(
            streams.stream_seed(seed, batch_index, "d"), batch_size, n_w,
            device, dtype)
    name = "d" if graph == "kernel" else "MA2"
    return streams.node_normals(seed, batch_index, name, (batch_size, n_w),
                                device).to(dtype)


def simulate(config, graph, seed, batch_index, batch_size, device,
             dtype=torch.float32, theta=None):
    """(theta (batch, 2), distance (batch,)) of one batch: the parameters
    from the prior's streams, or ``theta`` where a round proposes them."""
    if theta is None:
        t1, t2 = prior_draw(
            streams.node_uniform(seed, batch_index, "t1", batch_size, device),
            streams.node_uniform(seed, batch_index, "t2", batch_size, device),
            dtype)
    else:
        t1, t2 = theta[:, 0].to(dtype), theta[:, 1].to(dtype)
    w = noise(config, graph, seed, batch_index, batch_size, device, dtype)
    x = w[:, 2:] + t1[:, None] * w[:, 1:-1] + t2[:, None] * w[:, :-2]
    s1 = torch.mean(x[:, 1:] * x[:, :-1], dim=1)
    s2 = torch.mean(x[:, 2:] * x[:, :-2], dim=1)
    o = torch.as_tensor(observed_summaries(config), device=device).to(dtype)
    d = torch.sqrt((s1 - o[0]) ** 2 + (s2 - o[1]) ** 2)
    return torch.stack([t1, t2], dim=1), d


def inside(theta):
    """Rows inside the prior's support, as the program's float32 density
    decides it (a density of 0 is outside)."""
    t1, t2 = theta[:, 0], theta[:, 1]
    locs = torch.maximum(-1.0 - t1, -1.0 + t1)
    scales = 1.0 - locs
    return ((t1.abs() < 2.0) & (t2 >= locs) & (t2 <= locs + scales)
            & torch.isfinite(theta).all(dim=1))


def log_prior(theta):
    """The joint log-density (float64) of rows ``theta`` (n, 2)."""
    theta = theta.to(torch.float64)
    t1, t2 = theta[:, 0], theta[:, 1]
    p1 = torch.clamp(0.5 - t1.abs() / 4.0, min=0.0)
    locs = torch.maximum(-1.0 - t1, -1.0 + t1)
    scales = 1.0 - locs
    p2 = torch.where((t2 >= locs) & (t2 <= locs + scales) & (scales > 0),
                     1.0 / torch.where(scales > 0, scales, 1.0),
                     torch.zeros_like(t2))
    return torch.log(p1) + torch.log(p2)
