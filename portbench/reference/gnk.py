"""Plain reference of the g-and-k configuration (Allingham, King and
Mengersen 2009; ELFI's ``elfi/examples/gnk.py``): uniform(0, 10) priors on
(A, B, g, k), the g-and-k quantile function at standard normal draws with
c = 0.8, the order statistics, and their euclidean distance to the sorted
observed sample, in the precision asked for, batch by batch.

The node names are the ones the benchmark declares the model with
(``portbench/models/gnk.py``): they key the streams.  Imports neither JAX
nor the JAX package nor the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import streams

PARAMS = ("A", "B", "g", "k")
SCALES = (10.0, 10.0, 10.0, 10.0)
C = 0.8


def quantile(z, A, B, g, k):
    """The g-and-k quantile function at ``z`` (batch, n); A .. k (batch,)."""
    A, B, g, k = (p[:, None] for p in (A, B, g, k))
    e = torch.exp(-g * z)
    return A + B * (1.0 + C * (1.0 - e) / (1.0 + e)) * (1.0 + z * z) ** k * z


def observed_sorted(config):
    return np.sort(np.asarray(config["observed"], np.float64).ravel())


def normals(config, graph, seed, batch_index, batch_size, device, dtype):
    """The (batch, n_obs) normals a batch's simulator draws: a distance
    kernel's Philox stream on the card (its plain version draws
    ``torch.randn`` off it), or the simulator node's ``torch.randn``."""
    n = config["n_obs"]
    if graph == "kernel" and torch.device(device).type == "cuda":
        return streams.philox_normals(
            streams.stream_seed(seed, batch_index, "d"), batch_size, n,
            device, dtype)
    name = "d" if graph == "kernel" else "GNK"
    return streams.node_normals(seed, batch_index, name, (batch_size, n),
                                device).to(dtype)


def simulate(config, graph, seed, batch_index, batch_size, device,
             dtype=torch.float32, theta=None):
    """(theta (batch, 4), distance (batch,)) of one batch."""
    if theta is None:
        theta = torch.stack(
            [10.0 * streams.node_uniform(seed, batch_index, p, batch_size,
                                         device) for p in PARAMS], dim=1)
    theta = theta.to(dtype)
    z = normals(config, graph, seed, batch_index, batch_size, device, dtype)
    y = quantile(z, *theta.unbind(dim=1))
    ys = torch.sort(y, dim=1).values
    o = torch.as_tensor(observed_sorted(config), device=device).to(dtype)
    d = torch.sqrt(torch.sum((ys - o) ** 2, dim=1))
    return theta, d


def inside(theta):
    return ((theta >= 0.0) & (theta <= 10.0)).all(dim=1)


def log_prior(theta):
    theta = theta.to(torch.float64)
    ok = inside(theta)
    return torch.where(ok, torch.full_like(theta[:, 0], -4 * np.log(10.0)),
                       torch.full_like(theta[:, 0], -np.inf))
