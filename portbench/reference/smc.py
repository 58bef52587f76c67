"""Plain reference of an SMC-ABC round (Beaumont et al. 2009, as ELFI's
``SMC`` runs it): the Gaussian-mixture proposal over the previous
population with twice its weighted variance, redrawn until every row lies
in the prior's support, and the importance weights prior / proposal.

A round's proposals are drawn from the program's stream for the round and
batch (:func:`.streams.proposal_seed`) as the mixture prescribes: pick a
component by its weight (``torch.multinomial``), add a standard normal
(``torch.randn``) scaled by the standard deviations, and draw again, from
the same generator, every row outside the support.  Imports neither JAX
nor the JAX package nor the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import streams

MAX_REDRAWS = 1000


def weighted_var(x, w):
    """Unbiased weighted variance per column (float64)."""
    x = np.asarray(x, np.float64)
    w = np.asarray(w, np.float64)
    w = w / w.sum()
    mean = np.sum(w[:, None] * x, axis=0)
    return np.sum(w[:, None] * (x - mean) ** 2, axis=0) / (1 - np.sum(w**2))


class Mixture:
    """The proposal of a round from the previous population (``theta``
    (m, P), weights ``w``): components at the rows, each with the
    diagonal covariance twice the population's weighted variance."""

    def __init__(self, theta, w, device):
        var = 2.0 * weighted_var(theta, w)
        if not np.all(np.isfinite(var)):
            var = np.ones(np.shape(theta)[1])
        self.var = var
        self.theta = np.asarray(theta, np.float64)
        self.w = np.asarray(w, np.float64)
        self.means = torch.as_tensor(theta, dtype=torch.float32,
                                     device=device)
        self.sd = torch.sqrt(torch.as_tensor(var, dtype=torch.float32,
                                             device=device))
        pw = torch.as_tensor(w, dtype=torch.float32, device=device)
        self.pick = pw / torch.sum(pw)
        self.device = device

    def propose(self, seed, size, inside):
        """``size`` rows from the stream ``seed``, every one inside."""
        g = streams.generator(seed, self.device)

        def draw():
            comp = torch.multinomial(self.pick, size, replacement=True,
                                     generator=g)
            z = torch.randn((size, self.means.shape[1]), generator=g,
                            device=self.device)
            return self.means[comp] + z * self.sd

        out = draw()
        for _ in range(MAX_REDRAWS):
            ok = inside(out)
            if bool(ok.all()):
                return out
            out = torch.where(ok[:, None], out, draw())
        raise RuntimeError("no proposal inside the prior's support")

    def log_density(self, x, dtype=torch.float64):
        """The mixture's log-density at rows ``x``, computed in ``dtype``."""
        x = torch.as_tensor(x).to(dtype)
        mu = torch.as_tensor(self.theta).to(dtype)
        var = torch.as_tensor(self.var).to(dtype)
        w = torch.as_tensor(self.w / self.w.sum()).to(dtype)
        out = []
        for block in torch.split(x, 1024):
            q = (((block[:, None, :] - mu[None]) ** 2) / var).sum(-1)
            lg = (-0.5 * q - 0.5 * torch.log(2 * math.pi * var).sum()
                  + torch.log(w)[None])
            out.append(torch.logsumexp(lg, dim=1))
        return torch.cat(out)


def weights(theta, mixture, log_prior, dtype=torch.float64):
    """Normalised importance weights of rows ``theta``, computed in
    ``dtype`` (float64 for the reference); round 0 (no mixture) weighs
    every row alike."""
    theta = torch.as_tensor(np.asarray(theta, np.float64))
    if mixture is None:
        return np.full(theta.shape[0], 1.0 / theta.shape[0])
    lw = log_prior(theta).to(dtype) - mixture.log_density(theta, dtype)
    w = torch.exp(lw - lw.max())
    return (w / w.sum()).to(torch.float64).numpy()
