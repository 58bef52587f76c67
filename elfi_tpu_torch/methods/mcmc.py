"""MCMC chain diagnostics (counterpart of the diagnostics of
:mod:`elfi_tpu.methods.mcmc`): split-chain effective sample size with
Geyer's initial-monotone-sequence truncation and split-R-hat (Vehtari,
Gelman, Simpson, Carpenter and Buerkner 2021), in float32 on a device, as
the JAX package computes them on its default device, over a trailing
parameter axis at once.

NUTS and the Metropolis sampler are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.backends import resolve_device

__all__ = ["eff_sample_size", "gelman_rubin_statistic"]


def _split_halves(chains):
    """(m, n[, p]) chains -> (2m, n//2[, p]): first and last halves stacked
    (the middle draw is dropped when n is odd).  Splitting makes within-chain
    drift show up as between-chain variance in both diagnostics."""
    chains = np.atleast_2d(np.asarray(chains, np.float64))
    half = chains.shape[1] // 2
    return np.concatenate([chains[:, :half], chains[:, -half:]], axis=0)


def _tau_and_rhat(split, device):
    """Integrated autocorrelation time tau and split-R-hat of (m, n, p)
    split chains, one pair per trailing column, as float64 numpy arrays
    (p,).  The arithmetic is float32 on ``device``."""
    split = torch.as_tensor(split, dtype=torch.float32, device=device)
    m, n, _ = split.shape
    # circular-embedding FFT autocovariance, biased (1/n) normalisation
    centered = split - split.mean(dim=1, keepdim=True)
    spectrum = torch.fft.rfft(centered, 2 * n, dim=1)
    acov = torch.fft.irfft(spectrum.abs() ** 2, 2 * n, dim=1)[:, :n] / n
    within = acov[:, 0].mean(dim=0) * n / (n - 1.0)
    between = torch.var(split.mean(dim=1), dim=0, correction=1)   # = B/n
    total = within * (n - 1.0) / n + between       # marginal variance var+
    rhat = torch.sqrt(total / within)
    # combined autocorrelation at each lag, all chains pooled: (n, p)
    rho = 1.0 - (within - acov.mean(dim=0)) / total
    # Geyer 1992: Gamma_k = rho_2k + rho_2k+1 is positive and non-increasing
    # for a reversible chain; truncate at the first non-positive pair and
    # clamp to the running minimum
    pairs = rho[0:n - n % 2:2] + rho[1::2]
    alive = torch.cumprod((pairs > 0.0).to(torch.int32), dim=0).bool()
    capped = torch.cummin(pairs, dim=0).values
    tau = -1.0 + 2.0 * torch.sum(
        torch.where(alive, torch.clamp(capped, min=0.0), 0.0), dim=0)
    # (near-)constant chains: the variance is rounding, tau and R-hat mean
    # nothing -- define both as 1; also tau = 1 when no Geyer pair survives
    degenerate = total <= 1e-10 * ((split ** 2).mean(dim=(0, 1)) + 1e-30)
    tau = torch.where(degenerate | ~torch.isfinite(tau) | (tau <= 0.0),
                      1.0, tau)
    rhat = torch.where(degenerate | ~torch.isfinite(rhat), 1.0, rhat)
    return (tau.cpu().numpy().astype(np.float64),
            rhat.cpu().numpy().astype(np.float64))


def eff_sample_size(chains, device=None):
    """Effective sample size of MCMC draws.

    ``chains`` is (n_samples,), (n_chains, n_samples), or
    (n_chains, n_samples, n_params) -- the latter returns one ESS per
    parameter as an array.  ``device``: where the float32 arithmetic runs
    (None: the global backend's).
    """
    device = resolve_device(device)
    arr = np.asarray(chains, np.float64)
    if arr.ndim == 3:
        taus, _ = _tau_and_rhat(_split_halves(arr), device)
        size = arr.shape[0] * arr.shape[1]
        return np.minimum(size / np.maximum(taus, 1e-12),
                          size * np.log10(max(size, 10.0)))
    split = _split_halves(arr)
    tau, _ = _tau_and_rhat(split[:, :, None], device)
    size = split.shape[0] * split.shape[1]
    return float(min(size / max(float(tau[0]), 1e-12),
                     size * np.log10(max(size, 10.0))))


def gelman_rubin_statistic(chains, device=None):
    """Split-chain potential-scale-reduction factor R-hat (the same
    split-halves convention as :func:`eff_sample_size`)."""
    device = resolve_device(device)
    arr = np.asarray(chains, np.float64)
    if arr.ndim == 3:
        return _tau_and_rhat(_split_halves(arr), device)[1]
    return float(_tau_and_rhat(_split_halves(arr)[:, :, None], device)[1][0])
