"""g-and-k model whose discrepancy node is the fused CUDA kernel
(:func:`elfi_tpu_torch.ops.kernels.gnk.gnk_distance`); counterpart of
:mod:`elfi_tpu.models.gnk_pallas`.

The whole simulate -> order statistics -> distance pipeline runs in one
kernel that writes only the distance, where the plain graph
(:mod:`.gnk`) writes and sorts the (batch, n_obs) sample in device memory.
Its noise comes from the kernel's own Philox stream: results are
deterministic per (seed, batch_index) but not bitwise-equal to the plain
graph's; posteriors agree statistically.  On CPU tensors the node runs the
kernel's plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model, Operation, Prior
from ..ops.kernels.gnk import gnk_distance
from .gnk import observed_data

__all__ = ["get_model"]


class _KernelGnkDistance:
    """Stochastic op: (A, B, g, k) -> distances via the kernel, keyed by
    the node's stream (:func:`~elfi_tpu_torch.utils.rng.stream_key` of its
    generator: in a CUDA graph, read from device memory).  The observed
    sample is sorted once and copied to each device once."""

    #: its programs may be captured as CUDA graphs
    #: (``CompiledProgram.jitted``): it draws only through its generator's
    #: key and reads nothing back
    capturable = True

    def __init__(self, observed, n_obs):
        self.obs = np.sort(np.asarray(observed, np.float32).ravel())
        self.n_obs = n_obs
        self._obs_on = {}

    def __getstate__(self):
        # the per-device copies are rebuilt on first use after loading
        return {**self.__dict__, "_obs_on": {}}

    def __call__(self, A, B, g, k, batch_size, generator):
        device = A.device
        if device not in self._obs_on:
            self._obs_on[device] = torch.as_tensor(self.obs, device=device)
        A, B, g, k = (p.to(torch.float32).contiguous() for p in (A, B, g, k))
        return gnk_distance(A, B, g, k, self._obs_on[device],
                            n_obs=self.n_obs, batch_size=batch_size,
                            generator=generator)


def get_model(n_obs=50, true_params=None, seed_obs=None):
    """g-and-k inference model whose discrepancy node IS the fused kernel
    (same priors and observed data as :func:`.gnk.get_model`)."""
    y_obs = observed_data(n_obs, true_params, seed_obs)
    m = Model(name="gnk_kernel")
    priors = [Prior("uniform", 0, 10, model=m, name=n)
              for n in ["A", "B", "g", "k"]]
    Operation(_KernelGnkDistance(y_obs, n_obs), *priors, stochastic=True,
              uses_batch_size=True, model=m, name="d")
    return m
