"""MA2 model whose discrepancy node is the fused CUDA kernel
(:func:`elfi_tpu_torch.ops.kernels.ma2.ma2_distance`); counterpart of
:mod:`elfi_tpu.models.ma2_pallas`.

The whole simulate -> summarise -> distance pipeline runs in one kernel
that writes only the distance.  Its noise comes from the kernel's own
Philox stream: results are deterministic per (seed, batch_index) but not
bitwise-equal to the plain graph's; posteriors agree statistically.  On
CPU tensors the node runs the kernel's plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..model.model import Model, Operation, Prior
from ..ops.kernels.ma2 import ma2_distance
from .ma2 import CustomPrior1, CustomPrior2, autocov, observed_data

__all__ = ["get_model"]


class _KernelMA2Distance:
    """Stochastic op: (t1, t2) -> distances via the kernel, keyed by the
    node's stream (:func:`~elfi_tpu_torch.utils.rng.stream_key` of its
    generator: in a CUDA graph, read from device memory).  The observed
    autocovariances are copied to each device once."""

    #: its programs may be captured as CUDA graphs
    #: (``CompiledProgram.jitted``): it draws only through its generator's
    #: key and reads nothing back
    capturable = True

    def __init__(self, observed_autocovs, n_obs):
        self.obs = np.asarray(observed_autocovs, np.float32)
        self.n_obs = n_obs
        self._obs_on = {}

    def __getstate__(self):
        # the per-device copies are rebuilt on first use after loading
        return {**self.__dict__, "_obs_on": {}}

    def __call__(self, t1, t2, batch_size, generator):
        device = t1.device
        if device not in self._obs_on:
            self._obs_on[device] = torch.as_tensor(self.obs, device=device)
        return ma2_distance(t1.to(torch.float32).contiguous(),
                            t2.to(torch.float32).contiguous(),
                            self._obs_on[device], n_obs=self.n_obs,
                            batch_size=batch_size, generator=generator)


def get_model(n_obs=100, true_params=None, seed_obs=None):
    """MA2 inference model whose discrepancy node IS the fused kernel."""
    y = torch.as_tensor(observed_data(n_obs, true_params, seed_obs))[None]
    obs = np.array([float(autocov(y)[0]), float(autocov(y, lag=2)[0])])
    m = Model(name="MA2_kernel")
    Prior(CustomPrior1, 2, model=m, name="t1")
    Prior(CustomPrior2, m["t1"], 1, model=m, name="t2")
    Operation(_KernelMA2Distance(obs, n_obs), m["t1"], m["t2"],
              stochastic=True, uses_batch_size=True, model=m, name="d")
    return m
