"""Carry the JAX package's state into the port.

The system has no learned weights: its state is a model's observed arrays
and the rejection sampler's top-N sample buffer.  Both are dicts of arrays;
:func:`from_numpy_state` turns such a dict, taken to numpy on the JAX side
(``jax.device_get(rej.state["samples"])``, including ``__key``, or
``model.observed``), into tensors on ``device``, so both packages can
compute from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_numpy_state"]


def from_numpy_state(d, device):
    """``{name: array}`` -> ``{name: tensor on device}``, dtypes kept.  The
    tensors are copies: ``jax.device_get`` hands out read-only arrays."""
    return {k: torch.tensor(np.asarray(v), device=device)
            for k, v in d.items()}
