"""Small shared utilities (counterpart of :mod:`elfi_tpu.utils`)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["get_sub_seed", "random_seed", "is_array", "observed_name",
           "to_tensor", "to_numpy"]


def get_sub_seed(seed, sub_seed_index, high=2**31):
    """Return a deterministic sub-seed for ``(seed, index)``; the same
    ``np.random.SeedSequence`` spawn-key scheme as the JAX package, so the
    values are identical."""
    ss = np.random.SeedSequence(entropy=int(seed),
                                spawn_key=(int(sub_seed_index),))
    return int(ss.generate_state(1, np.uint64)[0] % high)


def random_seed():
    """Fresh seed from OS entropy."""
    return int(np.random.SeedSequence().generate_state(1, np.uint64)[0]
               % (2**31))


def is_array(x):
    return isinstance(x, (np.ndarray, torch.Tensor)) or hasattr(x, "__array__")


def observed_name(name):
    return f"_{name}_observed"


def to_tensor(x, device):
    """``x`` as a tensor on ``device``.  Float64 input becomes float32, as
    ``jnp.asarray`` does in the JAX package's default 32-bit mode, so the
    same numpy data gives the same dtypes in both packages."""
    t = torch.as_tensor(x, device=device)
    return t.to(torch.float32) if t.dtype == torch.float64 else t


def to_numpy(x):
    """A tensor as a numpy array, copied off the card explicitly (a CUDA
    tensor has no ``__array__``); anything else is passed on as it is."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
