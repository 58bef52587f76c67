"""The JAX package's observed data, committed beside the port's models:
the port does not import JAX, so it cannot redraw them."""

from __future__ import annotations

import numpy as np

__all__ = ["load_observed"]


def load_observed(path, n_obs, stored_n_obs, true_params, stored_params,
                  seed_obs, prefix=""):
    """The array stored under ``<prefix>seed_<seed_obs>`` (None means 0) in
    the ``.npz`` at ``path``; raises ``ValueError`` for any setting that was
    not stored."""
    if n_obs != stored_n_obs or (true_params is not None and
                                 list(true_params) != list(stored_params)):
        raise ValueError(f"only n_obs={stored_n_obs} at true_params "
                         f"{tuple(stored_params)} is stored for the PyTorch "
                         "port")
    with np.load(path) as data:
        key = f"{prefix}seed_{seed_obs or 0}"
        if key not in data:
            stored = sorted(int(k.rsplit("_", 1)[1]) for k in data.files
                            if k.startswith(f"{prefix}seed_"))
            raise ValueError(f"no stored observed data for seed_obs="
                             f"{seed_obs}; stored: {stored}")
        return data[key]
