"""The JAX package's observed data, committed beside the port's models:
the port does not import JAX, so it cannot redraw them."""

from __future__ import annotations

import numpy as np

__all__ = ["load_observed", "load_observed_setting", "setting_key"]


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


def setting_key(**setting):
    """The ``.npz`` key of a model's observed data: every size argument
    and the true parameters (as floats), sorted by name, with
    ``seed_obs`` None read as 0."""
    setting["seed_obs"] = setting.get("seed_obs") or 0
    if setting.get("true_params") is not None:
        setting["true_params"] = [float(v) for v in setting["true_params"]]
    return ";".join(f"{k}={setting[k]!r}" for k in sorted(setting))


def load_observed_setting(path, **setting):
    """The array stored for ``setting`` (:func:`setting_key`) in the
    ``.npz`` at ``path``; raises ``ValueError`` for any setting that was
    not stored, naming those that were."""
    key = setting_key(**setting)
    with np.load(path) as data:
        if key not in data.files:
            raise ValueError(
                f"no stored observed data for {key} in the PyTorch port; "
                f"stored: {sorted(data.files)}")
        return data[key]
